"""PyTorch port, the MobileNetV3 segmentation models in INT8 and QAT against JAX.

* INT8 at crop 96 (the four MobileNetV3 models; 19 classes, Cityscapes
  geometry), calibrated in JAX as the full-width fixture is
  (``tests/test_torch_seg_fixture.py``): every layer's codes of the port's
  frozen model equal JAX ``freeze()``'s bit for bit (from the first
  squeeze-excite on within PR 8's flip band, ``SE_FLIP_FRACTION``: 0 flips
  measured here); the LR-ASPP head's resize (6 -> 12) bit for bit; the
  logits within ``SEG_LOGIT_BAND``, the argmax within ``SEG_ARGMAX_SHARE``;
  the port's ``export_int8`` equals JAX's array for array.
* QAT in train mode (``mobilenetv3_small``): logits within the whole-model
  QAT bands of ``tests/test_torch_seg.py``, observers within phase 8's bands,
  BN running means within 5% of a std in the median.

Each JAX reference is computed once, in a module fixture.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import few_threads  # noqa: F401 - a fixture
from frostnet_tpu import nn as jnn
from frostnet_tpu import quant as jq
from frostnet_tpu_torch import nn as tnn
from frostnet_tpu_torch.quant import export_int8, freeze, model_variables
from frostnet_tpu_torch.quant.export import flatten_variables
from test_torch_seg import V3, _observer_band, _port_model, _qat_band
from test_torch_seg_fixture import (SEG_ARGMAX_SHARE, SEG_LOGIT_BAND, calibrate_jax,
                                    jax_seg_codes)

pytestmark = pytest.mark.usefixtures("few_threads")
CROP, BATCH = 96, 2
# the squeeze-excite's float reductions (tests/test_torch_blocks.py)
SE_FLIP_FRACTION = 0.002



@pytest.fixture(scope="module")
def calibrated():
    """name -> (JAX model, variables, images, JAX logits, JAX codes): each
    reference computed once for the file."""
    out = {}
    images = np.random.RandomState(0).randn(BATCH, CROP, CROP, 3).astype(np.float32)
    for name in V3:
        model, variables = calibrate_jax(name, CROP, BATCH, 2)
        logits, codes = jax_seg_codes(model, variables, jnp.asarray(images), head_c4=True)
        head = codes.pop("head/c4")
        out[name] = (model, variables, images, logits, codes, head)
    return out


@pytest.mark.parametrize("name", V3)
def test_int8_layers_bit_equal_to_jax_freeze(name, calibrated):
    from chip_smoke import seg_layer_codes

    _, variables, images, jlogits, jcodes, jhead = calibrated[name]
    port = _port_model(variables, name)
    fn = freeze(port, "cpu")
    heads = []
    hook = port.head.register_forward_hook(lambda m, a, out: heads.append(out[1]))
    logits, codes = seg_layer_codes(port, fn, images)
    hook.remove()
    assert sorted(codes) == sorted(jcodes)
    for k, want in jcodes.items():
        got = codes[k].numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, k
        flips = int((got != want).sum())
        if k.startswith(("backbone/layer", "head")):  # at or after a squeeze-excite
            assert flips <= SE_FLIP_FRACTION * got.size, (k, flips)
        else:
            assert flips == 0, (k, flips)
    np.testing.assert_array_equal(heads[0].numpy(), jhead)  # the 6 -> 12 resize
    span = float(jlogits.max() - jlogits.min())
    assert np.abs(logits.numpy() - jlogits).max() <= SEG_LOGIT_BAND * span
    assert (logits.numpy().argmax(-1) != jlogits.argmax(-1)).mean() <= SEG_ARGMAX_SHARE
    assert port.head.lr_aspp.b1_conv._route == "matmul"
    assert {m.dilation for m in port.backbone.stages[3][0].modules()
            if isinstance(m, tnn.QConvBNAct) and m.depthwise} == {2}


@pytest.mark.parametrize("name", V3[::3])
def test_export_int8_equals_jax(name, calibrated, tmp_path):
    _, variables, *_ = calibrated[name]
    mine, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    export_int8(_port_model(variables, name), mine)
    jq.export_int8(variables, theirs)
    with np.load(mine) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["params/project/kernel"].dtype == np.float32  # the float tail stays float
        assert a["params/head/lr_aspp/b1_conv/kernel"].dtype == np.int8


def test_qat_train_step_forward_within_bands(calibrated):
    """``mobilenetv3_small`` (HS) in QAT train mode on the calibrated
    variables: logits within the whole-model QAT bands, observers within
    phase 8's, BN running means within 5% of a std in the median."""
    name = "mobilenetv3_small"
    model, variables, images, *_ = calibrated[name]
    jy, upd = jax.jit(lambda v, xx: model.apply(v, xx, mode=jnn.QAT, train=True,
                                                mutable=["batch_stats", "quant"]))(
        variables, jnp.asarray(images))
    port = _port_model(variables, name)
    with torch.no_grad():
        ty = port(torch.as_tensor(images), mode=tnn.QAT, train=True).numpy()
    _qat_band(ty, np.asarray(jy))
    jflat = flatten_variables({c: jax.tree.map(np.asarray, upd[c])
                               for c in ("batch_stats", "quant")})
    mine = {k: v.detach().numpy() for k, v in model_variables(port).items()}
    _observer_band(mine, {k: v for k, v in jflat.items() if k.startswith("quant/")})
    means = [float(np.max(np.abs(mine[k] - v) / np.sqrt(jflat[k[:-4] + "var"])))
             for k, v in jflat.items() if k.endswith("/mean")]
    assert np.median(means) <= 0.05, np.median(means)
