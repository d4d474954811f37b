"""PyTorch port, the segmentation models against the JAX package.

* Registry and trees: every name of ``SEG_MODELS`` builds in the port with
  JAX's variables (names and shapes, from ``jax.eval_shape`` of ``init``;
  the dilated MobileNetV3 has no ``cls_*`` modules, MobileNetV2 keeps its
  unused ``conv_head``); the dilated trunks' features have JAX's shapes;
  ``espnet`` and ``espnetv2`` build (``tests/test_torch_espnet.py``).
* A JAX ``init`` (``PRNGKey``) loaded into the port gives the JAX FP32
  logits within ``SEG_LOGIT_BAND`` of their range.
* INT8 and QAT of the four MobileNetV3 models: ``tests/test_torch_seg_int8.py``.
* ``mobilenetv2``: FP32 (train mode) logits within ``REL_FLOAT`` and its BN
  statistics as JAX's; QAT (train and eval) and QAT_FROZEN within the
  whole-model QAT bands below; its INT8 raises in both packages (JAX's
  ``features_only`` returns dequantized features: ROADMAP.md, Queue C).

Whole-model QAT bands. Every layer agrees to float rounding (the layer
tests), but one fake-quantized value on a rounding boundary moves a code,
and at random init the next layers carry it: the port against JAX at
these sizes measured a relative L2 distance of the logits of 0.09 to 0.15
and the argmax equal at 86% to 92% of the pixels. JAX against itself, with
one BN shift of the stem moved by one float32 ulp, gives the same where a
code flips (0.11 to 0.12, 90% to 91%), and 0 where none does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import few_threads  # noqa: F401 - a fixture
from frostnet_tpu import nn as jnn
from frostnet_tpu.segmentation import SEG_MODELS as JAX_SEG_MODELS
from frostnet_tpu.segmentation import get_seg_model as jax_seg_model
from frostnet_tpu_torch import nn as tnn
from frostnet_tpu_torch.quant import freeze, from_jax_variables, model_variables
from frostnet_tpu_torch.quant.export import flatten_variables, unflatten_variables
from frostnet_tpu_torch.segmentation import SEG_MODELS, get_seg_model
from test_torch_seg_fixture import SEG_LOGIT_BAND, calibrate_jax

pytestmark = pytest.mark.usefixtures("few_threads")
V3 = ("mobilenetv3_RE_small", "mobilenetv3_small", "mobilenetv3_RE_large", "mobilenetv3_large")
BATCH = 2
REL_FLOAT, FLIP_FRACTION = 2e-5, 0.01
QAT_REL_L2, QAT_ARGMAX_SHARE = 0.25, 0.75
OBS_MEDIAN, OBS_WORST = 0.03, 0.5  # chip_smoke.py's phase-8 bands, of the observed range


def _jax_shapes(name, crop=64):
    model = jax_seg_model(name)
    shapes = jax.eval_shape(lambda x: model.init(jax.random.PRNGKey(0), x, mode=jnn.QAT,
                                                 train=True), jnp.zeros((1, crop, crop, 3)))
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        names = [getattr(p, "key", getattr(p, "name", None)) for p in path]
        key = (f"quant/{'/'.join(names[1:-1])}.{names[-1]}" if names[0] == "quant"
               else "/".join(names))
        out[key] = tuple(leaf.shape)
    return out


@pytest.mark.parametrize("name", V3 + ("mobilenetv2",))
def test_variables_match_jax(name):
    mine = {k: tuple(v.shape) for k, v in model_variables(get_seg_model(name)).items()}
    assert mine == _jax_shapes(name)
    if name.startswith("mobilenetv3"):
        assert not any("cls_" in k for k in mine)
    else:
        assert "params/backbone/conv_head/kernel" in mine


def test_registry_and_refusals():
    assert sorted(SEG_MODELS) == sorted(JAX_SEG_MODELS)
    for name in ("espnet", "espnetv2"):  # ported: 20 classes by default, dataset dropped
        assert get_seg_model(name).num_classes == 20
        assert get_seg_model(name, dataset="pascal", num_classes=21).num_classes == 21
    assert get_seg_model("espnetv2", s=2.0).net.config[:5] == [32, 128, 256, 512, 1024]
    with pytest.raises(ValueError, match="unknown seg model"):
        get_seg_model("deeplabv3")
    assert get_seg_model("mobilenetv3_RE_small").num_classes == 19
    assert get_seg_model("mobilenetv2").head.lr_aspp.pool_window == 37
    assert get_seg_model("mobilenetv3_large", dataset="pascal").head.lr_aspp.pool_stride == 8


@pytest.mark.parametrize("name", ["mobilenetv3_small", "mobilenetv3_large", "mobilenetv2"])
def test_dilated_trunk_feature_shapes(name):
    """The trunk's features (MobileNetV3: the five stage outputs; V2: the
    dequantized c1..c4) have the JAX trunk's shapes, at output stride 16."""
    from frostnet_tpu.models.mobilenetv2 import MobileNetV2 as JV2
    from frostnet_tpu.models.mobilenetv3 import MobileNetV3 as JV3
    from frostnet_tpu_torch.models import MobileNetV2, MobileNetV3

    x = jnp.zeros((1, 64, 64, 3))
    if name == "mobilenetv2":
        jm = JV2(dilated=True, input_stub=False)
        port = MobileNetV2(dilated=True, input_stub=False)
        kw = {"features_only": True}
    else:
        mode = name.split("_")[-1]
        jm, port, kw = JV3(mode=mode, dilated=True, input_stub=False), \
            MobileNetV3(mode=mode, dilated=True, input_stub=False), {}
    want = jax.eval_shape(lambda xx: jm.init_with_output(jax.random.PRNGKey(0), xx, **kw)[0], x)
    with torch.no_grad():
        got = port(torch.zeros(1, 64, 64, 3), **kw)
    assert [tuple(f.shape) for f in got] == [tuple(w.shape) for w in want]
    assert tuple(got[-1].shape[1:3]) == (4, 4)


@pytest.mark.parametrize("name,quantized", [("mobilenetv3_RE_large", True),
                                            ("mobilenetv3_small", False)])
def test_jax_init_loads_and_matches_fp32(name, quantized):
    """A JAX ``init`` (PRNGKey(3), FP32 eval) in the port: the same logits
    within the band (the float convs sum in other orders); also for a float
    model (``quantized=False``: no observers, the float hard-sigmoid gate)."""
    jm = jax_seg_model(name, quantized=quantized)
    x = np.random.RandomState(5).randn(BATCH, 64, 64, 3).astype(np.float32)
    v = jax.jit(lambda xx: jm.init(jax.random.PRNGKey(3), xx, mode=jnn.QAT, train=True))(
        jnp.asarray(x))
    jy = np.asarray(jax.jit(lambda vv, xx: jm.apply(vv, xx, mode=jnn.FP32))(v, jnp.asarray(x)))
    tree = unflatten_variables(flatten_variables(jax.tree.map(np.asarray, v)))
    port = from_jax_variables(get_seg_model(name, quantized=quantized), tree)
    assert ("quant/quant/act.min_val" in model_variables(port)) == quantized
    with torch.no_grad():
        ty = port(torch.as_tensor(x), mode=tnn.FP32).numpy()
    span = float(jy.max() - jy.min())
    assert np.abs(ty - jy).max() <= SEG_LOGIT_BAND * span, (np.abs(ty - jy).max(), span)


# ---------------------------------------------------------------------------
# The float phases
# ---------------------------------------------------------------------------

PHASES = {"FP32-train": (jnn.FP32, tnn.FP32, True), "QAT-train": (jnn.QAT, tnn.QAT, True),
          "QAT-eval": (jnn.QAT, tnn.QAT, False),
          "QAT_FROZEN": (jnn.QAT_FROZEN, tnn.QAT_FROZEN, False)}


def _port_model(variables, name):
    tree = unflatten_variables(flatten_variables(jax.tree.map(np.asarray, variables)))
    return from_jax_variables(get_seg_model(name), tree)


@pytest.fixture(scope="module")
def v2_calibrated():
    return calibrate_jax("mobilenetv2", 64, BATCH, 1)


def _qat_band(ty, jy):
    rel = float(np.linalg.norm(ty - jy) / np.linalg.norm(jy))
    same = float((ty.argmax(-1) == jy.argmax(-1)).mean())
    assert rel <= QAT_REL_L2 and same >= QAT_ARGMAX_SHARE, (rel, same)


def _observer_band(mine, jflat):
    """Observers within phase 8's bands of their observed range."""
    obs = []
    for k, v in jflat.items():
        if k.endswith(".min_val"):
            hi = k.replace(".min_val", ".max_val")
            span = max(float(jflat[hi] - v), 1e-6)
            obs.append(max(abs(float(mine[k] - v)), abs(float(mine[hi] - jflat[hi]))) / span)
    assert obs and np.median(obs) <= OBS_MEDIAN and max(obs) <= OBS_WORST, (np.median(obs),
                                                                          max(obs))


@pytest.mark.parametrize("phase", sorted(PHASES))
def test_mobilenetv2_float_phases_within_bands(phase, v2_calibrated):
    """FP32: logits within ``REL_FLOAT`` of the range on all but
    ``FLIP_FRACTION`` of the elements, the BN statistics within 1e-4 of
    their magnitude; the QAT phases within the whole-model QAT bands, the
    observers (QAT train) within phase 8's."""
    model, variables = v2_calibrated
    jmode, tmode, train = PHASES[phase]
    x = np.random.RandomState(9).randn(BATCH, 64, 64, 3).astype(np.float32)
    jy, upd = jax.jit(lambda v, xx: model.apply(v, xx, mode=jmode, train=train,
                                                mutable=["batch_stats", "quant"]))(
        variables, jnp.asarray(x))
    jy = np.asarray(jy)
    port = _port_model(variables, "mobilenetv2")
    with torch.no_grad():
        ty = port(torch.as_tensor(x), mode=tmode, train=train).numpy()
    mine = {k: v.detach().numpy() for k, v in model_variables(port).items()}
    jflat = flatten_variables({c: jax.tree.map(np.asarray, upd[c])
                               for c in ("batch_stats", "quant")})
    if phase.startswith("FP32"):
        span = float(jy.max() - jy.min())
        assert (np.abs(ty - jy) > REL_FLOAT * span).mean() <= FLIP_FRACTION
        for k, v in jflat.items():
            if k.startswith("batch_stats/"):
                assert np.max(np.abs(mine[k] - v)) <= 1e-4 * (float(np.max(np.abs(v))) + 1e-6), k
        return
    _qat_band(ty, jy)
    if train:
        _observer_band(mine, {k: v for k, v in jflat.items() if k.startswith("quant/")})


def test_mobilenetv2_int8_raises_in_both(v2_calibrated):
    model, variables = v2_calibrated
    with pytest.raises(AssertionError, match="QTensor"):
        jax.eval_shape(lambda x: model.apply(variables, x, mode=jnn.INT8),
                       jnp.zeros((1, 64, 64, 3)))
    port = _port_model(variables, "mobilenetv2")
    with pytest.raises(NotImplementedError, match="dequantized features"):
        freeze(port, "cpu")
    with pytest.raises(NotImplementedError, match="dequantized features"):
        port(torch.zeros(1, 64, 64, 3), mode=tnn.INT8)
