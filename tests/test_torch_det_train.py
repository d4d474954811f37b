"""The detection trainer, evaluator and server of the PyTorch port, on the CPU.

* The train step against the committed JAX reference
  (``testdata/det_qssd_train_reference.npz``: one FP32 step, ``start_qat``,
  two QAT steps, a QAT_FROZEN eval, at 300x300, batch 2, float32) in phase
  8's bands (``chip_smoke.train_det_against_reference``, run here on the CPU).
* ``detection.train.main``: a run stopped at ``ssd300_2`` and resumed to a
  third iteration is bit-identical (every parameter, BN statistic, observer
  and optimizer state) to one run to 3; ``--quant false`` leaves the
  observers empty; ``--loader native`` raises naming its ROADMAP item;
  ``--basenet`` loads a torchvision-format MobileNetV2 state dict as the
  JAX function does; uint8 batches get the BaseTransform bit-equal to JAX's.
* the CLI, and ``qeval`` on its checkpoint (mAP in both modes). The
  export and the server are ``tests/test_torch_det_serve.py``'s.
"""
import json
import os

import numpy as np
import pytest
import torch

from _torch_port import few_threads, jax_variables  # noqa: F401 - a fixture
from frostnet_tpu_torch.detection import qeval, train
from frostnet_tpu_torch.detection.models import SSD_MBV2_SETTINGS
from frostnet_tpu_torch.quant import model_variables, numpy_init

pytestmark = pytest.mark.usefixtures("few_threads")


def test_train_steps_against_jax_reference():
    from chip_smoke import train_det_against_reference

    rep = train_det_against_reference(torch.device("cpu"))
    assert rep["sites"] == rep["observer_rel_range"]["count"] > 100
    assert all(np.isfinite(rep["losses"]))


def _cfg(tmp_path, **kw):
    base = dict(batch_size=2, warmup_iters=1, max_iter=3, device="cpu",
                save_dir=str(tmp_path / "run"))
    base.update(kw)
    return train.DetConfig(**base)


def _state_arrays(state):
    out = {k: v.detach().cpu().numpy().copy() for k, v in model_variables(state.model).items()}
    for i, (k, v) in enumerate(state.optimizer.state.items()):
        for n, t in v.items():
            if isinstance(t, torch.Tensor):
                out[f"opt/{i}/{n}"] = t.detach().cpu().numpy().copy()
    return out


def test_resume_bit_identical(tmp_path):
    whole, res = train.main(_cfg(tmp_path / "a"))
    assert [h["tag"] for h in res["history"]] == ["fp_warmup", "qat", "qat"]
    assert os.path.isdir(tmp_path / "a" / "run" / "ssd300_3")
    _, first = train.main(_cfg(tmp_path / "b", max_iter=2))
    resumed, second = train.main(_cfg(tmp_path / "b", resume_iter=2))
    assert second["resumed"] == 2 and [h["iter"] for h in second["history"]] == [3]
    assert [h["loss"] for h in first["history"] + second["history"]] == \
        [h["loss"] for h in res["history"]]
    a, b = _state_arrays(whole), _state_arrays(resumed)
    assert sorted(a) == sorted(b) and resumed.step == whole.step == 3
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with open(tmp_path / "a" / "run" / "arguments.json") as f:
        assert json.load(f)["device"] == "cpu"


def test_quant_false_and_native_loader(tmp_path):
    state, res = train.main(_cfg(tmp_path, max_iter=2, quant=False))
    assert [h["tag"] for h in res["history"]] == ["fp_warmup", "fp32"]
    obs = [v for k, v in model_variables(state.model).items() if k.endswith(".min_val")]
    assert obs and all(torch.isinf(v).all() for v in obs)
    with pytest.raises(NotImplementedError, match="Queue A item 6.1"):
        train.main(_cfg(tmp_path, loader="native"))
    with pytest.raises(ValueError, match="basenet"):
        train.main(_cfg(tmp_path, net_type="qtdsod", basenet="x.pth"))


def test_prep_det_image_bit_equal():
    import jax.numpy as jnp

    from frostnet_tpu.detection.train import _prep_det_image

    img = np.random.RandomState(0).randint(0, 256, (2, 7, 9, 3)).astype(np.uint8)
    np.testing.assert_array_equal(train.prep_det_image(torch.as_tensor(img)).numpy(),
                                  np.asarray(_prep_det_image(jnp.asarray(img))))
    f = torch.zeros(1, 2, 2, 3)
    assert train.prep_det_image(f) is f


def _torchvision_state(rng):
    """A torchvision-layout MobileNetV2 state dict for the SSD trunk."""
    state = {}

    def convbn(conv, bn, cin, cout, k, groups=1):
        state[conv + ".weight"] = torch.as_tensor(
            rng.randn(cout, cin // groups, k, k).astype(np.float32))
        for n, f in (("weight", 1.0), ("bias", 0.0), ("running_mean", 0.0), ("running_var", 1.0)):
            state[f"{bn}.{n}"] = torch.as_tensor((f + 0.1 * rng.randn(cout)).astype(np.float32))
        state[f"{bn}.num_batches_tracked"] = torch.tensor(7)

    convbn("features.0.0", "features.0.1", 3, 32, 3)
    c, b = 32, 0
    for t, ch, n, _, _ in SSD_MBV2_SETTINGS:
        for _ in range(n):
            f, hid = f"features.{b + 1}", c * t
            if t == 1:
                convbn(f + ".conv.0.0", f + ".conv.0.1", hid, hid, 3, hid)
                convbn(f + ".conv.1", f + ".conv.2", hid, ch, 1)
            else:
                convbn(f + ".conv.0.0", f + ".conv.0.1", c, hid, 1)
                convbn(f + ".conv.1.0", f + ".conv.1.1", hid, hid, 3, hid)
                convbn(f + ".conv.2", f + ".conv.3", hid, ch, 1)
            c, b = ch, b + 1
    convbn("features.18.0", "features.18.1", 320, 1280, 1)
    state["classifier.1.weight"] = torch.zeros(1000, 1280)
    return {"module." + k: v for k, v in state.items()}


def test_basenet_import_matches_jax(tmp_path):
    from frostnet_tpu.detection.models import load_torch_mobilenet_v2_checkpoint as jload
    from frostnet_tpu_torch.detection.models import load_torch_mobilenet_v2_checkpoint
    from frostnet_tpu_torch.quant.export import flatten_variables

    sd = _torchvision_state(np.random.RandomState(1))
    feat, _ = train.build_net("qssd", 21)
    tree = numpy_init(feat, 0)
    got = flatten_variables(load_torch_mobilenet_v2_checkpoint({"state_dict": sd}, tree))
    want = flatten_variables(jload(sd, jax_variables(tree)))
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    assert not np.array_equal(got["params/block5/dw/kernel"],
                              flatten_variables(tree)["params/block5/dw/kernel"])
    path = str(tmp_path / "mbv2.pth")
    torch.save(sd, path)
    state, _ = train.main(_cfg(tmp_path, max_iter=1, basenet=path))
    # one SGD step at lr 1e-3 from the imported kernel, far from numpy_init's
    stem = sd["module.features.0.0.weight"].numpy().transpose(2, 3, 1, 0)
    assert np.abs(state.model.feat.stem.kernel.detach().numpy() - stem).max() < 0.01
    assert np.abs(flatten_variables(tree)["params/stem/kernel"] - stem).max() > 0.5
    with pytest.raises(ValueError, match="no weights matched"):
        load_torch_mobilenet_v2_checkpoint({"fc.weight": torch.zeros(2)}, tree)


def test_cli_and_evaluator_on_a_checkpoint(tmp_path, capsys):
    train.cli(["--device", "cpu", "--batch_size", "2", "--warmup_iters", "1", "--max_iter", "2",
               "--net_type", "qtdsod", "--save_dir", str(tmp_path / "cli")])
    assert "final loss=" in capsys.readouterr().out
    out = qeval.main(qeval.build_parser().parse_args(
        ["--net_type", "qtdsod", "--checkpoint", str(tmp_path / "cli" / "ssd300_2"),
         "--batch_size", "2", "--max_batches", "1", "--device", "cpu"]))
    for mode in ("qat", "int8"):
        assert 0.0 <= out[mode]["mAP"] <= 1.0 and out[mode]["ap_per_class"].shape == (21,)
