"""PyTorch port, the MobileNets and the float FrostNets as whole models, against JAX.

* Registry: every JAX name of the MobileNetV2/V3 and ResNet families and
  the 30 FrostNets builds in the port with JAX's variables (names and shapes, from
  ``jax.eval_shape`` of ``init``: no compile); every other JAX name builds
  with the JAX parameter count.
* Export and INT8 at small sizes (``qmobilenet_v2_ReLU6``, width 0.35, and
  ``qmobilenet_v3_small_ReLU``, width 0.5; 32x32, fbgemm), calibrated in
  the port as the full-width fixture is (BN shifts, BN statistics read back,
  observers in eval mode): the port's ``export_int8`` equals JAX's array
  for array, and JAX's ``load_int8`` + ``freeze`` of it gives the port's
  codes at every top-level layer and its logits, bit for bit. (The
  full-width qnnpack models are ``tests/test_torch_mobilenet_fixture.py``'s;
  training is ``tests/test_torch_mobilenet_train.py``'s.)
* The user's path on the CPU: ``classification.main`` on
  ``qmobilenet_v3_small_HS``, ``evaluate.main --export_int8``, and
  ``serve.main`` on the artifact, whose logits equal the in-process freeze.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import few_threads, jax_variables  # noqa: F401 - a fixture
from frostnet_tpu import quant as jq
from frostnet_tpu.models import create_model as jax_create_model
from frostnet_tpu.models import list_models as jax_list_models
from frostnet_tpu_torch.models import create_model, list_models
from frostnet_tpu_torch.nn import FP32, INT8, QAT, QAT_FROZEN, QConvBNAct
from frostnet_tpu_torch.quant import (export_int8, freeze, from_jax_variables, get_qconfig,
                                      load_int8, model_variables, numpy_init)
from frostnet_tpu_torch.quant.export import flatten_variables, unflatten_variables

pytestmark = pytest.mark.usefixtures("few_threads")
FAMILIES = ("frostnet_", "mobilenet_v2", "mobilenet_v3", "qmobilenet_v2", "qmobilenet_v3",
            "resnet", "qresnet", "resnext", "qresnext")
N_PORTED = 56  # 30 FrostNets, 14 MobileNets, 12 ResNets
CLASSES = 10


def _ported_jax_names():
    return sorted(n for n in jax_list_models() if n.startswith(FAMILIES))


def _jax_shapes(name):
    model = jax_create_model(name, num_classes=CLASSES)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3), jnp.float32))
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        names = [getattr(p, "key", getattr(p, "name", None)) for p in path]
        key = (f"quant/{'/'.join(names[1:-1])}.{names[-1]}" if names[0] == "quant"
               else "/".join(names))
        out[key] = tuple(leaf.shape)
    return out


def test_registry_names():
    """The port's names are exactly the JAX registry's (101), of them 56 of
    the families this file holds (FrostNets, MobileNets, ResNets)."""
    assert list_models() == sorted(jax_list_models())
    assert len(list_models()) == 101
    assert len(_ported_jax_names()) == N_PORTED


@pytest.mark.parametrize("name", ["mobilenet_v2", "mobilenet_v2_ReLU6", "qmobilenet_v2",
                                  "qmobilenet_v2_ReLU", "mobilenet_v3_large_HS",
                                  "qmobilenet_v3_large_ReLU", "mobilenet_v3_small_ReLU",
                                  "qmobilenet_v3_small_HS", "frostnet_base_0_5",
                                  "frostnet_large_1_25"])
def test_variables_match_jax(name):
    """Every variable of the JAX model, by name and shape, and no other;
    hence the same parameter count."""
    port = create_model(name, num_classes=CLASSES)
    mine = {k: tuple(v.shape) for k, v in model_variables(port).items()}
    assert mine == _jax_shapes(name)
    want = sum(int(np.prod(s)) for k, s in _jax_shapes(name).items() if k.startswith("params/"))
    assert sum(p.numel() for p in port.parameters()) == want


def _architecture(name):
    """Names that differ only in ``quantized`` or the activation (ReLU or
    ReLU6, HS or RE) have the same parameters: the key that groups them."""
    if name.startswith("frostnet_"):
        return name.replace("quant_", "")
    if "mobilenet_v2" in name:
        return "mobilenet_v2"
    if "mobilenet_v3" in name:
        return "mobilenet_v3_" + name.split("_")[2]
    return name.lstrip("q")


def test_parameter_counts_of_every_ported_name():
    """Each of the 56 names: the port's parameter count equals JAX's
    (``jax.eval_shape`` of ``init``) at the default 1000 classes, for one
    name of each architecture; the others of its group have the same count
    in the port (``test_variables_match_jax`` holds quantized and float
    names of one architecture to JAX's own variables)."""
    groups = {}
    for name in _ported_jax_names():  # the other 45: test_other_jax_names_raise_not_implemented
        groups.setdefault(_architecture(name), []).append(name)
    assert len(groups) == 24
    for names in groups.values():
        model = jax_create_model(names[0])
        shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 32, 32, 3), jnp.float32))["params"]
        want = sum(int(np.prod(v.shape)) for v in jax.tree.leaves(shapes))
        for name in names:
            assert sum(p.numel() for p in create_model(name).parameters()) == want, name


def test_other_jax_names_raise_not_implemented():
    """The other 45 JAX names (ShuffleNetV2, VGG, AlexNet, the float-only
    baselines, the CIFAR models, the ESPNetv2 classifiers), which raised
    ``NotImplementedError`` before they were ported, now each build with the
    JAX model's parameter count (at 1000 classes, 10 for the CIFAR names;
    VGG and AlexNet at the 224x224 their head is built for, ``cifar_alexnet``
    at 32x32, Inception-v3 at 299x299); an unknown name is a ``ValueError``.
    ``tests/test_torch_zoo.py`` holds their variables name by name."""
    from test_torch_zoo import head_size

    others = sorted(set(jax_list_models()) - set(_ported_jax_names()))
    assert len(others) == len(jax_list_models()) - N_PORTED == 45
    for name in others:
        size = head_size(name)
        shapes = jax.eval_shape(jax_create_model(name).init, jax.random.PRNGKey(0),
                                jnp.zeros((1, size, size, 3), jnp.float32))["params"]
        want = sum(int(np.prod(v.shape)) for v in jax.tree.leaves(shapes))
        assert sum(p.numel() for p in create_model(name).parameters()) == want, name
    with pytest.raises(ValueError, match="unknown model"):
        create_model("mobilenet_v4")


def test_unported_options_raise():
    """``fuse_int8`` is FrostNet's and raises on a MobileNet. The
    segmentation options are ported: ``dilated=True`` builds the trunk
    without a classifier, ``features_only`` returns the stage features."""
    for name in ("qmobilenet_v2_ReLU", "qmobilenet_v3_large_HS"):
        with pytest.raises(ValueError, match="FrostNet-only"):
            create_model(name, fuse_int8=True)
        trunk = create_model(name, dilated=True)
        assert not any(k.startswith(("params/classifier", "params/cls_"))
                       for k in model_variables(trunk))
        feats = create_model(name, num_classes=CLASSES)(torch.zeros(1, 32, 32, 3),
                                                        features_only=True)
        assert len(feats) == (4 if "v2" in name else 5)
    # defaults of the JAX factories
    m = create_model("qmobilenet_v3_small_HS")
    assert m.num_classes == 1000 and m.drop_rate == 0.2


# ---------------------------------------------------------------------------
# INT8 at small sizes, layer by layer
# ---------------------------------------------------------------------------

def calibrated(name, width, size, backend="qnnpack", batch=2, seed=0):
    """(port model, its variables tree, images): ``numpy_init`` weights with
    numpy BN shifts, each BN's running statistics read back from two float
    forwards in train mode, then the observers from two QAT forwards in eval
    mode (the recipe of the full-width fixture, made here in the port)."""
    model = create_model(name, num_classes=CLASSES, width_mult=width, drop_rate=0.0,
                         qconfig=get_qconfig(backend))
    flat = flatten_variables(numpy_init(model, seed))
    rng = np.random.RandomState(seed + 1)
    for k in sorted(flat):
        if k.endswith("/bias_bn"):
            flat[k] = rng.normal(0.5, 0.5, flat[k].shape).astype(np.float32)
    from_jax_variables(model, unflatten_variables(flat))
    bns = [m for m in model.modules() if isinstance(m, QConvBNAct) and m.use_bn]
    draws = [torch.as_tensor(rng.randn(batch, size, size, 3).astype(np.float32))
             for _ in range(4)]
    with torch.no_grad():
        total = [np.zeros((2, m.features)) for m in bns]
        for d in draws[:2]:
            for m in bns:
                m.mean.zero_()
                m.var.zero_()
            model(d, mode=FP32, train=True)
            for t, m in zip(total, bns):
                t += np.stack([m.mean.double().numpy(), m.var.double().numpy()]) / m.bn_momentum
        for t, m in zip(total, bns):
            m.mean.copy_(torch.as_tensor((t[0] / 2).astype(np.float32)))
            m.var.copy_(torch.as_tensor((t[1] / 2).astype(np.float32)))
        for d in draws[2:]:
            model(d, mode=QAT, train=False)
    tree = unflatten_variables({k: v.detach().numpy().copy()
                                for k, v in model_variables(model).items()})
    images = np.random.RandomState(seed + 2).randn(batch, size, size, 3).astype(np.float32)
    return model, tree, images


def port_codes(model, images, size):
    from chip_smoke import layer_codes

    class Pred:  # what chip_smoke.layer_codes reads of an Int8Predictor
        def __init__(self):
            self.model, self.fn = model, freeze(model, device="cpu", image_size=size)

        def __call__(self, x):
            return self.fn(x)

    return layer_codes(Pred(), images)


# (name, width, size, backend): the full-width fixture covers qnnpack's
# qmobilenet_v2_ReLU and qmobilenet_v3_large_HS (and tests/test_torch_blocks.py
# every bottleneck); these add fbgemm's grids, ReLU6, the small model's cls_se
# and the RE variant (its head keeps the hard-swish)
SMALL_INT8 = [("qmobilenet_v2_ReLU6", 0.35, 32, "fbgemm"),
              ("qmobilenet_v3_small_ReLU", 0.5, 32, "fbgemm")]


@pytest.mark.parametrize("case", SMALL_INT8, ids=lambda c: f"{c[0]}-{c[3]}")
def test_export_and_int8_layers_bit_equal(case, tmp_path):
    """The port's ``export_int8`` equals JAX's array for array (the SE's
    ``QDense`` kernels int8 in their ``(in, out, 1, 1)`` shape); the frozen
    JAX graph on JAX's ``load_int8`` of the port's artifact and the port
    serving that artifact give the same codes at every top-level layer and
    the same logits."""
    name, width, size, backend = case
    model, tree, images = calibrated(name, width, size, backend)
    mine, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    export_int8(model, mine)
    jq.export_int8(jax_variables(tree), theirs, qconfig=jq.get_qconfig(backend))
    with np.load(mine) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        dense = [k for k in a.files if k.endswith("/kernel") and "/fc" in k]
        assert all(a[k].dtype == np.int8 and a[k].shape[2:] == (1, 1) for k in dense)
        assert bool(dense) == ("v3" in name)
    from test_torch_mobilenet_fixture import jax_reference_codes

    jmodel = jax_create_model(name, num_classes=CLASSES, width_mult=width,
                              qconfig=jq.get_qconfig(backend))
    want, jcodes = jax_reference_codes(jmodel, jq.load_int8(mine), jnp.asarray(images))
    served = create_model(name, num_classes=CLASSES, width_mult=width,
                          qconfig=get_qconfig(backend))
    from_jax_variables(served, load_int8(mine))
    logits, codes = port_codes(served, images, size)
    assert sorted(codes) == sorted(jcodes)
    for k, c in jcodes.items():
        np.testing.assert_array_equal(codes[k].numpy(), c, err_msg=k)
        assert len(np.unique(c)) >= 8, k
    np.testing.assert_array_equal(logits.numpy(), want)
    direct = freeze(model, "cpu", size)(images).numpy()
    np.testing.assert_array_equal(direct, want)


# ---------------------------------------------------------------------------
# The user's path: trainer, evaluator, serve.main
# ---------------------------------------------------------------------------

def test_trainer_evaluator_and_serve_on_cpu(tmp_path):
    """``classification.main`` on ``qmobilenet_v3_small_HS`` (one FP32 and one
    QAT epoch of one step, 32x32, 10 classes), ``evaluate.main
    --export_int8`` on ``best/``, then ``serve.main`` on the artifact: its
    logits equal the in-process freeze of the evaluator's model bit for bit;
    ``--fuse_int8`` on a MobileNet is refused as FrostNet-only."""
    from frostnet_tpu_torch import serve
    from frostnet_tpu_torch.train import classification, evaluate

    name = "qmobilenet_v3_small_HS"
    cfg = classification.ClassificationConfig(
        model=name, num_classes=CLASSES, image_size=32, batch_size=4, steps_per_epoch=1,
        fp_epochs=1, epochs=1, learning_rate=1e-3, log_every=1, device="cpu",
        save_dir=str(tmp_path / "run"))
    _, res = classification.main(cfg)
    for h in res["history"]:
        assert np.isfinite(h["loss"])
    assert np.isfinite(res["qat"]["loss"]) and np.isfinite(res["int8"]["loss"])
    for f in ("checkpoint", "best", "checkpoint_meta.json", "metrics.jsonl"):
        assert os.path.exists(tmp_path / "run" / f), f
    with open(tmp_path / "run" / "checkpoint_meta.json") as f:
        assert json.load(f)["qat_epoch"] == 1

    artifact = str(tmp_path / "int8.npz")
    ev = evaluate.main(evaluate.build_parser([]).parse_args(
        ["--model", name, "--checkpoint", str(tmp_path / "run" / "best"), "--num_classes",
         str(CLASSES), "--image_size", "32", "--batch_size", "4", "--calib_batches", "1",
         "--export_int8", artifact, "--device", "cpu"]))
    assert np.isfinite(ev["int8"]["loss"]) and ev["export_bytes"] == os.path.getsize(artifact)
    direct = create_model(name, num_classes=CLASSES)
    direct.load_state_dict(ev["state"].model.state_dict())
    images = np.random.RandomState(0).randn(2, 32, 32, 3).astype(np.float32)
    want = freeze(direct, "cpu", 32)(images).numpy()
    logits = str(tmp_path / "logits.npy")
    argv = ["--model", name, "--artifact", artifact, "--num_classes", str(CLASSES),
            "--image_size", "32", "--batch_size", "2", "--iters", "1", "--device", "cpu",
            "--save_logits", logits]
    serve.main(serve.build_parser().parse_args(argv))
    np.testing.assert_array_equal(np.load(logits), want)
    with pytest.raises(ValueError, match="FrostNet-only"):
        serve.main(serve.build_parser().parse_args(argv + ["--fuse_int8"]))
