"""The committed full-width segmentation fixtures of the PyTorch port.

For ``mobilenetv3_RE_small`` (the JAX trainer's default) and
``mobilenetv3_large`` (qnnpack, 19 classes, Cityscapes geometry: the
LR-ASPP pool (37, 12), full width and depth) at the Cityscapes crop of
768x768, ``frostnet_tpu_torch/testdata`` holds what the JAX package
computes from weights both packages can make, so that ``chip_smoke.py``
phase 17 can hold the port against the reference on the GPU without JAX.
No weights are committed:

* ``seg_<model>_calibration.npz``: on top of ``numpy_init(model, 0)``, each
  BN's shift (``params/.../bias_bn``, drawn from ``N(BN_SHIFT)`` with
  ``RandomState(1)`` in key order), each BN's running statistics (the mean,
  over ``BN_FORWARDS`` float forwards in train mode, of the batch
  statistics, read back through the momentum update from zeroed ones) and
  every observer (two QAT forwards in eval mode), as flat JAX keys. The
  images are ``RandomState(2).randn(2, 768, 768, 3)``.
* ``seg_<model>_reference.npz``: for ``RandomState(0).randn(2, 768, 768,
  3)``, the frozen JAX graph served from its own INT8 artifact
  (``freeze(load_int8(export_int8(variables)))``): for each layer whose
  codes it computes (``quant``, each child of ``backbone``, ``head/lr_aspp``
  and its children, ``head/lr_aspp/pool``), ``sha256/<layer>`` (per image),
  ``shape/<layer>`` and ``hist/<layer>`` (the code histogram); the logits
  at every ``LOGIT_STRIDE``-th pixel from ``LOGIT_STRIDE // 2``
  (``logits_sampled``, (2, 48, 48, 19)) and the argmax of every pixel
  (``argmax``, uint8).

``seg_mobilenetv3_RE_small_train_reference.npz`` holds the JAX trainer's
step (``make_seg_train_step``) from ``numpy_init(model, 0)`` at 256x256,
batch 2, float32: one FP32 step, ``start_qat``, two QAT steps, then a
QAT_FROZEN eval step (QSGD lr 0.05, ``grouped_weight_decay(4e-5)``,
``noise_decay=1.0``: the GradBoost noise exactly 0; the Cityscapes class
weights, ignore label 255). Batch ``k``: ``RandomState(300 + k)``, images
``randn`` then labels ``randint(0, 19)`` with every 19th pixel set to 255.
Keys: ``loss`` (4,), ``cm`` (4, 19, 19), every observer and BN statistic
after the last step, ``__meta__``.

Regenerate with ``python tests/test_torch_seg_fixture.py`` (about 10 CPU
minutes). Under pytest this file checks the fixtures' keys and spread, and
serves the first image of each model through the port on the CPU, layer by
layer, against the digests, the sampled logits within ``SEG_LOGIT_BAND``
and the argmax within ``SEG_ARGMAX_SHARE``.
"""
import json
import os
import sys
import tempfile

import numpy as np
import pytest

from _torch_port import few_threads  # noqa: F401 - a fixture

pytestmark = pytest.mark.usefixtures("few_threads")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:  # run as a script (python tests/test_torch_seg_fixture.py)
    sys.path.insert(0, ROOT)
TESTDATA = os.path.join(ROOT, "frostnet_tpu_torch", "testdata")
MODELS = ("mobilenetv3_RE_small", "mobilenetv3_large")
CROP, BATCH, BN_FORWARDS, CLASSES = 768, 2, 2, 19
BN_SHIFT = (0.5, 0.5)  # mean and std of the BN shifts
# the logits' sampling stride and their bands, shared with chip_smoke.py
from chip_smoke import SEG_ARGMAX_SHARE, SEG_LOGIT_BAND  # noqa: E402
from chip_smoke import SEG_LOGIT_STRIDE as LOGIT_STRIDE  # noqa: E402,N812
TRAIN = dict(model="mobilenetv3_RE_small", crop=256, batch=2, seed=0, lr=0.05, wd=4e-5)


def _paths(name):
    return (os.path.join(TESTDATA, f"seg_{name}_calibration.npz"),
            os.path.join(TESTDATA, f"seg_{name}_reference.npz"))


TRAIN_REFERENCE = os.path.join(TESTDATA, f"seg_{TRAIN['model']}_train_reference.npz")


def _seg_path(path) -> bool:
    return len(path) <= 2 or (len(path) == 3 and tuple(path[:2]) == ("head", "lr_aspp"))


def jax_seg_codes(model, variables, images, head_c4=False):
    """(logits, {layer: codes}) of the frozen JAX segmentation graph (jit
    closed over ``variables``): the layers of ``chip_smoke.seg_layer_codes``;
    with ``head_c4`` also the LR-ASPP head's float output (resized to c1)
    as ``head/c4``."""
    import flax.linen as fnn
    import jax

    from frostnet_tpu import nn as fnn_q
    from frostnet_tpu.quant.qtensor import QTensor

    def fn(x):
        codes = {}

        def record(next_fun, args, kwargs, context):
            path = context.module.scope.path
            key = "/".join(path)
            if context.method_name == "__call__" and key == "head/lr_aspp/b1_conv":
                codes["head/lr_aspp/pool"] = args[0].q
            out = next_fun(*args, **kwargs)
            if context.method_name == "__call__" and _seg_path(path) and isinstance(out, QTensor):
                codes[key] = out.q
            if head_c4 and context.method_name == "__call__" and key == "head":
                codes["head/c4"] = out[1]
            return out

        with fnn.intercept_methods(record):
            out = model.apply(variables, x, mode=fnn_q.INT8)
        return out, codes

    out, codes = jax.jit(fn)(images)
    return np.asarray(out), {k: np.asarray(v) for k, v in codes.items()}


def calibrate_jax(name, crop, batch, bn_forwards, num_classes=CLASSES, seed=0):
    """(JAX model, variables): ``numpy_init(port model, seed)`` with seeded
    BN shifts, BN statistics from ``bn_forwards`` float train forwards and
    the observers from two QAT eval forwards (``RandomState(2)`` images)."""
    import jax
    import jax.numpy as jnp

    from _torch_port import jax_variables
    from frostnet_tpu import nn as fnn_q
    from frostnet_tpu.nn.conv import QConvBNAct
    from frostnet_tpu.segmentation import get_seg_model as jax_seg_model
    from frostnet_tpu_torch.quant import numpy_init
    from frostnet_tpu_torch.quant.export import flatten_variables, unflatten_variables
    from frostnet_tpu_torch.segmentation import get_seg_model

    flat = flatten_variables(numpy_init(get_seg_model(name, num_classes=num_classes), seed))
    rng = np.random.RandomState(seed + 1)
    for k in sorted(flat):
        if k.endswith("/bias_bn"):
            flat[k] = rng.normal(*BN_SHIFT, flat[k].shape).astype(np.float32)
    variables = jax_variables(unflatten_variables(flat))
    model = jax_seg_model(name, num_classes=num_classes)
    shape = (batch, crop, crop, 3)
    rng = np.random.RandomState(seed + 2)

    def draw():
        return jnp.asarray(rng.randn(*shape).astype(np.float32))

    m = QConvBNAct.bn_momentum
    zeroed = jax.tree.map(jnp.zeros_like, variables["batch_stats"])
    bn_forward = jax.jit(lambda v, xb: model.apply(
        {**v, "batch_stats": zeroed}, xb, mode=fnn_q.FP32, train=True,
        mutable=["batch_stats"])[1]["batch_stats"])
    total = None
    for _ in range(bn_forwards):
        b = jax.tree.map(lambda a: np.asarray(a, np.float64) / m, bn_forward(variables, draw()))
        total = b if total is None else jax.tree.map(np.add, total, b)
    variables = {**variables, "batch_stats": jax.tree.map(
        lambda a: jnp.asarray((a / bn_forwards).astype(np.float32)), total)}
    observe = jax.jit(lambda v, xb: model.apply(v, xb, mode=fnn_q.QAT, train=False,
                                                mutable=["quant"]))
    for _ in range(2):
        _, updates = observe(variables, draw())
        variables = {**variables, **updates}
    return model, variables


def make_fixture(name):
    import jax
    import jax.numpy as jnp
    import torch

    from chip_smoke import code_digests
    from frostnet_tpu.quant import export_int8, load_int8
    from frostnet_tpu_torch.quant.export import flatten_variables

    model, variables = calibrate_jax(name, CROP, BATCH, BN_FORWARDS)
    calibrated = flatten_variables(jax.tree.map(np.asarray, variables))
    keep = {k: v for k, v in calibrated.items()
            if not k.startswith("params/") or k.endswith("/bias_bn")}
    calibration, reference = _paths(name)
    os.makedirs(TESTDATA, exist_ok=True)
    np.savez_compressed(calibration, **keep)
    with tempfile.TemporaryDirectory() as tmp:
        artifact = os.path.join(tmp, f"{name}_int8.npz")
        export_int8(variables, artifact)
        served = load_int8(artifact)
    images = np.random.RandomState(0).randn(BATCH, CROP, CROP, 3).astype(np.float32)
    logits, codes = jax_seg_codes(model, served, jnp.asarray(images))
    layers = {}
    for k, v in codes.items():
        layers[f"sha256/{k}"] = np.asarray(code_digests(torch.as_tensor(v)))
        layers[f"shape/{k}"] = np.asarray(v.shape, np.int64)
        lo = int(v.min())
        layers[f"hist/{k}"] = np.bincount((v.astype(np.int64) - lo).ravel()).astype(np.int64)
        layers[f"histmin/{k}"] = np.int64(lo)
    o = LOGIT_STRIDE // 2
    np.savez_compressed(reference, logits_sampled=logits[:, o::LOGIT_STRIDE, o::LOGIT_STRIDE],
                        argmax=logits.argmax(-1).astype(np.uint8), image_seed=np.int64(0),
                        image_shape=np.asarray(images.shape, np.int64), **layers)
    return logits, codes


def train_batch(k):
    """Batch ``k`` of the segmentation training reference."""
    from chip_smoke import seg_train_batch

    return seg_train_batch(k, TRAIN["crop"], TRAIN["batch"])


def make_train_reference(path=TRAIN_REFERENCE):
    import jax

    jax.config.update("jax_default_matmul_precision", "highest")
    from _torch_port import jax_train_state
    from frostnet_tpu.nn import FP32, QAT, QAT_FROZEN
    from frostnet_tpu.optim import get_optimizer, grouped_weight_decay
    from frostnet_tpu.segmentation import get_seg_model as jax_seg_model
    from frostnet_tpu.segmentation.data import CITYSCAPES_CLASS_WEIGHTS
    from frostnet_tpu.segmentation.train import make_seg_eval_step, make_seg_train_step
    from frostnet_tpu_torch.quant import numpy_init
    from frostnet_tpu_torch.quant.export import flatten_variables
    from frostnet_tpu_torch.segmentation import get_seg_model

    name = TRAIN["model"]
    tree = numpy_init(get_seg_model(name, num_classes=CLASSES), TRAIN["seed"])
    model = jax_seg_model(name, num_classes=CLASSES)
    tx = get_optimizer("QSGD", TRAIN["lr"], weight_decay=grouped_weight_decay(TRAIN["wd"]),
                       noise_decay=1.0)
    state = jax_train_state(model, tree, tx)
    losses, cms = [], []
    for k, mode in enumerate((FP32, QAT, QAT)):
        if k == 1:
            state = state.start_qat()
        step = make_seg_train_step(model, mode, CITYSCAPES_CLASS_WEIGHTS, 255, CLASSES)
        state, m = step(state, train_batch(k))
        losses.append(float(m["loss"]))
        cms.append(np.asarray(m["cm"]))
        print(f"step {k}: loss {losses[-1]:.6f}", flush=True)
    cms.append(np.asarray(make_seg_eval_step(model, QAT_FROZEN, CLASSES, 255)(
        state, train_batch(3))))
    losses.append(float("nan"))  # the eval step gives no loss
    flat = flatten_variables(jax.tree.map(np.asarray, {"batch_stats": state.batch_stats,
                                                       "quant": state.quant}))
    meta = dict(TRAIN, classes=CLASSES, steps=["FP32", "start_qat", "QAT", "QAT",
                                               "QAT_FROZEN eval"], jax=jax.__version__)
    np.savez_compressed(path, loss=np.asarray(losses, np.float32),
                        cm=np.stack(cms).astype(np.int64),
                        __meta__=np.frombuffer(json.dumps(meta).encode(), np.uint8),
                        **{k: np.asarray(v, np.float32) for k, v in flat.items()})
    print("wrote", path, "losses", losses)


def load(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def layers_of(ref):
    return sorted(k[len("sha256/"):] for k in ref if k.startswith("sha256/"))


@pytest.mark.parametrize("name", MODELS)
def test_fixture_keys_and_spread(name):
    """The calibration covers every BN and observer of the port's model; the
    reference's layers are varied and every image its own; the logits are
    finite and their argmax takes several classes."""
    from chip_smoke import seg_variables
    from frostnet_tpu_torch.quant import model_variables
    from frostnet_tpu_torch.segmentation import get_seg_model

    calibration, reference = _paths(name)
    cal = load(calibration)
    mine = model_variables(get_seg_model(name))
    assert set(cal) == {k for k in mine if not k.startswith("params/") or k.endswith("/bias_bn")}
    assert all(np.isfinite(v).all() for v in seg_variables(name).values())
    ref = load(reference)
    layers = layers_of(ref)
    assert {"quant", "backbone/layer5", "head/lr_aspp", "head/lr_aspp/pool",
            "head/lr_aspp/b1_hsig", "head/lr_aspp/quant_mul"} <= set(layers)
    for layer in layers:
        hist = ref[f"hist/{layer}"]
        assert len(set(ref[f"sha256/{layer}"])) == BATCH, layer
        if layer not in ("head/lr_aspp/pool", "head/lr_aspp/b1_conv", "head/lr_aspp/b1_hsig"):
            # (the gate's maps are 1x1: one code a channel)
            assert (hist > 0).sum() >= 16 and hist.max() <= 0.75 * hist.sum(), layer
    assert ref["logits_sampled"].shape == (BATCH, CROP // LOGIT_STRIDE, CROP // LOGIT_STRIDE,
                                           CLASSES)
    assert np.isfinite(ref["logits_sampled"]).all()
    assert len(np.unique(ref["argmax"])) >= 3


def check_against_reference(name, model, logits, codes, n_images):
    """``chip_smoke``'s checks of a served fixture on its first ``n_images``:
    every layer's digests (no code moved) and each image's logits and argmax
    in the bands."""
    from chip_smoke import check_seg_layers, se_layers, seg_logits_check

    ref = np.load(_paths(name)[1])
    _, moved, _ = check_seg_layers(name, codes, ref, se_layers(model))
    assert not moved, moved
    return seg_logits_check(name, logits, ref)


@pytest.mark.parametrize("name", MODELS)
def test_port_matches_fixture_layer_by_layer(name):
    """The port on the CPU, from ``numpy_init`` and the committed calibration
    through its own ``export_int8`` and ``load_int8``, against the frozen
    JAX graph's committed codes and logits, first image."""
    from chip_smoke import seg_layer_codes, seg_served_model

    images = np.random.RandomState(0).randn(1, CROP, CROP, 3).astype(np.float32)
    model, fn = seg_served_model(name, "cpu")
    logits, codes = seg_layer_codes(model, fn, images)
    check_against_reference(name, model, logits, codes, 1)


def test_train_reference_keys():
    from frostnet_tpu_torch.quant import model_variables
    from frostnet_tpu_torch.segmentation import get_seg_model

    ref = load(TRAIN_REFERENCE)
    mine = model_variables(get_seg_model(TRAIN["model"]))
    want = {k for k in mine if not k.startswith("params/")}
    assert {k for k in ref if k not in ("loss", "cm", "__meta__")} == want
    assert ref["loss"].shape == (4,) and np.isfinite(ref["loss"][:3]).all()
    assert ref["cm"].shape == (4, CLASSES, CLASSES)
    valid = (train_batch(0)["label"] != 255).sum()
    assert ref["cm"][0].sum() == valid
    assert json.loads(bytes(ref["__meta__"]).decode())["model"] == TRAIN["model"]


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    which = sys.argv[1:] or list(MODELS) + ["train"]
    for name in which:
        if name == "train":
            make_train_reference()
            continue
        out, codes = make_fixture(name)
        print(name, "logits", out.shape, "argmax classes", np.unique(out.argmax(-1)).tolist())
        for layer in sorted(codes):
            c = codes[layer]
            print(f"  {layer:28s} {c.shape} {c.dtype} distinct {len(np.unique(c))}")
