"""The committed full-width fixtures of the rest of the zoo (PyTorch port).

For ``qvgg16_bn``, ``qshufflenet_v2_x1_0`` and ``qalexnet`` (qnnpack,
224x224, 1000 classes) and the segmentation models ``espnetv2`` (s 2.0) and
``espnet`` (p 2, q 8), both at the Cityscapes crop of 768 with 19 classes,
``frostnet_tpu_torch/testdata`` holds what the JAX package computes from
weights both packages can make, so that ``chip_smoke.py`` phase 20 holds the
port against the reference on the GPU without JAX:

* ``zoo_<model>_calibration.npz``: on top of ``numpy_init(model, 0)``,
  each BN's shift (``bias_bn``, drawn from ``N(BN_SHIFT)`` with
  ``RandomState(1)`` in key order), each BN's running statistics (the mean,
  over ``BN_FORWARDS`` float forwards in train mode, of the batch
  statistics) and every observer (two QAT forwards in eval mode), as flat
  JAX keys; images ``RandomState(2).randn``.
* ``zoo_<model>_reference.npz``: for the images ``RandomState(0).randn``
  (8 at 224x224; 2 at 768x768), the frozen JAX graph's output (a
  classifier's logits; a segmentation model's logits at every
  ``SEG_LOGIT_STRIDE``-th pixel and its argmax) and, for every module whose
  output is a QTensor (a classifier's top-level modules and ``pool``, the
  ``fc`` input; every module of a segmentation model, by its path),
  ``sha256/<layer>`` (per image) and ``shape/<layer>``.
* ``zoo_<espnet|espnetv2>_train_reference.npz``: JAX's segmentation train
  step from ``numpy_init(model, 0)`` at 768x768, batch 2
  (``chip_smoke.seg_train_batch`` batches): one FP32 step, ``start_qat``,
  one QAT step (QSGD, lr 0.05, ``grouped_weight_decay(4e-5)``,
  ``noise_decay=1.0``, the Cityscapes class weights): the two losses, then
  the BN statistics and observers.

Regenerate with ``python tests/test_torch_zoo_fixture.py [name ...]``
(``train_espnet`` and ``train_espnetv2`` for the training references; about
fifteen CPU minutes in all, most of it compiling the JAX train steps). Under pytest
this file checks the fixtures' keys and spread and serves the first image
of ``qshufflenet_v2_x1_0`` and ``qalexnet`` through the port on the CPU,
layer by layer, against the digests (the others are held on the card).
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
TESTDATA = os.path.join(ROOT, "frostnet_tpu_torch", "testdata")
CLS_MODELS = ("qvgg16_bn", "qshufflenet_v2_x1_0", "qalexnet")
# (registry name, keywords): the segmentation fixtures
SEG_FIXTURES = {"espnetv2": {"s": 2.0}, "espnet": {"p": 2, "q": 8}}
IMAGE_SIZE, CLS_BATCH, CROP, SEG_BATCH, SEG_CLASSES = 224, 8, 768, 2, 19
BN_FORWARDS = 2
BN_SHIFT = (0.5, 0.5)  # mean and std of the BN shifts
# the training references, one per segmentation fixture
TRAIN = {name: dict(model=name, crop=CROP, batch=2, seed=0, lr=0.05, wd=4e-5)
         for name in SEG_FIXTURES}


def paths(name):
    return (os.path.join(TESTDATA, f"zoo_{name}_calibration.npz"),
            os.path.join(TESTDATA, f"zoo_{name}_reference.npz"))


def train_reference(name):
    return os.path.join(TESTDATA, f"zoo_{name}_train_reference.npz")


def port_model(name):
    """The port's model of a fixture (the segmentation ones with 19 classes)."""
    if name in SEG_FIXTURES:
        from frostnet_tpu_torch.segmentation import get_seg_model

        return get_seg_model(name, num_classes=SEG_CLASSES, **SEG_FIXTURES[name])
    from frostnet_tpu_torch.models import create_model

    return create_model(name)


def jax_model(name):
    if name in SEG_FIXTURES:
        from frostnet_tpu.segmentation import get_seg_model

        return get_seg_model(name, num_classes=SEG_CLASSES, **SEG_FIXTURES[name])
    from frostnet_tpu.models import create_model

    return create_model(name)


def jax_codes(model, variables, images, segmentation):
    """(output, {layer: u8 codes}) of the frozen JAX graph: a classifier's
    top-level QTensor outputs and ``pool`` (``fc``'s QTensor input), or
    every QTensor module output of a segmentation model, by path."""
    import flax.linen as fnn
    import jax

    from frostnet_tpu import nn as fnn_q
    from frostnet_tpu.quant.qtensor import QTensor

    def fn(x):
        codes = {}

        def record(next_fun, args, kwargs, context):
            path = context.module.scope.path
            call = context.method_name == "__call__"
            if call and not segmentation and tuple(path) == ("fc",):
                codes["pool"] = args[0].q
            out = next_fun(*args, **kwargs)
            if call and isinstance(out, QTensor) and (segmentation or len(path) == 1):
                codes["/".join(path)] = out.q
            return out

        with fnn.intercept_methods(record):
            out = model.apply(variables, x, mode=fnn_q.INT8)
        return out, codes

    out, codes = jax.jit(fn)(images)
    return np.asarray(out), {k: np.asarray(v) for k, v in codes.items()}


def calibrate(name, shape):
    """(JAX model, variables): ``numpy_init(port model, 0)`` with seeded BN
    shifts, BN statistics from ``BN_FORWARDS`` float train forwards and the
    observers from two QAT eval forwards (``RandomState(2)`` images)."""
    import jax
    import jax.numpy as jnp

    from _torch_port import jax_variables
    from frostnet_tpu import nn as fnn_q
    from frostnet_tpu.nn.conv import QConvBNAct
    from frostnet_tpu_torch.quant import numpy_init
    from frostnet_tpu_torch.quant.export import flatten_variables, unflatten_variables

    flat = flatten_variables(numpy_init(port_model(name), 0))
    rng = np.random.RandomState(1)
    for k in sorted(flat):
        if k.endswith("/bias_bn"):
            flat[k] = rng.normal(*BN_SHIFT, flat[k].shape).astype(np.float32)
    variables = jax_variables(unflatten_variables(flat))
    variables.setdefault("batch_stats", {})
    model = jax_model(name)
    rng = np.random.RandomState(2)

    def draw():
        return jnp.asarray(rng.randn(*shape).astype(np.float32))

    if variables["batch_stats"]:
        m = QConvBNAct.bn_momentum
        zeroed = jax.tree.map(jnp.zeros_like, variables["batch_stats"])
        bn_forward = jax.jit(lambda v, xb: model.apply(
            {**v, "batch_stats": zeroed}, xb, mode=fnn_q.FP32, train=True,
            mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})[1]["batch_stats"])
        total = None
        for _ in range(BN_FORWARDS):
            b = jax.tree.map(lambda a: np.asarray(a, np.float64) / m, bn_forward(variables, draw()))
            total = b if total is None else jax.tree.map(np.add, total, b)
        variables = {**variables, "batch_stats": jax.tree.map(
            lambda a: jnp.asarray((a / BN_FORWARDS).astype(np.float32)), total)}
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

    from chip_smoke import SEG_LOGIT_STRIDE, code_digests
    from frostnet_tpu.quant import export_int8, load_int8
    from frostnet_tpu_torch.quant.export import flatten_variables

    segmentation = name in SEG_FIXTURES
    shape = ((SEG_BATCH, CROP, CROP, 3) if segmentation
             else (CLS_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3))
    model, variables = calibrate(name, shape)
    calibrated = flatten_variables(jax.tree.map(np.asarray, variables))
    keep = {k: v for k, v in calibrated.items()
            if not k.startswith("params/") or k.endswith("/bias_bn")}
    calibration, reference = paths(name)
    os.makedirs(TESTDATA, exist_ok=True)
    np.savez_compressed(calibration, **keep)
    with tempfile.TemporaryDirectory() as tmp:
        artifact = os.path.join(tmp, f"{name}_int8.npz")
        export_int8(variables, artifact)
        served = load_int8(artifact)
    images = np.random.RandomState(0).randn(*shape).astype(np.float32)
    out, codes = jax_codes(model, served, jnp.asarray(images), segmentation)
    layers = {}
    for k, v in codes.items():
        layers[f"sha256/{k}"] = np.asarray(code_digests(torch.as_tensor(v)))
        layers[f"shape/{k}"] = np.asarray(v.shape, np.int64)
    if segmentation:
        o = SEG_LOGIT_STRIDE // 2
        outputs = dict(logits_sampled=out[:, o::SEG_LOGIT_STRIDE, o::SEG_LOGIT_STRIDE],
                       argmax=out.argmax(-1).astype(np.uint8))
    else:
        outputs = dict(logits=out)
    np.savez_compressed(reference, image_seed=np.int64(0),
                        image_shape=np.asarray(shape, np.int64), **outputs, **layers)
    return out, codes


def make_train_reference(name):
    import jax

    from _torch_port import jax_train_state
    from chip_smoke import seg_train_batch
    from frostnet_tpu.nn import FP32, QAT
    from frostnet_tpu.optim import get_optimizer, grouped_weight_decay
    from frostnet_tpu.segmentation.data import CITYSCAPES_CLASS_WEIGHTS
    from frostnet_tpu.segmentation.train import make_seg_train_step
    from frostnet_tpu_torch.quant import numpy_init
    from frostnet_tpu_torch.quant.export import flatten_variables

    meta = TRAIN[name]
    model = jax_model(name)
    tree = numpy_init(port_model(name), meta["seed"])
    tx = get_optimizer("QSGD", meta["lr"], weight_decay=grouped_weight_decay(meta["wd"]),
                       noise_decay=1.0)
    state = jax_train_state(model, tree, tx)
    losses = []
    for k, mode in enumerate((FP32, QAT)):
        if k == 1:
            state = state.start_qat()
        step = make_seg_train_step(model, mode, CITYSCAPES_CLASS_WEIGHTS, 255, SEG_CLASSES)
        state, m = step(state, seg_train_batch(k, meta["crop"], meta["batch"]))
        losses.append(float(m["loss"]))
    flat = flatten_variables(jax.tree.map(np.asarray, {"batch_stats": state.batch_stats,
                                                       "quant": state.quant}))
    np.savez_compressed(train_reference(name), loss=np.asarray(losses, np.float32),
                        __meta__=np.frombuffer(json.dumps(meta).encode(), np.uint8), **flat)
    return losses


def load(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def layers_of(ref):
    return sorted(k[len("sha256/"):] for k in ref if k.startswith("sha256/"))


@pytest.mark.parametrize("name", CLS_MODELS + tuple(SEG_FIXTURES))
def test_fixture_keys_and_spread(name):
    """The calibration covers every BN and observer of the port's model (and
    the BN shifts); every image has its own codes at every layer; the
    outputs are varied."""
    from frostnet_tpu_torch.quant import model_variables

    calibration, reference = paths(name)
    cal = load(calibration)
    mine = model_variables(port_model(name))
    assert set(cal) == {k for k in mine if not k.startswith("params/") or k.endswith("/bias_bn")}
    assert all(tuple(cal[k].shape) == tuple(mine[k].shape) for k in cal)
    ref = load(reference)
    layers = layers_of(ref)
    batch = SEG_BATCH if name in SEG_FIXTURES else CLS_BATCH
    assert len(layers) >= {"qvgg16_bn": 14, "qshufflenet_v2_x1_0": 20, "qalexnet": 6,
                           "espnetv2": 200, "espnet": 100}[name]
    for layer in layers:
        assert len(set(ref[f"sha256/{layer}"])) == batch, layer
    if name in SEG_FIXTURES:
        assert ref["argmax"].shape == (batch, CROP, CROP)
        assert len(np.unique(ref["argmax"])) >= 4
    else:
        logits = ref["logits"]
        assert logits.shape == (batch, 1000) and np.isfinite(logits).all()
        assert len({r.tobytes() for r in logits}) == batch


@pytest.mark.parametrize("name", list(SEG_FIXTURES))
def test_train_reference(name):
    ref = load(train_reference(name))
    assert json.loads(bytes(ref["__meta__"]).decode()) == TRAIN[name]
    assert ref["loss"].shape == (2,) and np.isfinite(ref["loss"]).all()
    obs = [k for k in ref if k.endswith(".min_val")]
    assert len(obs) > 100 and all(np.isfinite(ref[k]).all() for k in obs)


@pytest.mark.parametrize("name", ["qshufflenet_v2_x1_0", "qalexnet"])
def test_port_matches_fixture_layer_by_layer(name):
    """The port on the CPU, from ``numpy_init`` and the committed calibration
    through its own ``export_int8`` and ``Int8Predictor``, against the frozen
    JAX graph's committed codes and logits, first image."""
    from chip_smoke import code_digests, layer_codes, zoo_predictor

    ref = load(paths(name)[1])
    images = np.random.RandomState(0).randn(1, IMAGE_SIZE, IMAGE_SIZE, 3).astype(np.float32)
    pred = zoo_predictor(name, device="cpu")
    logits, codes = layer_codes(pred, images)
    for layer in layers_of(ref):
        assert tuple(codes[layer].shape[1:]) == tuple(ref[f"shape/{layer}"][1:]), layer
        assert code_digests(codes[layer]) == list(ref[f"sha256/{layer}"][:1]), layer
    np.testing.assert_array_equal(logits.numpy(), ref["logits"][:1])


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import jax

    jax.config.update("jax_platforms", "cpu")
    for name in sys.argv[1:] or CLS_MODELS + tuple(SEG_FIXTURES) + tuple(
            f"train_{n}" for n in SEG_FIXTURES):
        if name.startswith("train_"):
            print(name, "losses", make_train_reference(name[len("train_"):]), flush=True)
            continue
        out, codes = make_fixture(name)
        print(name, "output", out.shape, "layers", len(codes), "distinct codes at least",
              min(len(np.unique(c)) for c in codes.values()), flush=True)
