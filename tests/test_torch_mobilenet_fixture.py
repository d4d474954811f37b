"""The committed full-width MobileNet fixtures of the PyTorch port.

For ``qmobilenet_v2_ReLU`` and ``qmobilenet_v3_large_HS`` (qnnpack, 224x224,
1000 classes, full width and depth) ``frostnet_tpu_torch/testdata`` holds
what the JAX package computes from weights both packages can make, so that
``chip_smoke.py`` can hold the port against the reference on the GPU without
JAX and without committing an INT8 artifact (``chip_smoke.py`` writes it at
run time with the port's ``export_int8``):

* ``<model>_calibration.npz``: the variables calibration produced, as flat
  JAX keys, on top of ``numpy_init(model, 0)``: each BN's shift
  (``params/.../bias_bn``, drawn from ``N(BN_SHIFT)`` with
  ``RandomState(1)`` in key order, so that no ReLU layer is half zeros and
  the hard-swish grids are varied), each BN's running statistics (the mean,
  over ``BN_FORWARDS`` float forwards in train mode, of the batch
  statistics, read back through the momentum update from zeroed ones), and
  every observer (two QAT forwards in eval mode, on the folded graph that
  ``freeze`` serves). The images are ``RandomState(2).randn``.
* ``<model>_reference.npz``: for the batch ``RandomState(0).randn(8, 224,
  224, 3)``, the frozen JAX graph's logits (``freeze(load_int8(export_int8(
  variables)))``) and, for each top-level layer whose INT8 codes it
  computes (and ``pool``, MobileNetV2's pooled codes),
  ``sha256/<layer>`` (per image, NHWC uint8), ``shape/<layer>`` and
  ``hist/<layer>`` (the 256-code histogram).

Regenerate with ``python tests/test_torch_mobilenet_fixture.py`` (a few CPU
minutes). Under pytest this file checks the fixtures' keys and spread, that
some hard-swish grids sit on both of ``_relu6``'s edges (a zero point
shifted below 0, a ``q6`` past 255), and serves the first image of each
through the port on the CPU, layer by layer, against the digests.
"""
import os
import sys
import tempfile

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(ROOT, "frostnet_tpu_torch", "testdata")
MODELS = ("qmobilenet_v2_ReLU", "qmobilenet_v3_large_HS")
IMAGE_SIZE, BATCH, BN_FORWARDS = 224, 8, 4
BN_SHIFT = (0.5, 0.5)  # mean and std of the BN shifts


def _paths(name):
    return (os.path.join(TESTDATA, f"{name}_calibration.npz"),
            os.path.join(TESTDATA, f"{name}_reference.npz"))


def jax_reference_codes(model, variables, images):
    """(logits, {layer: u8 codes}) of the frozen JAX graph: the QTensor
    output of each top-level module, and the classifier's QTensor input as
    ``pool``."""
    import flax.linen as fnn
    import jax

    from frostnet_tpu import nn as fnn_q
    from frostnet_tpu.quant.qtensor import QTensor

    def fn(x):
        codes = {}

        def record(next_fun, args, kwargs, context):
            path = context.module.scope.path
            top = context.method_name == "__call__" and len(path) == 1
            if top and path[0] == "classifier" and isinstance(args[0], QTensor):
                codes["pool"] = args[0].q
            out = next_fun(*args, **kwargs)
            if top and isinstance(out, QTensor):
                codes[path[0]] = out.q
            return out

        with fnn.intercept_methods(record):
            out = model.apply(variables, x, mode=fnn_q.INT8)
        return out, codes

    out, codes = jax.jit(fn)(images)
    return np.asarray(out), {k: np.asarray(v) for k, v in codes.items()}


def make_fixture(name):
    import jax
    import jax.numpy as jnp
    import torch

    from _torch_port import jax_variables
    from chip_smoke import code_digests
    from frostnet_tpu import nn as fnn_q
    from frostnet_tpu.models import create_model as jax_create_model
    from frostnet_tpu.nn.conv import QConvBNAct
    from frostnet_tpu.quant import export_int8, freeze, load_int8
    from frostnet_tpu_torch.models import create_model
    from frostnet_tpu_torch.quant import numpy_init
    from frostnet_tpu_torch.quant.export import flatten_variables, unflatten_variables

    flat = flatten_variables(numpy_init(create_model(name), 0))
    rng = np.random.RandomState(1)
    for k in sorted(flat):
        if k.endswith("/bias_bn"):
            flat[k] = rng.normal(*BN_SHIFT, flat[k].shape).astype(np.float32)
    variables = jax_variables(unflatten_variables(flat))
    model = jax_create_model(name, drop_rate=0.0)
    shape = (BATCH, IMAGE_SIZE, IMAGE_SIZE, 3)
    rng = np.random.RandomState(2)

    def draw():
        return jnp.asarray(rng.randn(*shape).astype(np.float32))

    m = QConvBNAct.bn_momentum
    zeroed = jax.tree.map(jnp.zeros_like, variables["batch_stats"])
    bn_forward = jax.jit(lambda v, xb: model.apply(
        {**v, "batch_stats": zeroed}, xb, mode=fnn_q.FP32, train=True,
        mutable=["batch_stats"])[1]["batch_stats"])
    total = None
    for _ in range(BN_FORWARDS):
        batch = jax.tree.map(lambda a: np.asarray(a, np.float64) / m, bn_forward(variables, draw()))
        total = batch if total is None else jax.tree.map(np.add, total, batch)
    variables = {**variables, "batch_stats": jax.tree.map(
        lambda a: jnp.asarray((a / BN_FORWARDS).astype(np.float32)), total)}
    observe = jax.jit(lambda v, xb: model.apply(v, xb, mode=fnn_q.QAT, train=False,
                                                mutable=["quant"]))
    for _ in range(2):
        _, updates = observe(variables, draw())
        variables = {**variables, **updates}

    calibrated = flatten_variables(jax.tree.map(np.asarray, variables))
    keep = {k: v for k, v in calibrated.items()
            if not k.startswith("params/") or k.endswith("/bias_bn")}
    calibration, reference = _paths(name)
    os.makedirs(TESTDATA, exist_ok=True)
    np.savez(calibration, **keep)

    with tempfile.TemporaryDirectory() as tmp:
        artifact = os.path.join(tmp, f"{name}_int8.npz")
        export_int8(variables, artifact)
        served = load_int8(artifact)
    images = np.random.RandomState(0).randn(*shape).astype(np.float32)
    logits = np.asarray(freeze(model, served)(jnp.asarray(images)))
    recorded, codes = jax_reference_codes(model, served, jnp.asarray(images))
    np.testing.assert_array_equal(recorded, logits)
    layers = {}
    for k, v in codes.items():
        layers[f"sha256/{k}"] = np.asarray(code_digests(torch.as_tensor(v)))
        layers[f"shape/{k}"] = np.asarray(v.shape, np.int64)
        layers[f"hist/{k}"] = np.bincount(v.ravel(), minlength=256).astype(np.int64)
    np.savez(reference, logits=logits, image_seed=np.int64(0),
             image_shape=np.asarray(shape, np.int64), **layers)
    return logits, codes


def load(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def layers_of(ref):
    return sorted(k[len("sha256/"):] for k in ref if k.startswith("sha256/"))


@pytest.mark.parametrize("name", MODELS)
def test_fixture_keys_and_spread(name):
    """The calibration covers every BN and observer of the port's model;
    the reference's layers are varied (no layer on a few codes, every image
    its own) and so are the logits."""
    from chip_smoke import mobilenet_variables
    from frostnet_tpu_torch.models import create_model
    from frostnet_tpu_torch.quant import model_variables

    calibration, reference = _paths(name)
    cal = load(calibration)
    mine = model_variables(create_model(name))
    want = {k for k in mine if not k.startswith("params/") or k.endswith("/bias_bn")}
    assert set(cal) == want
    flat = mobilenet_variables(name)
    assert all(np.isfinite(v).all() for v in flat.values())
    ref = load(reference)
    layers = layers_of(ref)
    assert "quant" in layers and len(layers) >= 20
    for layer in layers:
        hist = ref[f"hist/{layer}"]
        assert (hist > 0).sum() >= 16, layer
        assert hist.max() <= 0.75 * hist.sum(), layer
        assert len(set(ref[f"sha256/{layer}"])) == BATCH, layer
    logits = ref["logits"]
    assert logits.shape == (BATCH, 1000) and np.isfinite(logits).all()
    # every image its own logits (at random init the argmax is mostly one
    # class: the BN shifts dominate the pooled features)
    assert len(np.unique(logits)) > 100 and len({r.tobytes() for r in logits}) == BATCH


def test_hswish_grids_hit_both_relu6_edges():
    """Hazard of the INT8 hard-swish: ``add_scalar`` shifts the zero point
    below 0 and ``round(6 / s) + zp`` passes 255 (JAX saturates it) at some
    sites of the full-width MobileNetV3, while at others the clamp at 6.0
    binds inside the grid."""
    from chip_smoke import mobilenet_predictor
    from frostnet_tpu_torch.nn import QHswish

    pred = mobilenet_predictor("qmobilenet_v3_large_HS", device="cpu")
    sites = [m for m in pred.model.modules() if isinstance(m, QHswish)]
    lo = [m._lo for m in sites]
    hi = [m._hi for m in sites]
    assert len(sites) == 21
    assert any(v < 0 for v in lo) and any(v >= 0 for v in lo)
    assert any(v == 255 for v in hi) and any(v < 255 for v in hi)


@pytest.mark.parametrize("name", MODELS)
def test_port_matches_fixture_layer_by_layer(name):
    """The port on the CPU, from ``numpy_init`` and the committed calibration
    through its own ``export_int8`` and ``Int8Predictor``, against the frozen
    JAX graph's committed codes and logits, first image."""
    from chip_smoke import code_digests, layer_codes, mobilenet_predictor

    ref = load(_paths(name)[1])
    images = np.random.RandomState(0).randn(1, IMAGE_SIZE, IMAGE_SIZE, 3).astype(np.float32)
    pred = mobilenet_predictor(name, device="cpu")
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
    for name in sys.argv[1:] or MODELS:
        out, codes = make_fixture(name)
        print(name, "logits", out.shape, "distinct", len(np.unique(out)),
              "argmax", out.argmax(axis=1).tolist())
        for layer in sorted(codes):
            c = codes[layer]
            hist = np.bincount(c.ravel(), minlength=256)
            print(f"  {layer:11s} {c.shape} distinct {(hist > 0).sum()} "
                  f"top code share {hist.max() / hist.sum():.3f}")
