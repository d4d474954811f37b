"""The committed full-width fixture of the PyTorch port.

``frostnet_tpu_torch/testdata`` holds what the JAX package makes for
``frostnet_quant_large_1_0`` (qnnpack) at 224x224, so that ``chip_smoke.py``
can hold the port against the reference on the GPU without JAX:

* ``frostnet_quant_large_1_0_int8.npz``: the ``export_int8`` artifact of the
  model after random init (``PRNGKey(0)``) and a calibration on seeded numpy
  images. Each BN's running statistics are the mean, over ``BN_FORWARDS``
  float forwards in train mode, of the batch statistics, read back through
  the momentum update from zeroed running statistics. The observers then
  see two QAT forwards in eval mode, so that each one is calibrated on the
  activations of the folded graph that ``freeze`` serves. (Running
  statistics that are still mostly their initial values, as after a few
  momentum steps, leave per-channel offsets in the folded graph that swamp
  the signal: every image pools to the same codes and gets one answer.)
* ``frostnet_quant_large_1_0_reference.npz``: for the batch
  ``np.random.RandomState(0).randn(8, 224, 224, 3)``, the ``freeze()``
  logits, and for each layer whose INT8 codes the frozen JAX graph computes
  (the QuantStub output ``quant``, the stem ``conv1``, the 18 blocks,
  ``last_layer``, and ``pool``, the pooled codes the classifier reads):
  ``sha256/<layer>``, the SHA-256 of each image's codes (NHWC, uint8),
  ``shape/<layer>`` and ``hist/<layer>``, the histogram of the 256 codes.
  The digests let a run hold every code of every layer against the
  reference at the size of a checksum.

Regenerate with ``python tests/test_torch_fixture.py``; under pytest this
file checks the fixture's keys, shapes and spread, and serves its first
images through the port on the CPU, layer by layer.
"""
import json
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(ROOT, "frostnet_tpu_torch", "testdata")
MODEL = "frostnet_quant_large_1_0"
ARTIFACT = os.path.join(TESTDATA, f"{MODEL}_int8.npz")
REFERENCE = os.path.join(TESTDATA, f"{MODEL}_reference.npz")
IMAGE_SIZE, BATCH = 224, 8
BLOCKS = ([f"layer1_{i}" for i in range(3)] + [f"layer2_{i}" for i in range(2)]
          + [f"layer3_{i}" for i in range(7)] + [f"layer4_{i}" for i in range(5)]
          + ["layer5_0"])
LAYERS = ["quant", "conv1"] + BLOCKS + ["last_layer", "pool"]
BN_FORWARDS = 4


def _jax_model():
    from frostnet_tpu.models import create_model

    return create_model(MODEL)


def jax_reference_codes(model, variables, images):
    """(logits, {layer: u8 codes}) of the frozen INT8 graph on ``images``:
    ``freeze``'s program with the top-level modules' outputs (and the
    classifier's input, the pooled codes) recorded as extra outputs."""
    import flax.linen as fnn
    import jax

    from frostnet_tpu import nn as fnn_q

    def fn(x):
        codes = {}

        def record(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            path = context.module.scope.path
            if context.method_name == "__call__" and len(path) == 1:
                if path[0] == "classifier":
                    codes["pool"] = args[0].q
                elif path[0] in LAYERS:
                    codes[path[0]] = out.q
            return out

        with fnn.intercept_methods(record):
            logits = model.apply(variables, x, mode=fnn_q.INT8)
        return logits, codes

    logits, codes = jax.jit(fn)(images)
    return np.asarray(logits), {k: np.asarray(v) for k, v in codes.items()}


def make_fixture():
    import jax
    import jax.numpy as jnp

    from frostnet_tpu import nn as fnn_q
    from frostnet_tpu.quant import export_int8, freeze, load_int8

    from frostnet_tpu.nn.conv import QConvBNAct

    model = _jax_model()
    key = jax.random.PRNGKey(0)
    rng = np.random.RandomState(1)
    shape = (BATCH, IMAGE_SIZE, IMAGE_SIZE, 3)
    variables = jax.jit(model.init)(key, jnp.zeros(shape, jnp.float32))

    def draw():
        return jnp.asarray(rng.randn(*shape).astype(np.float32))

    m = QConvBNAct.bn_momentum
    zeroed = jax.tree.map(jnp.zeros_like, variables["batch_stats"])
    bn_forward = jax.jit(lambda v, xb: model.apply(
        {**v, "batch_stats": zeroed}, xb, mode=fnn_q.FP32, train=True,
        mutable=["batch_stats"], rngs={"dropout": key})[1]["batch_stats"])
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
    os.makedirs(TESTDATA, exist_ok=True)
    export_int8(variables, ARTIFACT)

    images = np.random.RandomState(0).randn(*shape).astype(np.float32)
    served = load_int8(ARTIFACT)
    logits = np.asarray(freeze(model, served)(jnp.asarray(images)))
    recorded, codes = jax_reference_codes(model, served, jnp.asarray(images))
    np.testing.assert_array_equal(recorded, logits)
    assert sorted(codes) == sorted(LAYERS)
    import torch

    from chip_smoke import code_digests

    layers = {}
    for k, v in codes.items():
        layers[f"sha256/{k}"] = np.asarray(code_digests(torch.as_tensor(v)))
        layers[f"shape/{k}"] = np.asarray(v.shape, np.int64)
        layers[f"hist/{k}"] = np.bincount(v.ravel(), minlength=256).astype(np.int64)
    np.savez(REFERENCE, logits=logits, image_seed=np.int64(0),
             image_shape=np.asarray(shape, np.int64), **layers)
    return logits, codes


def load_reference():
    with np.load(REFERENCE) as data:
        return {k: data[k] for k in data.files}


def test_fixture_keys_and_shapes():
    import jax
    import jax.numpy as jnp

    from frostnet_tpu.quant.export import load_int8

    with np.load(ARTIFACT) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        keys = set(data.files) - {"__meta__"}
        kernels = {k: data[k] for k in keys if k.endswith("/kernel")}
    assert meta["qconfig"] == "qnnpack"
    assert all(v.dtype == np.int8 for v in kernels.values())
    assert 5.7e6 < sum(v.size for v in kernels.values()) < 5.9e6

    shapes = jax.eval_shape(_jax_model().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, IMAGE_SIZE, IMAGE_SIZE, 3), jnp.float32))
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        names = [getattr(p, "key", getattr(p, "name", None)) for p in path]
        if names[0] == "quant":
            want[f"quant/{'/'.join(names[1:-1])}.{names[-1]}"] = leaf.shape
        else:
            want["/".join(names)] = leaf.shape
    with np.load(ARTIFACT) as data:
        got = {k: data[k].shape for k in keys}
    assert got == want
    tree = load_int8(ARTIFACT)
    assert set(tree) == {"params", "batch_stats", "quant"}

    ref = load_reference()
    assert tuple(ref["image_shape"]) == (BATCH, IMAGE_SIZE, IMAGE_SIZE, 3)
    assert int(ref["image_seed"]) == 0
    logits = ref["logits"]
    assert logits.shape == (BATCH, 1000) and logits.dtype == np.float32
    assert np.isfinite(logits).all()
    for layer in LAYERS:
        shape = tuple(ref[f"shape/{layer}"])
        assert shape[0] == BATCH and len(shape) == 4
        assert ref[f"sha256/{layer}"].shape == (BATCH,)
        assert ref[f"hist/{layer}"].sum() == np.prod(shape)
    assert len([k for k in ref if k.startswith("sha256/")]) == len(LAYERS)


def test_fixture_logits_are_spread():
    """The logits check on the card is only as strong as the logits are
    varied: no layer may saturate the fixture into a constant answer."""
    ref = load_reference()
    logits = ref["logits"]
    # the classifier's u8 codes allow at most 256 distinct logits
    assert len(np.unique(logits)) > 128
    assert len(set(logits.argmax(axis=1).tolist())) > 1
    for layer in LAYERS:
        hist = ref[f"hist/{layer}"]
        assert (hist > 0).sum() > 16, layer
        # neither clip end holds most of a layer's codes
        assert hist[255] < 0.5 * hist.sum() and hist[0] < 0.9 * hist.sum(), layer
        # and the images differ
        assert len(set(ref[f"sha256/{layer}"])) == BATCH, layer


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
def test_port_matches_fixture_layer_by_layer(fuse):
    """The port on the CPU (the kernels' plain versions) against the frozen
    JAX graph's committed codes, for the first two images of the batch."""
    from chip_smoke import code_digests, layer_codes
    from frostnet_tpu_torch.serve import Int8Predictor

    ref = load_reference()
    images = np.random.RandomState(0).randn(BATCH, IMAGE_SIZE, IMAGE_SIZE, 3)
    pred = Int8Predictor(MODEL, artifact=ARTIFACT, fuse_int8=fuse, device="cpu")
    logits, codes = layer_codes(pred, images.astype(np.float32)[:2])
    for layer in LAYERS:
        assert tuple(codes[layer].shape[1:]) == tuple(ref[f"shape/{layer}"][1:]), layer
        assert code_digests(codes[layer]) == list(ref[f"sha256/{layer}"][:2]), layer
    np.testing.assert_array_equal(logits.numpy(), ref["logits"][:2])


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    out, codes = make_fixture()
    print("logits", out.shape, "distinct", len(np.unique(out)),
          "argmax", out.argmax(axis=1).tolist())
    for name in LAYERS:
        c = codes[name]
        print(f"{name:11s} {c.shape} distinct {len(np.unique(c))} "
              f"at 0 {(c == 0).mean():.3f} at 255 {(c == 255).mean():.3f}")
