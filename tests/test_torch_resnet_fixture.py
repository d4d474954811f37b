"""The committed full-width ResNet fixtures of the PyTorch port.

For ``qresnet18`` and ``qresnet50`` (qnnpack, 224x224, 1000 classes, full
width and depth) ``frostnet_tpu_torch/testdata`` holds what the JAX package
computes from weights both packages can make, as the MobileNet fixtures do
(``tests/test_torch_mobilenet_fixture.py``), so that ``chip_smoke.py`` can hold
the port against the reference on the GPU without JAX:

* ``<model>_calibration.npz``: on top of ``numpy_init(model, 0)``, each BN's
  shift (``params/.../bias_bn``, drawn from ``N(BN_SHIFT)`` with
  ``RandomState(1)`` in key order), each BN's running statistics (the mean,
  over ``BN_FORWARDS`` float forwards in train mode, of the batch
  statistics) and every observer (two QAT forwards in eval mode), as flat
  JAX keys. The images are ``RandomState(2).randn``.
* ``<model>_reference.npz``: for the batch ``RandomState(0).randn(8, 224,
  224, 3)``, the frozen JAX graph's logits and, for each top-level layer
  whose INT8 codes it computes (and ``pool``, the ``fc``'s input codes),
  ``sha256/<layer>`` (per image), ``shape/<layer>`` and ``hist/<layer>``;
  and for each block, ``forms/<layer>``: how many of the block's
  ``add_relu`` codes differ from JAX's when the add rounds each product and
  the sum on its own, when its first product is contracted into an FMA, and
  when its second is (from the port's own codes of the block inputs).

Regenerate with ``python tests/test_torch_resnet_fixture.py`` (a few CPU
minutes). Under pytest this file checks the fixtures' keys and spread, that
the rounding the port freezes each residual add with gives JAX's codes at
full width, and serves the first image of each through the port on the CPU,
layer by layer, against the digests.
"""
import os
import sys
import tempfile

import numpy as np
import pytest

from _torch_port import few_threads  # noqa: F401 - a fixture

pytestmark = pytest.mark.usefixtures("few_threads")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(ROOT, "frostnet_tpu_torch", "testdata")
MODELS = ("qresnet18", "qresnet50")
IMAGE_SIZE, BATCH, BN_FORWARDS = 224, 8, 4
BN_SHIFT = (0.5, 0.5)  # mean and std of the BN shifts


def _paths(name):
    return (os.path.join(TESTDATA, f"{name}_calibration.npz"),
            os.path.join(TESTDATA, f"{name}_reference.npz"))


def add_relu_forms(pred, images):
    """``{block: (codes, codes, codes)}``: each ``QAddReLU`` of the port's
    frozen model on ``images``, recomputed from its input codes three ways:
    no product contracted, the first product contracted into an FMA, the
    second."""
    import torch

    from frostnet_tpu_torch.nn import QAddReLU
    from frostnet_tpu_torch.ops.requant import fma_f32

    out, hooks = {}, []

    def keep(name):
        def hook(mod, args, _):
            (sa, za), (sb, zb) = mod._in
            spec = mod.qconfig.activation
            xa = args[0].q.to(torch.float32) - float(za)
            xb = args[1].q.to(torch.float32) - float(zb)
            ta, tb = torch.full_like(xa, sa), torch.full_like(xb, sb)
            mult = torch.tensor(mod._mult, dtype=torch.float32)

            def codes(y):
                y = torch.clamp(y, min=0.0) * mult
                return torch.clamp(torch.round(y) + mod._out.zero_point, spec.qmin,
                                   spec.qmax).to(torch.uint8)

            out[name] = (codes(xa * ta + xb * tb), codes(fma_f32(xa, ta, xb * tb)),
                         codes(fma_f32(xb, tb, xa * ta)))
        return hook

    for name, mod in pred.model.named_modules():
        if isinstance(mod, QAddReLU):
            hooks.append(mod.register_forward_hook(keep(name.split(".")[0])))
    try:
        pred(images)
    finally:
        for h in hooks:
            h.remove()
    return out


def make_fixture(name):
    import jax
    import jax.numpy as jnp
    import torch

    from _torch_port import jax_variables
    from chip_smoke import code_digests, mobilenet_predictor
    from frostnet_tpu import nn as fnn_q
    from frostnet_tpu.models import create_model as jax_create_model
    from frostnet_tpu.nn.conv import QConvBNAct
    from frostnet_tpu.quant import export_int8, freeze, load_int8
    from frostnet_tpu_torch.models import create_model
    from frostnet_tpu_torch.quant import numpy_init
    from frostnet_tpu_torch.quant.export import flatten_variables, unflatten_variables
    from test_torch_mobilenet_fixture import jax_reference_codes

    flat = flatten_variables(numpy_init(create_model(name), 0))
    rng = np.random.RandomState(1)
    for k in sorted(flat):
        if k.endswith("/bias_bn"):
            flat[k] = rng.normal(*BN_SHIFT, flat[k].shape).astype(np.float32)
    variables = jax_variables(unflatten_variables(flat))
    model = jax_create_model(name)
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
    pred = mobilenet_predictor(name, device="cpu")
    for k, forms in add_relu_forms(pred, images).items():
        layers[f"forms/{k}"] = np.asarray([int((f.numpy() != codes[k]).sum()) for f in forms],
                                          np.int64)
    np.savez(reference, logits=logits, image_seed=np.int64(0),
             image_shape=np.asarray(shape, np.int64), **layers)
    return logits, codes, {k[len("forms/"):]: v for k, v in layers.items()
                           if k.startswith("forms/")}


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
    blocks = 8 if name == "qresnet18" else 16
    assert set(layers) == {"quant", "stem", "pool"} | {k[len("forms/"):] for k in ref
                                                       if k.startswith("forms/")}
    assert len(layers) == 3 + blocks
    for layer in layers:
        hist = ref[f"hist/{layer}"]
        assert (hist > 0).sum() >= 16, layer
        assert hist.max() <= 0.75 * hist.sum(), layer
        assert len(set(ref[f"sha256/{layer}"])) == BATCH, layer
    logits = ref["logits"]
    assert logits.shape == (BATCH, 1000) and np.isfinite(logits).all()
    assert len(np.unique(logits)) > 100 and len({r.tobytes() for r in logits}) == BATCH


@pytest.mark.parametrize("name", MODELS)
def test_add_relu_rounding_at_full_width(name):
    """At every block of the full-width models (8 images), the rounding the
    port freezes the join with (``QAddReLU._contract``: none, or the product
    of the operand read from memory) gives JAX's codes everywhere, while some
    other rounding would have moved codes: the fixture can tell the forms
    apart (few codes lie that close to a rounding boundary: 4 of
    qresnet18's 6.0 M join codes, 17 of qresnet50's 44.2 M)."""
    from chip_smoke import mobilenet_predictor
    from frostnet_tpu_torch.nn import QAddReLU

    ref = load(_paths(name)[1])
    forms = {k[len("forms/"):]: ref[k] for k in ref if k.startswith("forms/")}
    pred = mobilenet_predictor(name, device="cpu")
    contract = {n.split(".")[0]: m._contract for n, m in pred.model.named_modules()
                if isinstance(m, QAddReLU)}
    assert sorted(contract) == sorted(forms) and len(forms) == (8 if name == "qresnet18" else 16)
    mine = {k: 0 if c is None else c + 1 for k, c in contract.items()}
    assert all(int(v[mine[k]]) == 0 for k, v in forms.items()), (forms, contract)
    assert sum(int(v.sum()) for v in forms.values()) > 0, forms


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
        out, codes, forms = make_fixture(name)
        print(name, "logits", out.shape, "distinct", len(np.unique(out)),
              "argmax", out.argmax(axis=1).tolist())
        for layer in sorted(codes):
            c = codes[layer]
            hist = np.bincount(c.ravel(), minlength=256)
            print(f"  {layer:11s} {c.shape} distinct {(hist > 0).sum()} "
                  f"top code share {hist.max() / hist.sum():.3f} "
                  f"add_relu forms (none, fma first, fma second) {forms.get(layer)}")
