"""The committed full-width GAN fixture of the PyTorch port.

``frostnet_tpu_torch/testdata`` holds what the JAX package makes for the
pix2pix/CycleGAN generator ``define_g(netG="resnet_9blocks", ngf=64)``
(qnnpack) at 256x256, so that ``chip_smoke.py`` can hold the port against
the reference on the GPU without JAX:

* ``resnet_9blocks_int8.npz``: the ``export_int8`` artifact of the generator
  after random init (``PRNGKey(0)``) and a calibration on seeded numpy
  images in [-1, 1] (``tests/_torch_port.calibrated_gan_variables``: BN
  shifts drawn from numpy, BN running statistics as the mean batch
  statistics of two float forwards in train mode, observers from two QAT
  forwards in eval mode).
* ``resnet_9blocks_reference.npz``: for the batch ``gan_images(0, 4, 256)``
  (``np.random.RandomState(0).uniform(-1, 1, ...)``), the frozen JAX
  graph's float output for the first two images (``output``) and, for each
  layer whose INT8 codes it computes (``quant``, ``stem``, ``down0``,
  ``down1``, ``block0..8``, ``requant_up0``, ``up0``, ``requant_up1``,
  ``up1``): ``sha256/<layer>``, the SHA-256 of each image's codes (NHWC,
  uint8), ``shape/<layer>`` and ``hist/<layer>``, the histogram of the 256
  codes.

Regenerate with ``python tests/test_torch_gan_fixture.py`` (a few CPU
minutes); under pytest this file checks the fixture's keys, shapes and
spread, and serves its first image through the port on the CPU, layer by
layer, against the digests.
"""
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(ROOT, "frostnet_tpu_torch", "testdata")
NET_G = "resnet_9blocks"
ARTIFACT = os.path.join(TESTDATA, f"{NET_G}_int8.npz")
REFERENCE = os.path.join(TESTDATA, f"{NET_G}_reference.npz")
IMAGE_SIZE, BATCH, N_OUTPUT = 256, 4, 2
LAYERS = (["quant", "stem", "down0", "down1"] + [f"block{i}" for i in range(9)]
          + ["requant_up0", "up0", "requant_up1", "up1"])
# the float32 tail after tanh, absolute: measured 5.8e-6 on the first image
TAIL_BAND = 3e-5


def make_fixture():
    import jax.numpy as jnp
    import torch

    from _torch_port import calibrated_gan_variables, jax_layer_codes
    from chip_smoke import code_digests, gan_images
    from frostnet_tpu.gan.networks import define_g
    from frostnet_tpu.quant import export_int8, freeze, load_int8

    model = define_g(netG=NET_G)
    variables = calibrated_gan_variables(model, BATCH, IMAGE_SIZE)
    os.makedirs(TESTDATA, exist_ok=True)
    export_int8(variables, ARTIFACT)

    images = jnp.asarray(gan_images(0, BATCH, IMAGE_SIZE))
    served = load_int8(ARTIFACT)
    output = np.asarray(freeze(model, served)(images))
    recorded, codes = jax_layer_codes(model, served, images)
    np.testing.assert_array_equal(recorded, output)
    assert sorted(codes) == sorted(LAYERS)
    layers = {}
    for k, v in codes.items():
        layers[f"sha256/{k}"] = np.asarray(code_digests(torch.as_tensor(v)))
        layers[f"shape/{k}"] = np.asarray(v.shape, np.int64)
        layers[f"hist/{k}"] = np.bincount(v.ravel(), minlength=256).astype(np.int64)
    np.savez(REFERENCE, output=output[:N_OUTPUT], image_seed=np.int64(0),
             image_shape=np.asarray(images.shape, np.int64), **layers)
    return output, codes


def load_reference():
    with np.load(REFERENCE) as data:
        return {k: data[k] for k in data.files}


def test_fixture_keys_and_shapes():
    import jax
    import jax.numpy as jnp

    from frostnet_tpu.gan.networks import define_g

    with np.load(ARTIFACT) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        keys = set(data.files) - {"__meta__"}
        kernels = {k: data[k] for k in keys if k.endswith("/kernel")}
        got = {k: data[k].shape for k in keys}
    assert meta["qconfig"] == "qnnpack"
    assert kernels.pop("params/tail/kernel").dtype == np.float32  # the float tail
    assert all(v.dtype == np.int8 for v in kernels.values())
    assert 11.3e6 < sum(v.size for v in kernels.values()) < 11.5e6

    shapes = jax.eval_shape(define_g(netG=NET_G).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3), jnp.float32))
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        names = [getattr(p, "key", getattr(p, "name", None)) for p in path]
        key = (f"quant/{'/'.join(names[1:-1])}.{names[-1]}" if names[0] == "quant"
               else "/".join(names))
        want[key] = leaf.shape
    assert got == want

    ref = load_reference()
    assert tuple(ref["image_shape"]) == (BATCH, IMAGE_SIZE, IMAGE_SIZE, 3)
    assert int(ref["image_seed"]) == 0
    out = ref["output"]
    assert out.shape == (N_OUTPUT, IMAGE_SIZE, IMAGE_SIZE, 3) and out.dtype == np.float32
    assert np.isfinite(out).all() and np.abs(out).max() <= 1.0
    for layer in LAYERS:
        shape = tuple(ref[f"shape/{layer}"])
        assert shape[0] == BATCH and len(shape) == 4
        assert ref[f"sha256/{layer}"].shape == (BATCH,)
        assert ref[f"hist/{layer}"].sum() == np.prod(shape)
    assert len([k for k in ref if k.startswith("sha256/")]) == len(LAYERS)


def test_fixture_is_spread():
    """The checks on the card are only as strong as the codes are varied:
    no layer may saturate, and the images must differ."""
    ref = load_reference()
    for layer in LAYERS:
        hist = ref[f"hist/{layer}"]
        assert (hist > 0).sum() >= 32, layer
        assert hist.max() <= hist.sum() // 2, layer
        assert len(set(ref[f"sha256/{layer}"])) == BATCH, layer
    out = ref["output"]
    assert np.abs(out[0] - out[1]).max() > 0.1 and out.std() > 0.01


def test_port_matches_fixture_layer_by_layer():
    """The port on the CPU (the kernels' plain versions) against the frozen
    JAX graph's committed codes and output, for the first image."""
    from chip_smoke import code_digests, gan_images, layer_codes
    from frostnet_tpu_torch.serve import GanPredictor

    ref = load_reference()
    pred = GanPredictor(NET_G, artifact=ARTIFACT, image_size=IMAGE_SIZE, device="cpu")
    out, codes = layer_codes(pred, gan_images(0, BATCH, IMAGE_SIZE)[:1])
    for layer in LAYERS:
        assert tuple(codes[layer].shape[1:]) == tuple(ref[f"shape/{layer}"][1:]), layer
        assert code_digests(codes[layer]) == list(ref[f"sha256/{layer}"][:1]), layer
    assert np.abs(out.numpy() - ref["output"][:1]).max() <= TAIL_BAND


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import jax

    jax.config.update("jax_platforms", "cpu")
    out, codes = make_fixture()
    print("output", out.shape, "range", float(out.min()), float(out.max()))
    for name in LAYERS:
        c = codes[name]
        hist = np.bincount(c.ravel(), minlength=256)
        print(f"{name:12s} {c.shape} distinct {(hist > 0).sum()} "
              f"top code share {hist.max() / hist.sum():.3f}")
