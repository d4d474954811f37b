"""PyTorch port, INT8 serving of the GAN generator against JAX ``freeze()``.

A small ResnetGenerator (ngf 32, so its blocks are 128 channels wide; two
blocks; 128x128 images, so that the resizes are 32 -> 64 and 64 -> 128,
sizes at which XLA's CPU dot rounds as at full width) is initialized and
calibrated in JAX, written as an ``export_int8`` artifact and served by
``serve.GanPredictor`` on the CPU; the calibrated variables themselves are
also carried across with ``from_jax_variables`` (BN folded at freeze). Every
layer's INT8 codes must be bit-identical to the frozen JAX graph's; the
float tail (a float32 7x7 conv and tanh) may differ by ``TAIL_BAND`` after
tanh: XLA runs it through its space-to-depth route,
torch through one conv, and the two sum in other orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import calibrated_gan_variables, jax_layer_codes
from chip_smoke import gan_images
from frostnet_tpu.gan.networks import ResnetGenerator as JaxGenerator
from frostnet_tpu.gan.networks import define_g as jax_define_g
from frostnet_tpu.quant import export_int8
from frostnet_tpu.quant import freeze as jax_freeze
from frostnet_tpu.quant import load_int8 as jax_load_int8
from frostnet_tpu_torch import ops
from frostnet_tpu_torch.gan import ResnetGenerator, define_g
from frostnet_tpu_torch.nn import INT8
from frostnet_tpu_torch.quant import freeze, from_jax_variables, model_variables
from frostnet_tpu_torch.serve import GanPredictor

NGF, N_BLOCKS, SIZE, BATCH = 32, 2, 128, 2
# float32 tail after tanh, absolute: measured 2.3e-6 here (the largest
# difference over both images)
TAIL_BAND = 1e-5
LAYERS = (["quant", "stem", "down0", "down1"] + [f"block{i}" for i in range(N_BLOCKS)]
          + ["requant_up0", "up0", "requant_up1", "up1"])


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    model = JaxGenerator(3, NGF, N_BLOCKS)
    variables = calibrated_gan_variables(model, BATCH, SIZE)
    path = str(tmp_path_factory.mktemp("gan") / "netG_int8.npz")
    export_int8(variables, path)
    served = jax_load_int8(path)
    images = gan_images(0, BATCH, SIZE)
    want = np.asarray(jax_freeze(model, served)(jnp.asarray(images)))
    recorded, codes = jax_layer_codes(model, served, jnp.asarray(images))
    np.testing.assert_array_equal(recorded, want)
    assert sorted(codes) == sorted(LAYERS)
    return dict(model=model, variables=variables, path=path, images=images, want=want,
                codes=codes)


class _Small(GanPredictor):
    """GanPredictor of the small generator (define_g has 6 or 9 blocks)."""

    def __init__(self, path):
        from frostnet_tpu_torch.quant import load_int8

        self.device, self.image_size = torch.device("cpu"), SIZE
        self.model = ResnetGenerator(3, NGF, N_BLOCKS)
        from_jax_variables(self.model, load_int8(path))
        self._apply = freeze(self.model, "cpu", SIZE)


def test_every_layer_bit_exact_and_output_in_band(reference):
    from chip_smoke import layer_codes

    images, want, jcodes = reference["images"], reference["want"], reference["codes"]
    pred = _Small(reference["path"])
    ops.reset_launch_counts()
    out, codes = layer_codes(pred, images)
    assert set(ops.launch_counts().values()) == {0}  # CPU tensors launch nothing
    assert sorted(codes) == sorted(LAYERS)
    for layer in LAYERS:
        np.testing.assert_array_equal(codes[layer].numpy(), jcodes[layer], err_msg=layer)
        hist = np.bincount(jcodes[layer].ravel(), minlength=256)
        assert (hist > 0).sum() >= 32 and hist.max() <= hist.sum() // 2, layer
    assert out.dtype == torch.float32 and out.shape == want.shape
    err = float(np.abs(out.numpy() - want).max())
    assert err <= TAIL_BAND, err
    assert np.abs(want[0] - want[1]).max() > 0.1  # the images differ


def test_calibrated_variables_fold_at_freeze(reference):
    """from_jax_variables on the calibrated tree (BN not folded): the port
    folds at freeze as XLA folds the frozen JAX graph."""
    images = reference["images"][:1]
    want = np.asarray(jax_freeze(reference["model"], reference["variables"])(
        jnp.asarray(images)))
    port = from_jax_variables(ResnetGenerator(3, NGF, N_BLOCKS), reference["variables"])
    got = freeze(port, "cpu", SIZE)(images).numpy()
    assert np.abs(got - want).max() <= TAIL_BAND


def test_routes_per_conv(reference):
    port = _Small(reference["path"]).model
    routes = {name: mod._route for name, mod in port.named_modules() if hasattr(mod, "_route")}
    want = {"stem": "im2col", "down0": "im2col", "down1": "im2col",
            "up0": "dense3x3", "up1": "dense3x3"}
    want.update({f"block{i}.conv{j}": "dense3x3" for i in range(N_BLOCKS) for j in (1, 2)})
    assert routes == want
    assert not port.tail.quantized and not hasattr(port.tail, "w_obs")


@pytest.mark.parametrize("net_g,blocks", [("resnet_6blocks", 6), ("resnet_9blocks", 9)])
def test_factory_variables_match_jax(net_g, blocks):
    import jax

    port = define_g(ngf=8, netG=net_g)
    assert len(port.blocks) == blocks
    shapes = jax.eval_shape(jax_define_g(ngf=8, netG=net_g).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3), jnp.float32))
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        names = [getattr(p, "key", getattr(p, "name", None)) for p in path]
        key = (f"quant/{'/'.join(names[1:-1])}.{names[-1]}" if names[0] == "quant"
               else "/".join(names))
        want[key] = tuple(leaf.shape)
    assert {k: tuple(v.shape) for k, v in model_variables(port).items()} == want


def test_factory_and_modes_refuse_what_is_not_ported():
    with pytest.raises(ValueError):
        define_g(netG="unet_256")
    from frostnet_tpu_torch.nn import FP32

    port = define_g(ngf=8)
    # the float and QAT modes are ported (the GAN training slice): FP32 runs
    assert port(torch.zeros(1, 32, 32, 3), FP32).shape == (1, 32, 32, 3)
    with pytest.raises(RuntimeError):
        port(torch.zeros(1, 32, 32, 3), INT8)  # not frozen yet
