"""PyTorch port: ``ops/resize.resize_bilinear`` against the JAX function, bit for bit.

The GAN generator resizes its dequantized blocks' output 64 -> 128 and
128 -> 256 (align_corners) before a QuantStub, so one ulp can move a code.
The port writes XLA's CPU dot as ``fma(w_hi, x_hi, w_lo * x_lo)`` where
the pass's output side is a multiple of 64 and as separately rounded
products and sum elsewhere (read from XLA's output); at the GAN's sizes
(and at 32 -> 64) and at each resize of the segmentation models (the
LR-ASPP head's c4 -> c1 and the float tail's to the input size, at the
crops 768, 96 and 64, for MobileNetV3 and MobileNetV2; ESPNetv2's pyramid
and decoder resizes and ESPNet's 2x ones at the crop 768) XLA's dot gives
exactly that, and the other form would not. Tolerance: none.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frostnet_tpu.ops.resize import _linear_matrix as jax_linear_matrix
from frostnet_tpu.ops.resize import resize_bilinear as jax_resize
from frostnet_tpu_torch.ops.requant import fma_f32
from frostnet_tpu_torch.ops.resize import _linear_matrix, _taps, resize_bilinear


def _inputs(kind, n, c, seed):
    rng = np.random.RandomState(seed)
    if kind == "randn":
        return (rng.randn(2, n, n, c) * 3).astype(np.float32)
    q = rng.randint(0, 256, (2, n, n, c)).astype(np.float32)
    return (q - np.float32(131)) * np.float32(0.0412832908)


@pytest.mark.parametrize("kind", ["randn", "dequantized"])
@pytest.mark.parametrize("n,c", [(32, 16), (64, 8), (128, 4)])
def test_resize_bilinear_is_bit_exact(n, c, kind):
    x = _inputs(kind, n, c, n)
    want = np.asarray(jax.jit(lambda a: jax_resize(a, (2 * n, 2 * n), True))(jnp.asarray(x)))
    got = resize_bilinear(torch.as_tensor(x), (2 * n, 2 * n), True).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_interpolation_matrix_is_the_reference_one():
    for n_in, n_out, ac in [(64, 128, True), (128, 256, True), (7, 3, False), (5, 1, True)]:
        np.testing.assert_array_equal(_linear_matrix(n_in, n_out, ac),
                                      jax_linear_matrix(n_in, n_out, ac))


# (n_in, n_out, channels, batch, XLA's form): the segmentation models' resizes
SEG_RESIZES = [(48, 96, 128, 2, "separate"), (96, 768, 19, 1, "fma"),      # crop 768, V3
               (6, 12, 128, 2, "separate"), (12, 96, 19, 2, "separate"),    # crop 96, V3
               (4, 8, 128, 2, "separate"), (8, 64, 19, 2, "fma"),           # crop 64, V3
               (48, 192, 128, 1, "fma"), (192, 768, 19, 1, "fma"),          # crop 768, V2
               (6, 24, 128, 2, "separate"), (24, 96, 19, 2, "separate"),    # crop 96, V2
               # crop 768: ESPNetv2 (s 2.0) PSP's four stages and proj_L4_C to
               # l3's 96, its decoder's 96 -> 192 and 192 -> 384 and the tail's
               # 384 -> 768; ESPNet's up2 96 -> 192 -> 384 and its tail's 384 -> 768
               (48, 96, 256, 1, "separate"), (24, 96, 256, 1, "separate"),
               (12, 96, 256, 1, "separate"), (6, 96, 256, 1, "separate"),
               (96, 192, 19, 1, "fma"), (192, 384, 19, 1, "fma"), (384, 768, 19, 1, "fma"),
               (96, 192, 20, 1, "fma"), (192, 384, 20, 1, "fma"), (384, 768, 20, 1, "fma")]


def _other_form(x, n_out, form):
    """The resize with each pass rounded the other way."""
    y = torch.as_tensor(x)
    for dim in (1, 2):
        lo, hi, w_lo, w_hi = _taps(y.shape[dim], n_out, True)
        shape = [1, 1, 1, 1]
        shape[dim] = n_out
        a = y.index_select(dim, torch.as_tensor(lo))
        b = y.index_select(dim, torch.as_tensor(hi))
        wl, wh = torch.as_tensor(w_lo).reshape(shape), torch.as_tensor(w_hi).reshape(shape)
        y = a * wl + b * wh if form == "fma" else fma_f32(b, wh, a * wl)
    return y.numpy()


@pytest.mark.parametrize("case", SEG_RESIZES, ids=lambda c: f"{c[0]}to{c[1]}x{c[2]}")
def test_resize_bilinear_seg_sizes_pinned(case):
    n, n_out, c, b, form = case
    x = (np.random.RandomState(n_out + c).randn(b, n, n, c) * 3).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jax_resize(a, (n_out, n_out), True))(jnp.asarray(x)))
    got = resize_bilinear(torch.as_tensor(x), (n_out, n_out), True).numpy()
    np.testing.assert_array_equal(got, want)
    assert (n_out % 64 == 0) == (form == "fma")
    assert not np.array_equal(_other_form(x, n_out, form), want)


def test_resize_from_one_pixel_is_a_broadcast():
    """The LR-ASPP gate's pooled map is 1x1 at every crop: its resize gives
    the value itself at every output (weight 1, the other tap 0)."""
    x = (np.random.RandomState(3).randn(2, 1, 1, 128) * 3).astype(np.float32)
    for n_out in (4, 6, 12, 48):
        got = resize_bilinear(torch.as_tensor(x), (n_out, n_out), True).numpy()
        np.testing.assert_array_equal(got, np.broadcast_to(x, got.shape))
        want = np.asarray(jax.jit(lambda a: jax_resize(a, (n_out, n_out), True))(jnp.asarray(x)))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_out", [64, 48], ids=["fma", "separate"])
def test_resize_gradient_is_the_interpolations(n_out):
    """The segmentation tail trains through the resize: its gradient is the
    interpolation's transpose on either rounding form (the fused form's
    round-to-odd step is an exact offset outside autograd)."""
    x = torch.randn(2, 8, 8, 3, generator=torch.Generator().manual_seed(1), requires_grad=True)
    g = torch.randn(2, n_out, n_out, 3, generator=torch.Generator().manual_seed(2))
    resize_bilinear(x, (n_out, n_out), True).backward(g)
    x64 = x.detach().to(torch.float64).requires_grad_(True)
    m = torch.as_tensor(_linear_matrix(8, n_out, True)).to(torch.float64)
    y = torch.einsum("oh,nhwc->nowc", m, x64)
    torch.einsum("pw,nowc->nopc", m, y).backward(g.to(torch.float64))
    np.testing.assert_allclose(x.grad.numpy(), x64.grad.numpy(), rtol=1e-5, atol=1e-5)
