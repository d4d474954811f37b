"""PyTorch port: ``ops/resize.resize_bilinear`` against the JAX function, bit for bit.

The GAN generator resizes its dequantized blocks' output 64 -> 128 and
128 -> 256 (align_corners) before a QuantStub, so one ulp can move a code.
The port writes XLA's CPU dot as ``fma(w_hi, x_hi, w_lo * x_lo)``; at those
sizes (and at 32 -> 64) XLA's dot gives exactly that. Tolerance: none.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frostnet_tpu.ops.resize import _linear_matrix as jax_linear_matrix
from frostnet_tpu.ops.resize import resize_bilinear as jax_resize
from frostnet_tpu_torch.ops.resize import _linear_matrix, resize_bilinear


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
