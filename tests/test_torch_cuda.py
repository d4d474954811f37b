"""PyTorch port on the GPU: each CUDA kernel against its plain torch version.

Every test here needs a CUDA card and nvcc (marker ``cuda``) and skips on a
CPU-only host. The file imports no JAX, so on a GPU machine without JAX it
runs on its own:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

chip_smoke.py runs the same checks at every shape of the model's main path.
"""
import numpy as np
import pytest
import torch

from _torch_port import cuda_device  # noqa: F401  (fixture)
from frostnet_tpu_torch.ops import frost_block as tfb
from frostnet_tpu_torch.ops.int8_matmul import (conv1x1_operands, int8_matmul_requant,
                                                int8_matmul_requant_plain)

pytestmark = pytest.mark.cuda

MATMUL_SHAPES = [(256, 136, 816), (100, 24, 144), (17, 8, 40),
                 (100352, 27, 32), (392, 320, 1280), (8, 1280, 1000)]

BLOCKS = [
    dict(h=14, w=14, cin=96, cout=96, kernel=5, stride=1, has_squeeze=True,
         has_expand=True, c_sq=24, c_e=360, residual=True),
    dict(h=28, w=28, cin=40, cout=80, kernel=5, stride=2, has_squeeze=True,
         has_expand=True, c_sq=16, c_e=336, residual=False),
    dict(h=56, w=56, cin=24, cout=24, kernel=3, stride=1, has_squeeze=False,
         has_expand=True, c_sq=0, c_e=144, residual=True),
    dict(h=32, w=32, cin=16, cout=16, kernel=3, stride=1, has_squeeze=False,
         has_expand=False, c_sq=0, c_e=16, residual=True),
    dict(h=14, w=14, cin=96, cout=96, kernel=5, stride=1, has_squeeze=True,
         has_expand=True, c_sq=24, c_e=360, residual=True, act_qmax=127),
    dict(h=7, w=7, cin=192, cout=320, kernel=5, stride=1, has_squeeze=True,
         has_expand=True, c_sq=96, c_e=1728, residual=False),
]


@pytest.mark.parametrize("signed", [False, True], ids=["u8", "s8"])
@pytest.mark.parametrize("m,k,n", MATMUL_SHAPES)
def test_int8_matmul_kernel_matches_plain(cuda_device, m, k, n, signed):
    rng = np.random.RandomState(1)
    lo, hi, dt = (-128, 128, np.int8) if signed else (0, 256, np.uint8)
    x = torch.as_tensor(rng.randint(lo, hi, (m, k)).astype(dt), device=cuda_device)
    op = conv1x1_operands(torch.as_tensor(rng.randint(-128, 128, (k, n)).astype(np.int8)),
                          torch.as_tensor(rng.rand(n).astype(np.float32) * 1e-4),
                          torch.as_tensor(rng.randn(n).astype(np.float32)), 113, 0.02, 7,
                          not signed, 0, 255, cuda_device)
    before = int8_matmul_requant.launches
    got = int8_matmul_requant(x, op)
    assert int8_matmul_requant.launches == before + 1
    assert torch.equal(got, int8_matmul_requant_plain(x, op))


@pytest.mark.parametrize("case", BLOCKS, ids=lambda c: f"{c['h']}x{c['cin']}_e{c['c_e']}_k{c['kernel']}s{c['stride']}")
def test_frost_block_kernel_matches_plain(cuda_device, case):
    spec = tfb.FrostBlockSpec(**case)
    x, p = tfb.random_block_case(spec, 8, seed=3, device=cuda_device)
    before = tfb.frost_block_int8.launches
    got = tfb.frost_block_int8(x, p, spec)
    assert tfb.frost_block_int8.launches == before + 1
    assert torch.equal(got, tfb.frost_block_int8_plain(x, p, spec))
