"""PyTorch port, INT8 matmul + requant (frostnet_tpu_torch/ops/int8_matmul).

The plain version is held bit-exact against the JAX spec of the TPU kernel
(``reference_int8_matmul_requant``) and against the JAX INT8 conv it serves
(``QConvBNAct`` 1x1, frozen), on the CPU. The CUDA kernel is held against
the plain version on the card in tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frostnet_tpu import nn as jnn
from frostnet_tpu import quant as jq
from frostnet_tpu.ops.pallas_int8_matmul import reference_int8_matmul_requant
from frostnet_tpu.quant.qtensor import QTensor as JQTensor
from frostnet_tpu_torch import nn as tnn
from frostnet_tpu_torch import quant as tq
from frostnet_tpu_torch.ops.int8_matmul import (K_ALIGN, conv1x1_operands, int8_matmul_requant,
                                                pack_operands)
from frostnet_tpu_torch.ops.requant import reciprocal
from frostnet_tpu_torch.quant.export import from_jax_variables

# tests/test_pallas_int8_matmul.py, then shapes that cut the CUDA kernel's
# tiles: the classifier (M=8, N=1000), last_layer (M=392), the stems' K=27
# and K=147 (rows not 4-byte aligned), a GAN down's K=1152 with N=256
SHAPES = [(256, 136, 816), (100, 24, 144), (17, 8, 40),
          (8, 1280, 1000), (392, 320, 1280), (300, 27, 16), (200, 147, 64), (136, 1152, 256)]


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_plain_matches_jax_reference(m, k, n):
    rng = np.random.RandomState(0)
    x8 = rng.randint(-128, 128, (m, k)).astype(np.int8)
    w8 = rng.randint(-128, 128, (k, n)).astype(np.int8)
    scale = rng.rand(n).astype(np.float32) * 1e-3 + 1e-4
    bias = rng.randn(n).astype(np.float32) * 0.1
    out_scale, out_zp = np.float32(0.02), np.float32(7.0)
    # frozen: everything but the activations is a compile-time constant
    want = np.asarray(jax.jit(lambda x: reference_int8_matmul_requant(
        x, jnp.asarray(w8), jnp.asarray(scale), jnp.asarray(bias),
        jnp.float32(out_scale), jnp.float32(out_zp)))(jnp.asarray(x8)))
    op = pack_operands(torch.as_tensor(w8), torch.zeros(n, dtype=torch.int32),
                       torch.as_tensor(scale), torch.as_tensor(bias), reciprocal(out_scale),
                       7, False, 0, 255, "cpu")
    before = int8_matmul_requant.launches
    got = int8_matmul_requant(torch.as_tensor(x8), op)
    assert int8_matmul_requant.launches == before  # a CPU tensor launches nothing
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,n", [(27, 16), (147, 64), (1152, 256), (1280, 1000)])
def test_weight_packing(k, n):
    """The kernel reads wt[n, k] int8 rows of ldw bytes, ldw a multiple of
    K_ALIGN (the row padding its launcher requires), zero past K; the
    packing round-trips."""
    w = torch.as_tensor(np.random.RandomState(k).randint(-128, 128, (k, n)).astype(np.int8))
    op = pack_operands(w, torch.zeros(n, dtype=torch.int32), torch.ones(n), torch.zeros(n), 1.0,
                       0, False, 0, 255, "cpu")
    assert K_ALIGN == 64 and op.wt.dtype == torch.int8 and op.wt.is_contiguous()
    assert tuple(op.wt.shape) == (n, -(-k // K_ALIGN) * K_ALIGN) and op.k == k
    assert not op.wt[:, k:].any()
    assert torch.equal(op.wt[:, :k].t(), w)
    assert (op.zterm.dtype, op.scale.dtype, op.bias.dtype) == (torch.int32, torch.float32,
                                                               torch.float32)


def _frozen_jax_conv(module, variables, xq, grid):
    consts = jax.tree.map(jnp.asarray, variables)
    return np.asarray(jax.jit(lambda q: module.apply(
        consts, JQTensor(q, jnp.float32(grid[0]), jnp.int32(grid[1])), mode=jnn.INT8).q)(
        jnp.asarray(xq)))


CONVS = {
    # 1x1 conv + BN + ReLU on the fbgemm grid: per-channel weights, qmax 127
    "bn_relu_fbgemm": dict(backend="fbgemm", act="relu", use_bn=True),
    # 1x1 conv + BN, no activation (the block's reduce conv)
    "bn_linear_qnnpack": dict(backend="qnnpack", act=None, use_bn=True),
    # the classifier: bias, no BN, no activation; a zero bias makes XLA fold
    # the two scalar scales of the epilogue into one constant
    "classifier_zero_bias": dict(backend="qnnpack", act=None, use_bn=False, zero_bias=True),
    "classifier_bias": dict(backend="qnnpack", act=None, use_bn=False),
}


@pytest.mark.parametrize("case", sorted(CONVS))
def test_plain_matches_jax_int8_conv1x1(case):
    cfg = CONVS[case]
    jqc, tqc = jq.get_qconfig(cfg["backend"]), tq.get_qconfig(cfg["backend"])
    qmax = jqc.activation.qmax
    cin, cout = 64, 96
    rng = np.random.RandomState(len(case))
    xq = rng.randint(0, qmax + 1, (8, 64, 64, cin)).astype(np.uint8)
    grid = (np.float32(0.037), np.int32(rng.randint(1, qmax)))
    kw = dict(act=cfg["act"], use_bn=cfg["use_bn"], use_bias=not cfg["use_bn"])
    params = {"kernel": (rng.randn(1, 1, cin, cout) * 0.3).astype(np.float32)}
    bs = {}
    if cfg["use_bn"]:
        params.update(scale=(rng.rand(cout) + 0.5).astype(np.float32),
                      bias_bn=(rng.randn(cout) * 0.3).astype(np.float32))
        bs = {"mean": (rng.randn(cout) * 0.2).astype(np.float32),
              "var": (rng.rand(cout) + 0.5).astype(np.float32)}
    else:
        params["bias"] = (np.zeros(cout) if cfg.get("zero_bias")
                          else rng.randn(cout) * 0.3).astype(np.float32)
    amax = np.abs(params["kernel"]).max(axis=(0, 1, 2) if jqc.weight.per_channel else None)
    quant = {"w_obs": jq.ObserverState(-amax.astype(np.float32), amax.astype(np.float32)),
             "act_obs": jq.ObserverState(np.float32(0.0 if cfg["act"] else -20.0),
                                         np.float32(24.0))}  # few outputs saturate
    variables = {"params": params, "batch_stats": bs, "quant": quant}
    want = _frozen_jax_conv(jnn.QConvBNAct(cout, 1, qconfig=jqc, **kw), variables, xq, grid)

    conv = from_jax_variables(tnn.QConvBNAct(cin, cout, 1, qconfig=tqc, **kw), variables)
    conv.prepare_int8(tq.QParams(float(grid[0]), int(grid[1])), torch.device("cpu"))
    got = conv(tq.QTensor(torch.as_tensor(xq), None, None), tnn.INT8).q
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.max()) <= qmax


def test_saturates_and_uses_zero_point_term():
    x = torch.full((8, 16), 255, dtype=torch.uint8)
    w = torch.full((16, 24), 127, dtype=torch.int8)
    op = conv1x1_operands(w, torch.tensor(1.0), torch.zeros(24), 0, 1.0, 0, False, 0, 127, "cpu")
    assert int(int8_matmul_requant(x, op).min()) == 127
    # with the input zero point at 255 the codes are all "zero": acc = 0
    op = conv1x1_operands(w, torch.tensor(1.0), torch.zeros(24), 255, 1.0, 5, True, 0, 255, "cpu")
    assert (int8_matmul_requant(x, op) == 5).all()


def test_wrapper_rejects_bad_inputs():
    op = conv1x1_operands(torch.ones(16, 8, dtype=torch.int8), torch.tensor(1.0),
                          torch.zeros(8), 0, 1.0, 0, False, 0, 255, "cpu")
    with pytest.raises(ValueError):
        int8_matmul_requant(torch.zeros(4, 15, dtype=torch.uint8), op)
    with pytest.raises(TypeError):
        int8_matmul_requant(torch.zeros(4, 16, dtype=torch.float32), op)
    with pytest.raises(ValueError):  # operands and input on different devices
        int8_matmul_requant(torch.zeros(4, 16, dtype=torch.uint8, device="meta"), op)
