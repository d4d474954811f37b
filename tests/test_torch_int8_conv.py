"""PyTorch port, dense 3x3 stride-1 INT8 conv (frostnet_tpu_torch/ops/int8_conv).

The plain version is held bit-exact (no tolerance) against the frozen JAX
INT8 conv it serves: ``QConvBNAct`` 3x3 stride 1 under ``jax.jit`` closed
over its variables, as ``frostnet_tpu.quant.freeze`` runs it, with the Pallas
dense path off (the reference's production path). It is also held against
the same freeze with the Pallas kernel on (interpret mode on the CPU, H tile
forced to 4). The Pallas epilogue divides by the output scale where the
frozen XLA epilogue multiplies by its float32 reciprocal; on these cases both
give the same codes (the test asserts it, so a change shows). The CUDA
kernel is held against the plain version on the card in
tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frostnet_tpu import nn as jnn
from frostnet_tpu import quant as jq
from frostnet_tpu.nn.conv import set_pallas_int8_dense
from frostnet_tpu.quant.qtensor import QTensor as JQTensor
from frostnet_tpu_torch import nn as tnn
from frostnet_tpu_torch import quant as tq
from frostnet_tpu_torch.ops.int8_conv import (KC, conv3x3_acc, conv3x3_operands, conv3x3_s1_int8,
                                              conv3x3_s1_int8_plain)
from frostnet_tpu_torch.quant.export import from_jax_variables


@pytest.fixture(autouse=True)
def _pallas_off_after():
    yield
    set_pallas_int8_dense(None)


def _frozen_jax_conv(module, variables, xq, grid):
    consts = jax.tree.map(jnp.asarray, variables)
    return np.asarray(jax.jit(lambda q: module.apply(
        consts, JQTensor(q, jnp.float32(grid[0]), jnp.int32(grid[1])), mode=jnn.INT8).q)(
        jnp.asarray(xq)))


def _case(backend, act, cin, cout, hw, seed):
    """(variables, codes, grid) of a 3x3 conv + BN with calibrated-looking
    observers: few outputs saturate."""
    jqc = jq.get_qconfig(backend)
    qmax = jqc.activation.qmax
    rng = np.random.RandomState(seed)
    xq = rng.randint(0, qmax + 1, (2, hw, hw, cin)).astype(np.uint8)
    grid = (np.float32(0.037), np.int32(rng.randint(1, qmax)))
    params = {"kernel": (rng.randn(3, 3, cin, cout) * 0.05).astype(np.float32),
              "scale": (rng.rand(cout) + 0.5).astype(np.float32),
              "bias_bn": (rng.randn(cout) * 0.3).astype(np.float32)}
    bs = {"mean": (rng.randn(cout) * 0.2).astype(np.float32),
          "var": (rng.rand(cout) + 0.5).astype(np.float32)}
    amax = np.abs(params["kernel"]).max(axis=(0, 1, 2) if jqc.weight.per_channel else None)
    span = 0.8 * np.sqrt(9 * cin)
    quant = {"w_obs": jq.ObserverState(-amax.astype(np.float32), amax.astype(np.float32)),
             "act_obs": jq.ObserverState(np.float32(0.0 if act else -span),
                                         np.float32(span))}
    return {"params": params, "batch_stats": bs, "quant": quant}, xq, grid


def _port_conv(backend, act, cin, cout, variables, grid):
    conv = from_jax_variables(tnn.QConvBNAct(cin, cout, 3, padding=1, act=act,
                                             qconfig=tq.get_qconfig(backend)), variables)
    conv.prepare_int8(tq.QParams(float(grid[0]), int(grid[1])), torch.device("cpu"))
    return conv


def _spread(codes, qmax):
    assert len(np.unique(codes)) > 32 and (codes == qmax).mean() < 0.1


@pytest.mark.parametrize("act", [None, "relu"], ids=["linear", "relu"])
@pytest.mark.parametrize("backend", ["qnnpack", "fbgemm"])
def test_plain_matches_jax_freeze(backend, act):
    cin, cout = 64, 96
    variables, xq, grid = _case(backend, act, cin, cout, 12, seed=len(backend) + (act is None))
    jqc = jq.get_qconfig(backend)
    want = _frozen_jax_conv(jnn.QConvBNAct(cout, 3, padding=1, act=act, qconfig=jqc),
                            variables, xq, grid)
    conv = _port_conv(backend, act, cin, cout, variables, grid)
    assert conv._route == "dense3x3"
    before = conv3x3_s1_int8.launches
    got = conv(tq.QTensor(torch.as_tensor(xq), None, None), tnn.INT8).q.numpy()
    assert conv3x3_s1_int8.launches == before  # a CPU tensor launches nothing
    np.testing.assert_array_equal(got, want)
    _spread(want, jqc.activation.qmax)


# Shapes that cut the CUDA kernel's tiles (4 rows x 64 columns x 64 or 128
# output channels, 32-channel chunks): W past 64, Cout past 128 and not a
# multiple of 64, Cin not a multiple of 32 or of 16.
EDGE_SHAPES = [(5, 75, 68, 132), (6, 70, 48, 52), (3, 66, 100, 200)]


@pytest.mark.parametrize("shape", EDGE_SHAPES, ids=lambda s: "{}x{}_{}to{}".format(*s))
@pytest.mark.parametrize("backend", ["qnnpack", "fbgemm"])
def test_plain_matches_jax_freeze_at_tile_edges(backend, shape):
    h, w, cin, cout = shape
    act = "relu" if backend == "fbgemm" else None
    variables, xq, grid = _case(backend, act, cin, cout, 1, seed=cin + cout)
    xq = np.random.RandomState(cout).randint(0, jq.get_qconfig(backend).activation.qmax + 1,
                                             (2, h, w, cin)).astype(np.uint8)
    jqc = jq.get_qconfig(backend)
    want = _frozen_jax_conv(jnn.QConvBNAct(cout, 3, padding=1, act=act, qconfig=jqc),
                            variables, xq, grid)
    conv = _port_conv(backend, act, cin, cout, variables, grid)
    assert conv._route == "dense3x3"
    got = conv(tq.QTensor(torch.as_tensor(xq), None, None), tnn.INT8).q.numpy()
    np.testing.assert_array_equal(got, want)
    _spread(want, jqc.activation.qmax)


@pytest.mark.parametrize("cin,cout", [(4, 8), (68, 132), (256, 256)])
def test_weight_packing(cin, cout):
    """The kernel reads wt[c // KC, 3*dy+dx, (c % KC) // 16, o, c % 16]
    int8, c zero-padded to a multiple of KC (its 32-channel chunk): each
    chunk's 16-channel slice of a tap is contiguous over o. The packing
    round-trips."""
    qw = torch.as_tensor(np.random.RandomState(cin).randint(-128, 128, (3, 3, cin, cout))
                         .astype(np.int8))
    op = conv3x3_operands(qw, torch.tensor(0.01), torch.zeros(cout), 3, 1.0, 0, False, 0, 255,
                          "cpu")
    cin_pad = -(-cin // KC) * KC
    assert KC == 32 and op.wt.dtype == torch.int8 and op.wt.is_contiguous()
    assert tuple(op.wt.shape) == (cin_pad // KC, 9, KC // 16, cout, 16)
    flat = op.wt.permute(1, 0, 2, 4, 3).reshape(9, cin_pad, cout)  # [tap, c, o]
    assert not flat[:, cin:].any()
    assert torch.equal(flat[:, :cin].reshape(3, 3, cin, cout), qw)
    c, o = cin - 1, cout - 1  # one element by the formula
    assert int(op.wt[c // KC, 8, (c % KC) // 16, o, c % 16]) == int(qw[2, 2, c, o])
    assert torch.equal(op.weight().permute(2, 3, 1, 0), qw)
    assert (op.cin, op.cout) == (cin, cout)


@pytest.mark.parametrize("hw", [8, 16])
@pytest.mark.parametrize("act", [None, "relu"], ids=["linear", "relu"])
@pytest.mark.parametrize("backend", ["qnnpack", "fbgemm"])
def test_plain_matches_pallas_kernel_in_freeze(backend, act, hw, monkeypatch):
    from frostnet_tpu.ops import pallas_int8_conv as pic

    cin = cout = 128
    variables, xq, grid = _case(backend, act, cin, cout, hw, seed=hw)
    jqc = jq.get_qconfig(backend)
    module = jnn.QConvBNAct(cout, 3, padding=1, act=act, qconfig=jqc)
    monkeypatch.setattr(pic, "pick_h_tile", lambda hp, wp, cin, cout, variant=None: 4)
    calls, kernel = [], pic.conv3x3_s1_int8
    monkeypatch.setattr(pic, "conv3x3_s1_int8",
                        lambda *a, **k: calls.append(k["th"]) or kernel(*a, **k))
    set_pallas_int8_dense(True)  # off the TPU: interpret mode
    pallas = _frozen_jax_conv(module, variables, xq, grid)
    assert calls == [4]  # the Pallas kernel ran, in H tiles of 4
    set_pallas_int8_dense(None)
    xla = _frozen_jax_conv(module, variables, xq, grid)
    got = _port_conv(backend, act, cin, cout, variables, grid)(
        tq.QTensor(torch.as_tensor(xq), None, None), tnn.INT8).q.numpy()
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("zp", [0, 117, 255])
def test_float64_route_equals_int32_unfold(zp):
    rng = np.random.RandomState(zp)
    cin, cout = 20, 12
    x = torch.as_tensor(rng.randint(0, 256, (2, 7, 9, cin)).astype(np.uint8))
    qw = torch.as_tensor(rng.randint(-128, 128, (3, 3, cin, cout)).astype(np.int8))
    op = conv3x3_operands(qw, torch.tensor(0.01), torch.zeros(cout), zp, 1.0, 0, False, 0, 255,
                          "cpu")
    # int32 reference: zero-point-padded im2col patches times the weight,
    # minus the zero-point term
    xp = torch.nn.functional.pad(x.to(torch.int32), (0, 0, 1, 1, 1, 1), value=zp)
    cols = torch.cat([xp[:, dy:dy + 7, dx:dx + 9, :] for dy in range(3) for dx in range(3)], -1)
    w = qw.to(torch.int32).reshape(9 * cin, cout)
    want = (cols.reshape(-1, 9 * cin) @ w + op.zterm).reshape(2, 7, 9, cout)
    assert torch.equal(conv3x3_acc(x, op), want)
    assert torch.equal(op.zterm, (-zp * w.sum(0)).to(torch.int32))
    # the kernel reads these as int32 and float32 arrays
    assert (op.zterm.dtype, op.scale.dtype, op.bias.dtype, op.wt.dtype) == (
        torch.int32, torch.float32, torch.float32, torch.int8)


def test_edge_taps_read_the_zero_point():
    """A map at its zero point is 'zero' everywhere, borders included."""
    cin, cout = 8, 4
    qw = torch.full((3, 3, cin, cout), 100, dtype=torch.int8)
    op = conv3x3_operands(qw, torch.tensor(1.0), torch.zeros(cout), 77, 1.0, 9, True, 0, 255,
                          "cpu")
    x = torch.full((1, 5, 6, cin), 77, dtype=torch.uint8)
    assert (conv3x3_s1_int8_plain(x, op) == 9).all()


def test_wrapper_rejects_bad_inputs():
    op = conv3x3_operands(torch.ones(3, 3, 8, 4, dtype=torch.int8), torch.tensor(1.0),
                          torch.zeros(4), 0, 1.0, 0, False, 0, 255, "cpu")
    with pytest.raises(ValueError):
        conv3x3_s1_int8(torch.zeros(1, 4, 4, 7, dtype=torch.uint8), op)
    with pytest.raises(TypeError):
        conv3x3_s1_int8(torch.zeros(1, 4, 4, 8, dtype=torch.int8), op)
    with pytest.raises(ValueError):  # operands and input on different devices
        conv3x3_s1_int8(torch.zeros(1, 4, 4, 8, dtype=torch.uint8, device="meta"), op)


def test_routes():
    kw = dict(act="relu")
    assert _routes([tnn.QConvBNAct(16, 16, 3, padding=1, **kw),
                    tnn.QConvBNAct(16, 32, 3, strides=2, padding=1, **kw),
                    tnn.QConvBNAct(3, 16, 7, **kw),
                    tnn.QConvBNAct(16, 16, 3, padding=0, **kw)]) == \
        ["dense3x3", "im2col", "im2col", "im2col"]


def _routes(convs):
    out = []
    for conv in convs:
        with torch.no_grad():
            conv.kernel.normal_()
            conv.w_obs.min_val.fill_(-1.0)
            conv.w_obs.max_val.fill_(1.0)
            conv.act_obs.min_val.fill_(0.0)
            conv.act_obs.max_val.fill_(1.0)
        conv.prepare_int8(tq.QParams(0.02, 3), torch.device("cpu"))
        out.append(conv._route)
    return out
