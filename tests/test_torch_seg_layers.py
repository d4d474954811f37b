"""PyTorch port, the segmentation layers against the JAX package.

* Dilated ``QConvBNAct``: INT8 codes bit-equal to the frozen JAX conv on the
  depthwise route (k 3 and 5, dilation 2, with and without ReLU, stride 1
  as the dilated trunks run it) and on the im2col route with R-ASPP's
  atrous 3x3s (dilation and padding 2, 6, 12 and 18); the float phases
  (FP32 and QAT in train mode, QAT and QAT_FROZEN in eval mode) within the
  bands of ``tests/test_torch_blocks.py``.
* The dilated bottlenecks (``BottleneckV3`` RE and HS at k 5 with the
  squeeze-excite, ``InvertedResidual`` at k 3): INT8 codes bit-equal (the
  squeeze-excite within PR 8's flip band; 0 flips expected), float phases
  in bands.
* ``avg_pool``: XLA runs flax's division by the window area as a multiply
  by ``f32(1 / k**2)``; the two forms give the same codes at every window
  sum at the LR-ASPP windows (enumerated here); the port's codes equal the
  frozen JAX pool's at sums on and around every half-way point.
* ``QHsigmoid`` on a QTensor (the LR-ASPP gate) in INT8: codes, scale and
  zero point bit-equal at grids where ``_relu6``'s edges bind.
* The heads: ``LRASPP`` and ``RASPP`` INT8 codes bit-equal, their float
  phases in bands; ``RASPPHead``'s float ``reduce_conv`` logits within
  ``REL_FLOAT`` of the range (the codes before it bit-equal).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_variables
from frostnet_tpu import nn as jnn
from frostnet_tpu import quant as jq_
from frostnet_tpu.nn import blocks as jblocks
from frostnet_tpu.nn import pool as jpool
from frostnet_tpu.quant.qtensor import QTensor as JQTensor
from frostnet_tpu.segmentation import heads as jheads
from frostnet_tpu_torch import nn as tnn
from frostnet_tpu_torch.nn import blocks as tblocks
from frostnet_tpu_torch.quant import QParams, QTensor
from frostnet_tpu_torch.quant.export import from_jax_variables
from frostnet_tpu_torch.segmentation import heads as theads
from test_torch_blocks import (FLIP_FRACTION, MODES, REL_FLOAT, SE_FLIP_FRACTION, _block_input,
                               _block_tree, _calibrate_jax, _int8_compare, _jax_float,
                               _port_float)
from frostnet_tpu_torch.quant.export import flatten_variables

# (name, cin, cout, kernel, dilation, groups, act, route)
DILATED_CONVS = [("dw_k3_d2_relu", 32, 32, 3, 2, 32, "relu", "depthwise"),
                 ("dw_k5_d2", 32, 32, 5, 2, 32, None, "depthwise"),
                 ("dw_k5_d2_relu", 24, 24, 5, 2, 24, "relu", "depthwise"),
                 ("atrous_d2", 16, 24, 3, 2, 1, "relu", "im2col"),
                 ("atrous_d6", 16, 24, 3, 6, 1, "relu", "im2col"),
                 ("atrous_d12", 16, 24, 3, 12, 1, "relu", "im2col"),
                 ("atrous_d18", 16, 24, 3, 18, 1, "relu", "im2col")]


def _conv_pair(cfg):
    _, cin, cout, k, d, g, act, _ = cfg
    pad = d * (k - 1) // 2
    jmod = jnn.QConvBNAct(cout, k, padding=pad, dilation=d, groups=g, act=act)
    port = tnn.QConvBNAct(cin, cout, k, padding=pad, dilation=d, groups=g, act=act)
    return jmod, port


@pytest.mark.parametrize("cfg", DILATED_CONVS, ids=lambda c: c[0])
def test_dilated_conv_int8_codes_bit_equal(cfg):
    jmod, port = _conv_pair(cfg)
    q, grid, xf = _block_input(cfg[1], 71, size=20)
    tree = _calibrate_jax(jmod, _block_tree(port, 72), xf, {"train": False})
    flips, worst, _ = _int8_compare(jmod, port, tree, q, grid, {"train": False})
    assert port._route == cfg[7]
    assert flips == 0, (flips, worst)


@pytest.mark.parametrize("cfg", [DILATED_CONVS[1], DILATED_CONVS[4]], ids=lambda c: c[0])
@pytest.mark.parametrize("phase,train", [("FP32", True), ("QAT", True), ("QAT", False),
                                         ("QAT_FROZEN", False)])
def test_dilated_conv_float_phases_within_bands(cfg, phase, train):
    jmod, port = _conv_pair(cfg)
    _, _, xf = _block_input(cfg[1], 81, size=20)
    tree = _calibrate_jax(jmod, _block_tree(port, 82), xf, {"train": False})
    jmode, tmode = MODES[phase]
    jy, upd, grads, w = _jax_float(tree, xf, jmod, jmode, train=train)
    ty, state, tgrads = _port_float(port, tree, xf, tmode, w, train=train)
    span = float(jy.max() - jy.min())
    assert (np.abs(ty - jy) > REL_FLOAT * span).mean() <= FLIP_FRACTION
    g_j = np.asarray(grads["kernel"])
    g_t = tgrads["kernel"]
    assert np.abs(g_t - g_j).max() <= 1e-3 * np.abs(g_j).max() + 1e-6
    jflat = flatten_variables({"batch_stats": jax.tree.map(np.asarray, upd.get("batch_stats", {})),
                               "quant": jax.tree.map(np.asarray, upd.get("quant", {}))})
    for k, v in jflat.items():
        assert np.max(np.abs(state[k] - v)) <= 0.05 * (float(np.max(np.abs(v))) + 1e-6), k


# (name, kernel, se, nl, cin, exp, cout) for BottleneckV3; (name, cin, cout, t) for V2
DILATED_BLOCKS = [("v3_re_k5_d2_se", 5, True, "RE", 24, 72, 24),
                  ("v3_hs_k5_d2_se", 5, True, "HS", 24, 72, 32),
                  ("v3_hs_k3_d2", 3, False, "HS", 16, 48, 16),
                  ("v2_t6_d2_res", 24, 24, 6)]


def _block_pair(cfg):
    if len(cfg) == 7:
        name, k, se, nl, cin, exp, cout = cfg
        return (jblocks.BottleneckV3(out_channels=cout, exp_size=exp, kernel_size=k, strides=1,
                                     dilation=2, se=se, nl=nl),
                tblocks.BottleneckV3(cin, cout, exp, k, 1, dilation=2, se=se, nl=nl), cin, se)
    name, cin, cout, t = cfg
    return (jblocks.InvertedResidual(out_channels=cout, strides=1, expand_ratio=t, dilation=2),
            tblocks.InvertedResidual(cin, cout, strides=1, expand_ratio=t, dilation=2), cin, False)


@pytest.mark.parametrize("cfg", DILATED_BLOCKS, ids=lambda c: c[0])
def test_dilated_block_int8_codes(cfg):
    jmod, port, cin, se = _block_pair(cfg)
    q, grid, xf = _block_input(cin, 91, size=12)
    tree = _calibrate_jax(jmod, _block_tree(port, 92), xf, {"train": False})
    flips, worst, n = _int8_compare(jmod, port, tree, q, grid, {"train": False})
    assert port.dw._route == "depthwise" and port.dw.dilation == 2
    if se:
        assert flips <= SE_FLIP_FRACTION * n and worst <= 1, (flips, worst, n)
    else:
        assert flips == 0, (flips, worst)


@pytest.mark.parametrize("cfg", DILATED_BLOCKS[1::2], ids=lambda c: c[0])
@pytest.mark.parametrize("phase,train", [("FP32", True), ("QAT", True), ("QAT_FROZEN", False)])
def test_dilated_block_float_phases_within_bands(cfg, phase, train):
    jmod, port, cin, _ = _block_pair(cfg)
    _, _, xf = _block_input(cin, 93, size=12)
    tree = _calibrate_jax(jmod, _block_tree(port, 94), xf, {"train": False})
    jmode, tmode = MODES[phase]
    jy, upd, _, w = _jax_float(tree, xf, jmod, jmode, train=train)
    ty, state, _ = _port_float(port, tree, xf, tmode, w, train=train)
    span = float(jy.max() - jy.min())
    assert (np.abs(ty - jy) > REL_FLOAT * span).mean() <= FLIP_FRACTION


# ---------------------------------------------------------------------------
# avg_pool
# ---------------------------------------------------------------------------

POOL_WINDOWS = (4, 6, 16, 37)  # the LR-ASPP windows: crops 64, 96, 256 and 768


@pytest.mark.parametrize("k", POOL_WINDOWS)
def test_avg_pool_forms_agree_at_every_window_sum(k):
    """``rint(S * f32(1/k**2))`` (the frozen graph's) and ``rint(S / k**2)``
    give the same code at every integer sum S of a window of uint8 codes."""
    n = k * k
    s = torch.arange(0, 255 * n + 1, dtype=torch.float32)
    mult = torch.round(s * (torch.tensor(1.0) / torch.tensor(float(n))))
    div = torch.round(s / torch.tensor(float(n)))
    assert torch.equal(mult, div)


def _windows_with_sums(k, sums):
    """(1, k, k, len(sums)) uint8 codes whose channel c sums to sums[c]."""
    n = k * k
    q = np.zeros((n, len(sums)), np.int64)
    for c, s in enumerate(sums):
        full, rest = divmod(int(s), 255)
        q[:full, c] = 255
        if full < n:
            q[full, c] = rest
    rng = np.random.RandomState(k)
    for c in range(len(sums)):  # shuffle each window's codes
        q[:, c] = q[rng.permutation(n), c]
    return q.reshape(1, k, k, len(sums)).astype(np.uint8)


@pytest.mark.parametrize("k", POOL_WINDOWS)
def test_avg_pool_int8_bit_equal_around_half_points(k):
    n = k * k
    half = np.arange(n // 2, 255 * n, n)  # floor((m + 0.5) n), m = 0, 1, ...
    sums = np.unique(np.clip(np.concatenate([half - 1, half, half + 1, [0, 255 * n]]),
                             0, 255 * n))
    q = _windows_with_sums(k, sums)
    jout = jax.jit(lambda qq: jpool.avg_pool(JQTensor(qq, jnp.float32(0.1), jnp.int32(3)), k,
                                             k).q)(jnp.asarray(q))
    got = tnn.avg_pool(QTensor(torch.as_tensor(q), torch.tensor(0.1), torch.tensor(3)), k, k)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(jout))
    assert got.q.dtype == torch.uint8 and got.q.shape == (1, 1, 1, len(sums))


@pytest.mark.parametrize("h,win,stride", [(48, 37, 12), (20, 16, 12), (6, 6, 6), (9, 4, 2)])
def test_avg_pool_strided_codes_and_floats(h, win, stride):
    """Strided VALID windows (the 768 crop's 48x48 map gives one 37x37
    window): codes bit-equal; floats within two float32 ulps (JAX sums a
    window in order, the port exactly)."""
    rng = np.random.RandomState(h)
    q = rng.randint(0, 256, (2, h, h, 8)).astype(np.uint8)
    jq = jax.jit(lambda qq: jpool.avg_pool(JQTensor(qq, jnp.float32(0.1), jnp.int32(3)), win,
                                           stride).q)(jnp.asarray(q))
    got = tnn.avg_pool(QTensor(torch.as_tensor(q), torch.tensor(0.1), torch.tensor(3)), win,
                       stride)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(jq))
    x = rng.randn(2, h, h, 8).astype(np.float32)
    jf = np.asarray(jax.jit(lambda xx: jpool.avg_pool(xx, win, stride))(jnp.asarray(x)))
    tf = tnn.avg_pool(torch.as_tensor(x), win, stride).numpy()
    assert tf.shape == jf.shape
    np.testing.assert_allclose(tf, jf, rtol=0, atol=2 * np.finfo(np.float32).eps * 3)


# ---------------------------------------------------------------------------
# The LR-ASPP gate's hard-sigmoid on a QTensor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale,zp", [(0.004, 100), (0.0117, 20), (0.05, 30), (0.07, 200),
                                      (0.2, 250)])
def test_hsigmoid_int8_on_qtensor_bit_equal(scale, zp):
    s = float(np.float32(scale))
    q = np.arange(256, dtype=np.uint8).reshape(1, 4, 4, 16)

    def f(qq):
        out = jblocks.QHsigmoid().apply(
            {"quant": {"relu6_obs": jq_.ObserverState(jnp.float32(0.0), jnp.float32(4.0))}},
            JQTensor(qq, jnp.float32(scale), jnp.int32(zp)), mode=jnn.INT8)
        return out.q, out.scale, out.zero_point, out.dequantize()

    jq, js, jz, jd = jax.jit(f)(jnp.asarray(q))
    port = tblocks.QHsigmoid()
    grid = port.prepare_int8(QParams(s, zp), "cpu")
    out = port(QTensor(torch.as_tensor(q), *QParams(s, zp).tensors("cpu")), mode=tnn.INT8)
    np.testing.assert_array_equal(out.q.numpy(), np.asarray(jq))
    assert grid.scale == float(js) and grid.zero_point == int(jz)
    np.testing.assert_array_equal(out.dequantize().numpy(), np.asarray(jd))


# ---------------------------------------------------------------------------
# Heads
# ---------------------------------------------------------------------------

def _head_input(cin, size, seed):
    rng = np.random.RandomState(seed)
    q = rng.randint(0, 256, (2, size, size, cin)).astype(np.uint8)
    grid = (0.031, 88)
    return q, grid, ((q.astype(np.float32) - grid[1]) * np.float32(grid[0]))


HEADS = {"lraspp_768_geometry": (lambda: jheads.LRASPP(37, 12), lambda: theads.LRASPP(48, 37, 12),
                                 48, 6),
         "lraspp_pascal_geometry": (lambda: jheads.LRASPP(25, 8), lambda: theads.LRASPP(40, 25, 8),
                                    40, 11),
         "raspp": (lambda: jheads.RASPP(), lambda: theads.RASPP(32), 32, 8)}


@pytest.mark.parametrize("name", sorted(HEADS))
def test_head_int8_codes_bit_equal(name):
    jmake, tmake, cin, size = HEADS[name]
    port = tmake()
    q, grid, xf = _head_input(cin, size, 101)
    tree = _calibrate_jax(jmake(), _block_tree(port, 102), xf, {"train": False})
    flips, worst, _ = _int8_compare(jmake(), port, tree, q, grid, {"train": False})
    assert flips == 0, (flips, worst)
    if name == "raspp":
        assert [c._route for c in port.atrous] == ["im2col"] * 3


@pytest.mark.parametrize("name", sorted(HEADS))
@pytest.mark.parametrize("phase,train", [("FP32", False), ("QAT", True), ("QAT_FROZEN", False)])
def test_head_float_phases_within_bands(name, phase, train):
    jmake, tmake, cin, size = HEADS[name]
    port = tmake()
    _, _, xf = _head_input(cin, size, 111)
    tree = _calibrate_jax(jmake(), _block_tree(port, 112), xf, {"train": False})
    if name == "raspp" and train:
        port.drop_rate = 0.0  # dropout's draws differ between the packages
        jmod = jheads.RASPP(drop_rate=0.0)
    else:
        jmod = jmake()
    jmode, tmode = MODES[phase]
    jy, upd, _, w = _jax_float(tree, xf, jmod, jmode, train=train)
    ty, state, _ = _port_float(port, tree, xf, tmode, w, train=train)
    span = float(jy.max() - jy.min())
    assert (np.abs(ty - jy) > REL_FLOAT * span).mean() <= FLIP_FRACTION


def test_raspp_head_int8_logits_within_band():
    """RASPPHead in INT8: the codes up to ``project`` (the dense 3x3 route)
    are the frozen graph's, the float ``reduce_conv`` sums in another
    order: logits within ``REL_FLOAT`` of their range."""
    port = theads.RASPPHead(24, 32, num_classes=7)
    rng = np.random.RandomState(121)
    q1 = rng.randint(0, 256, (2, 12, 12, 24)).astype(np.uint8)
    q4 = rng.randint(0, 256, (2, 6, 6, 32)).astype(np.uint8)
    g1, g4 = (0.02, 100), (0.031, 88)
    f1 = (q1.astype(np.float32) - g1[1]) * np.float32(g1[0])
    f4 = (q4.astype(np.float32) - g4[1]) * np.float32(g4[0])
    jmod = jheads.RASPPHead(num_classes=7)
    v = jax_variables(_block_tree(port, 122))
    observe = jax.jit(lambda vv, a, b: jmod.apply(vv, a, b, mode=jnn.QAT, mutable=["quant"]))
    for _ in range(2):
        _, upd = observe(v, jnp.asarray(f1), jnp.asarray(f4))
        v = {**v, **upd}
    jy = np.asarray(jax.jit(lambda a, b: jmod.apply(
        v, JQTensor(a, jnp.float32(g1[0]), jnp.int32(g1[1])),
        JQTensor(b, jnp.float32(g4[0]), jnp.int32(g4[1])), mode=jnn.INT8))(
        jnp.asarray(q1), jnp.asarray(q4)))
    from frostnet_tpu_torch.quant.export import unflatten_variables
    from_jax_variables(port, unflatten_variables(flatten_variables(jax.tree.map(np.asarray, v))))
    p1, p4 = QParams(float(np.float32(g1[0])), g1[1]), QParams(float(np.float32(g4[0])), g4[1])
    port.prepare_int8(p1, p4, "cpu")
    assert port.project._route == "dense3x3"
    with torch.no_grad():
        ty = port(QTensor(torch.as_tensor(q1), *p1.tensors("cpu")),
                  QTensor(torch.as_tensor(q4), *p4.tensors("cpu")), mode=tnn.INT8).numpy()
    span = float(jy.max() - jy.min())
    assert ty.shape == jy.shape == (2, 12, 12, 7) and span > 0
    assert np.abs(ty - jy).max() <= REL_FLOAT * span, np.abs(ty - jy).max()
