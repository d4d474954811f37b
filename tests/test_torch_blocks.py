"""PyTorch port, the MobileNet blocks (``nn/blocks.py``), against the JAX package.

The same variables and inputs, made from numpy seeds, go through the JAX
block and the port's:

* INT8: the JAX block jitted with its variables and input grid closed over
  (what ``freeze`` runs), the port's ``prepare_int8`` + forward on the CPU
  (the kernels' plain versions). Codes bit-equal, except where the
  squeeze-excite's float reductions decide (``SE_FLIP_FRACTION``).
* FP32, QAT (train and eval) and QAT_FROZEN, the JAX block jitted with its
  variables as arguments (the train step's program): the element-wise
  blocks (hard-swish, hard-sigmoid, the observed mul) bit-equal in float32,
  outputs, observer states and gradients; blocks with a convolution or a
  dense layer within the bands of ``tests/test_torch_qat.py`` (the sums run
  in other orders); bfloat16 within ``BF16_REL``.
* Edges: the ReLU6 clamp identity of the INT8 conv epilogue on every route,
  at grids where 6.0 lies inside the grid and beyond it; ``_relu6``'s
  shifted zero point below 0 and ``q6`` past 255; ``QDense``'s folded INT8
  grid against the traced one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_variables
from frostnet_tpu import nn as jnn
from frostnet_tpu import quant as jq
from frostnet_tpu.nn import blocks as jblocks
from frostnet_tpu.quant.qtensor import QTensor as JQTensor
from frostnet_tpu_torch import nn as tnn
from frostnet_tpu_torch.nn import blocks as tblocks
from frostnet_tpu_torch.quant import QParams, QTensor, get_qconfig
from frostnet_tpu_torch.quant.export import (flatten_variables, from_jax_variables,
                                             model_variables, unflatten_variables)

MODES = {"FP32": (jnn.FP32, tnn.FP32), "QAT": (jnn.QAT, tnn.QAT),
         "QAT_FROZEN": (jnn.QAT_FROZEN, tnn.QAT_FROZEN)}
# Bands. Convolutions and dense products sum in other orders (relative
# ~1e-6); a fake-quantized value on a rounding boundary moves one quantum,
# on few elements (tests/test_torch_qat.py states the same).
REL_FLOAT = 2e-5
FLIP_FRACTION = 0.01
# INT8 squeeze-excite: the spatial mean (XLA: a sequential float32 sum; the
# port: exact, rounded once) and the dense products move the gate by an ulp
# or so; where that crosses a rounding boundary of the gating mul's requant
# the code moves by one. Measured here: 0 flips at these sizes.
SE_FLIP_FRACTION = 0.002
# bfloat16 QAT: the same ops, each rounding to bfloat16 (8 bits), relative
# to the output's range.
BF16_REL = 2e-2


def _jax_float(tree, x, mod, mode, train=False, dtype=None):
    """(y, updates, grads) of the JAX module, jitted with the variables as
    arguments; the loss is ``sum(y * w)`` with a fixed seeded ``w``."""
    def f(v, xx, w):
        def loss(params):
            y, upd = mod.apply({**v, "params": params}, xx, mode=mode, mutable=["batch_stats", "quant"],
                               **({"train": train} if train is not None else {}))
            return jnp.sum(y.astype(jnp.float32) * w), (y, upd)

        (_, (y, upd)), grads = jax.value_and_grad(loss, has_aux=True)(v.get("params", {}))
        return y, upd, grads

    v = jax_variables(tree)
    v.setdefault("params", {})
    w = np.random.RandomState(7).randn(*_out_shape(mod, v, x)).astype(np.float32)
    y, upd, grads = jax.jit(f)(v, jnp.asarray(x), jnp.asarray(w))
    return np.asarray(y.astype(jnp.float32)), upd, grads, w


def _out_shape(mod, v, x):
    out = jax.eval_shape(lambda xx: mod.apply(v, xx, mode=jnn.FP32, mutable=["batch_stats", "quant"],
                                              )[0], jnp.asarray(x))
    return out.shape


def _port_float(port, tree, x, mode, w, train=None):
    from_jax_variables(port, tree)
    xt = torch.tensor(x, requires_grad=True)
    kw = {} if train is None else {"train": train}
    y = port(xt, mode=mode, **kw)
    (y.to(torch.float32) * torch.as_tensor(w)).sum().backward()
    state = {k: v.detach().numpy().copy() for k, v in model_variables(port).items()}
    grads = {k: p.grad.numpy() for k, p in port.named_parameters() if p.grad is not None}
    return y.detach().to(torch.float32).numpy(), state, grads


def _observers(upd):
    flat = flatten_variables({"quant": jax.tree.map(np.asarray, upd.get("quant", {}))})
    return flat


# ---------------------------------------------------------------------------
# Element-wise blocks in the float phases: bit-equal (float32)
# ---------------------------------------------------------------------------

def _elementwise_case(seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(2, 5, 5, 16) * 2.5).astype(np.float32)
    return x


ELEMENTWISE = {
    "hswish": (lambda: jblocks.QHswish(), lambda: tblocks.QHswish(),
               {"relu6_obs", "quant_mul"}),
    "hsigmoid": (lambda: jblocks.QHsigmoid(), lambda: tblocks.QHsigmoid(), {"relu6_obs"}),
}


def _empty_tree(port):
    flat = {k: (np.full(v.shape, np.inf, np.float32) if k.endswith(".min_val") else
                np.full(v.shape, -np.inf, np.float32) if k.endswith(".max_val") else
                v.detach().numpy().copy())
            for k, v in model_variables(port).items()}
    return unflatten_variables(flat)


def _calibrated_tree(port, seed):
    """Observers at seeded ranges around the data's."""
    rng = np.random.RandomState(seed)
    flat = {}
    for k, v in model_variables(port).items():
        if k.endswith(".min_val"):
            flat[k] = np.float32(-rng.uniform(0.5, 3.0))
        elif k.endswith(".max_val"):
            flat[k] = np.float32(rng.uniform(2.0, 7.0))
        else:
            flat[k] = v.detach().numpy().copy()
    return unflatten_variables(flat)


# (phase, observers calibrated?): QAT_FROZEN reads calibrated observers
ELEMENTWISE_PHASES = [("FP32", False), ("QAT", False), ("FP32", True), ("QAT", True),
                      ("QAT_FROZEN", True)]


@pytest.mark.parametrize("phase,observed", ELEMENTWISE_PHASES,
                         ids=[f"{p}-{'calibrated' if o else 'fresh'}" for p, o in ELEMENTWISE_PHASES])
@pytest.mark.parametrize("name", sorted(ELEMENTWISE))
def test_elementwise_blocks_bit_equal(name, phase, observed):
    jmake, tmake, _ = ELEMENTWISE[name]
    jmode, tmode = MODES[phase]
    port = tmake()
    tree = _calibrated_tree(port, 3) if observed else _empty_tree(port)
    x = _elementwise_case(1)
    jy, upd, _, w = _jax_float(tree, x, jmake(), jmode, train=None)
    ty, state, _ = _port_float(port, tree, x, tmode, w)
    np.testing.assert_array_equal(ty, jy)
    for k, v in _observers(upd).items():
        np.testing.assert_array_equal(state[k], v, err_msg=k)


def test_elementwise_gradients_within_rounding():
    """The STE gradient through QHswish's two fake-quant sites and its mul:
    XLA contracts the product rule's two terms into one fused multiply-add,
    autograd rounds the product and the sum apart, so they differ by an ulp
    of the terms (2 float32 ulps of the largest gradient bound it)."""
    port = tblocks.QHswish()
    tree = _calibrated_tree(port, 4)
    x = _elementwise_case(2)

    def jf(v, xx, w):
        def loss(xx):
            y, _ = jblocks.QHswish().apply(v, xx, mode=jnn.QAT, mutable=["quant"])
            return jnp.sum(y * w)
        return jax.grad(loss)(xx)

    w = np.random.RandomState(7).randn(*x.shape).astype(np.float32)
    jg = np.asarray(jax.jit(jf)(jax_variables(tree), jnp.asarray(x), jnp.asarray(w)))
    from_jax_variables(port, tree)
    xt = torch.tensor(x, requires_grad=True)
    (port(xt, mode=tnn.QAT) * torch.as_tensor(w)).sum().backward()
    eps = float(np.finfo(np.float32).eps)
    np.testing.assert_allclose(xt.grad.numpy(), jg, rtol=0, atol=2 * eps * np.abs(jg).max())
    assert np.mean(xt.grad.numpy() == jg) > 0.5


def test_hswish_bf16_within_band_and_dtype():
    """bf16 QAT: the output stays bfloat16, as JAX's does (the weakly typed
    scalars keep the dtype; fake-quant computes in float32 and casts back)."""
    port = tblocks.QHswish()
    tree = _calibrated_tree(port, 5)
    x = _elementwise_case(3)
    jy = np.asarray(jax.jit(lambda v, xx: jblocks.QHswish().apply(
        v, xx, mode=jnn.QAT, mutable=["quant"])[0].astype(jnp.float32))(
        jax_variables(tree), jnp.asarray(x, jnp.bfloat16)))
    jdt = jax.eval_shape(lambda v, xx: jblocks.QHswish().apply(v, xx, mode=jnn.QAT,
                                                               mutable=["quant"])[0],
                         jax_variables(tree), jnp.asarray(x, jnp.bfloat16)).dtype
    from_jax_variables(port, tree)
    ty = port(torch.tensor(x).to(torch.bfloat16), mode=tnn.QAT)
    assert str(ty.dtype).split(".")[-1] == str(jdt) == "bfloat16"
    d = np.abs(ty.to(torch.float32).numpy() - jy)
    assert d.max() <= BF16_REL * (jy.max() - jy.min()), d.max()


# ---------------------------------------------------------------------------
# INT8 hard-swish and the ReLU6 edges
# ---------------------------------------------------------------------------

# (scale, zero point) of the input grid: 3/s below and above zp (the shifted
# zero point below 0 or not), 6/s + zp past 255 (saturated) or inside
HSWISH_GRIDS = [(0.004, 100), (0.0117, 20), (0.03, 128), (0.05, 30), (0.07, 200), (0.2, 250)]


@pytest.mark.parametrize("scale,zp", HSWISH_GRIDS)
def test_hswish_int8_bit_equal_at_relu6_edges(scale, zp):
    port = tblocks.QHswish()
    tree = _calibrated_tree(port, 6)
    q = np.arange(256, dtype=np.uint8).reshape(1, 4, 4, 16)

    def f(qq):
        out = jblocks.QHswish().apply(jax_variables(tree),
                                      JQTensor(qq, jnp.float32(scale), jnp.int32(zp)),
                                      mode=jnn.INT8)
        return out.q, out.scale, out.zero_point

    jq_, js, jz = jax.jit(f)(jnp.asarray(q))
    from_jax_variables(port, tree)
    grid = port.prepare_int8(QParams(float(np.float32(scale)), zp), "cpu")
    x = QTensor(torch.as_tensor(q), *QParams(float(np.float32(scale)), zp).tensors("cpu"))
    out = port(x, mode=tnn.INT8)
    np.testing.assert_array_equal(out.q.numpy(), np.asarray(jq_))
    assert grid.scale == float(js) and grid.zero_point == int(jz)
    lo, hi = tblocks.relu6_bounds(tnn.add_scalar(QParams(float(np.float32(scale)), zp), 3.0))
    assert (lo < 0) == (zp < round(3.0 / scale))
    assert (hi == 255) == (round(6.0 / scale) - round(3.0 / scale) + zp >= 255)


def test_relu6_bounds_cover_both_edges():
    """The grids above reach each edge of ``_relu6`` at least once."""
    bounds = [tblocks.relu6_bounds(tnn.add_scalar(QParams(float(np.float32(s)), z), 3.0))
              for s, z in HSWISH_GRIDS]
    assert any(lo < 0 for lo, _ in bounds) and any(lo >= 0 for lo, _ in bounds)
    assert any(hi == 255 for _, hi in bounds) and any(hi < 255 for _, hi in bounds)


@pytest.mark.parametrize("device_ops", [False, True], ids=["QParams", "QTensor"])
def test_scalar_ops_on_grids(device_ops):
    """add_scalar / mul_scalar / _relu6 on a QTensor (device tensors) and on
    its host grid (QParams) give JAX's zero point, scale and clamp."""
    for scale, zp in HSWISH_GRIDS:
        s = float(np.float32(scale))
        jx = JQTensor(jnp.arange(256, dtype=jnp.uint8), jnp.float32(scale), jnp.int32(zp))
        jsh = jax.jit(lambda q: jblocks._relu6(jq_add(q, scale, zp)))(jx.q)
        jm = jax.jit(lambda q: jnn.quant_ops.mul_scalar(
            JQTensor(q, jnp.float32(scale), jnp.int32(zp)), 1.0 / 6.0).scale)(jx.q)
        if device_ops:
            x = QTensor(torch.arange(256).to(torch.uint8), *QParams(s, zp).tensors("cpu"))
            sh = tblocks._relu6(tnn.add_scalar(x, 3.0))
            np.testing.assert_array_equal(sh.q.numpy(), np.asarray(jsh.q))
            assert int(sh.zero_point) == int(jsh.zero_point)
            assert float(tnn.mul_scalar(x, 1.0 / 6.0).scale) == float(jm)
        else:
            lo, hi = tblocks.relu6_bounds(tnn.add_scalar(QParams(s, zp), 3.0))
            got = np.clip(np.arange(256), lo, hi) if lo <= hi else np.full(256, hi)
            np.testing.assert_array_equal(got, np.asarray(jsh.q))
            assert lo == int(jsh.zero_point)
            assert tnn.mul_scalar(QParams(s, zp), 1.0 / 6.0).scale == float(jm)


def jq_add(q, scale, zp):
    return jnn.quant_ops.add_scalar(JQTensor(q, jnp.float32(scale), jnp.int32(zp)), 3.0)


# (route, cin, cout, kernel, stride, groups)
RELU6_ROUTES = [("matmul", 16, 24, 1, 1, 1), ("depthwise", 16, 16, 3, 2, 16),
                ("im2col", 3, 16, 3, 2, 1)]


@pytest.mark.parametrize("out_max", [3.0, 9.0], ids=["6-beyond-grid", "6-inside-grid"])
@pytest.mark.parametrize("route", RELU6_ROUTES, ids=lambda r: r[0])
def test_relu6_conv_int8_clamp_identity(route, out_max):
    """``quantize(clip(y, 0, 6))`` of the JAX epilogue equals the port's
    narrowed clamp ``[max(qmin, zp), min(qmax, q6)]`` on each INT8 route,
    where 6.0 lies beyond the output grid and where it lies inside it."""
    name, cin, cout, k, s, g = route
    port = tnn.QConvBNAct(cin, cout, k, strides=s, padding=(k - 1) // 2, groups=g, act="relu6")
    rng = np.random.RandomState(11)
    flat = {k_: v.detach().numpy().copy() for k_, v in model_variables(port).items()}
    flat["params/kernel"] = (rng.randn(*flat["params/kernel"].shape) * 0.6).astype(np.float32)
    flat["params/bias_bn"] = rng.uniform(-1, 3, cout).astype(np.float32)
    flat["quant/w_obs.min_val"], flat["quant/w_obs.max_val"] = np.float32(-1.5), np.float32(1.5)
    flat["quant/act_obs.min_val"] = np.float32(0.0)
    flat["quant/act_obs.max_val"] = np.float32(out_max)
    tree = unflatten_variables(flat)
    q = rng.randint(0, 256, (2, 9, 9, cin)).astype(np.uint8)
    in_s, in_zp = 0.03, 110

    jmod = jnn.QConvBNAct(cout, k, strides=s, padding=(k - 1) // 2, groups=g, act="relu6")
    jout = jax.jit(lambda qq: jmod.apply(jax_variables(tree), JQTensor(
        qq, jnp.float32(in_s), jnp.int32(in_zp)), mode=jnn.INT8).q)(jnp.asarray(q))
    from_jax_variables(port, tree)
    port.eval()
    grid = QParams(float(np.float32(in_s)), in_zp)
    out_grid = port.prepare_int8(grid, "cpu")
    assert port._route == name
    got = port(QTensor(torch.as_tensor(q), *grid.tensors("cpu")), mode=tnn.INT8).q.numpy()
    np.testing.assert_array_equal(got, np.asarray(jout))
    q6 = round(6.0 / out_grid.scale) + out_grid.zero_point
    assert (q6 <= 255) == (out_max > 6.0)
    assert got.max() == min(255, q6) and got.min() == out_grid.zero_point


# ---------------------------------------------------------------------------
# QDense, QSEModule, InvertedResidual, BottleneckV3
# ---------------------------------------------------------------------------

def _block_tree(port, seed, act_range=(-2.0, 6.0)):
    """Seeded variables: kernels, BN scales, shifts and running statistics,
    observers at ranges around the data's (weights by their max)."""
    rng = np.random.RandomState(seed)
    flat = {}
    items = sorted(model_variables(port).items())
    for k, v in items:
        shape = tuple(v.shape)
        leaf = k.rsplit("/", 1)[1]
        if leaf == "kernel":
            fan = int(np.prod(shape[:-1])) if shape[-2:] != (1, 1) else shape[0]
            flat[k] = (rng.randn(*shape) * np.sqrt(2.0 / max(fan, 1))).astype(np.float32)
        elif leaf == "scale":
            flat[k] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        elif leaf in ("bias_bn", "bias"):
            flat[k] = rng.normal(0.2, 0.3, shape).astype(np.float32)
        elif leaf == "mean":
            flat[k] = rng.normal(0, 0.1, shape).astype(np.float32)
        elif leaf == "var":
            flat[k] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        elif leaf.endswith(".min_val") or leaf.endswith(".max_val"):
            flat[k] = None  # below
        else:
            flat[k] = v.detach().numpy().copy()
    for k in list(flat):
        if k.endswith(".min_val"):
            base = k[:-len(".min_val")]
            if base.endswith("w_obs"):
                wk = "params/" + base[len("quant/"):-len("w_obs")] + "kernel"
                m = float(np.abs(flat[wk]).max()) if wk in flat else 1.0
                shape = model_variables(port)[k].shape
                flat[k] = np.full(shape, -m, np.float32)
                flat[base + ".max_val"] = np.full(shape, m, np.float32)
            else:
                lo, hi = act_range
                flat[k] = np.float32(lo * rng.uniform(0.5, 1.0))
                flat[base + ".max_val"] = np.float32(hi * rng.uniform(0.5, 1.0))
    return unflatten_variables(flat)


def _calibrate_jax(jmod, tree, xf, mode_kw):
    """Two QAT forwards in eval mode (observers on the folded graph)."""
    v = jax_variables(tree)
    observe = jax.jit(lambda vv, xx: jmod.apply(vv, xx, mode=jnn.QAT, mutable=["quant"],
                                                **mode_kw))
    for _ in range(2):
        _, upd = observe(v, jnp.asarray(xf))
        v = {**v, **upd}
    return unflatten_variables(flatten_variables(jax.tree.map(np.asarray, v)))


def _int8_compare(jmod, port, tree, q, grid, mode_kw, se_band=False):
    """(flips, max difference) of the port's INT8 codes against the frozen
    JAX block's, on codes ``q`` of ``grid``."""
    s, zp = grid
    jout = jax.jit(lambda qq: jmod.apply(jax_variables(tree), JQTensor(
        qq, jnp.float32(s), jnp.int32(zp)), mode=jnn.INT8, **mode_kw))(jnp.asarray(q))
    from_jax_variables(port, tree)
    port.eval()
    g = QParams(float(np.float32(s)), zp)
    out_grid = port.prepare_int8(g, "cpu")
    out = port(QTensor(torch.as_tensor(q), *g.tensors("cpu")), mode=tnn.INT8, **mode_kw)
    assert out_grid.scale == float(jout.scale) and out_grid.zero_point == int(jout.zero_point)
    d = np.abs(out.q.numpy().astype(np.int32) - np.asarray(jout.q).astype(np.int32))
    assert len(np.unique(np.asarray(jout.q))) > 8  # a varied output
    return int((d > 0).sum()), int(d.max()), d.size


# (name, kernel, stride, se, nl, cin, exp, cout)
V3_BLOCKS = [("re_k3_s1", 3, 1, False, "RE", 16, 48, 16), ("re_k5_s2_se", 5, 2, True, "RE", 16, 48, 24),
             ("hs_k3_s2", 3, 2, False, "HS", 16, 40, 24), ("hs_k5_s1_se", 5, 1, True, "HS", 24, 72, 24),
             ("hs_k3_s1_se_exp_eq_in", 3, 1, True, "HS", 16, 16, 16)]


def _v3_pair(cfg, dtype=torch.float32):
    name, k, s, se, nl, cin, exp, cout = cfg
    jmod = jblocks.BottleneckV3(out_channels=cout, exp_size=exp, kernel_size=k, strides=s, se=se,
                                nl=nl, dtype=jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    port = tblocks.BottleneckV3(cin, cout, exp, k, s, se=se, nl=nl, dtype=dtype)
    return jmod, port


# (name, cin, cout, stride, expand_ratio)
V2_BLOCKS = [("t1_s1", 16, 16, 1, 1), ("t6_s2", 16, 24, 2, 6), ("t6_s1_res", 24, 24, 1, 6)]


def _v2_pair(cfg, dtype=torch.float32):
    name, cin, cout, s, t = cfg
    jmod = jblocks.InvertedResidual(out_channels=cout, strides=s, expand_ratio=t,
                                    dtype=jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    return jmod, tblocks.InvertedResidual(cin, cout, strides=s, expand_ratio=t, dtype=dtype)


def _block_input(cin, seed, size=10):
    rng = np.random.RandomState(seed)
    q = rng.randint(0, 256, (2, size, size, cin)).astype(np.uint8)
    grid = (0.027, 97)
    xf = ((q.astype(np.float32) - grid[1]) * np.float32(grid[0])).astype(np.float32)
    return q, grid, xf


@pytest.mark.parametrize("cfg", V3_BLOCKS + V2_BLOCKS, ids=lambda c: c[0])
def test_block_int8_codes(cfg):
    """INT8 codes of each bottleneck against the frozen JAX block: bit-equal,
    or within ``SE_FLIP_FRACTION`` (one code) where a squeeze-excite is."""
    jmod, port = (_v3_pair if len(cfg) == 8 else _v2_pair)(cfg)
    cin = cfg[5] if len(cfg) == 8 else cfg[1]
    q, grid, xf = _block_input(cin, 21)
    tree = _calibrate_jax(jmod, _block_tree(port, 22), xf, {"train": False})
    flips, worst, n = _int8_compare(jmod, port, tree, q, grid, {"train": False})
    se = len(cfg) == 8 and cfg[3]
    if se:
        assert flips <= SE_FLIP_FRACTION * n and worst <= 1, (flips, worst, n)
    else:
        assert flips == 0, (flips, worst)


@pytest.mark.parametrize("cfg", V3_BLOCKS[1::2] + V2_BLOCKS[1:2], ids=lambda c: c[0])
@pytest.mark.parametrize("phase,train", [("FP32", True), ("QAT", True), ("QAT", False),
                                         ("QAT_FROZEN", False)])
def test_block_float_phases_within_bands(cfg, phase, train):
    jmod, port = (_v3_pair if len(cfg) == 8 else _v2_pair)(cfg)
    cin = cfg[5] if len(cfg) == 8 else cfg[1]
    _, _, xf = _block_input(cin, 31)
    tree = _calibrate_jax(jmod, _block_tree(port, 32), xf, {"train": False})
    jmode, tmode = MODES[phase]
    jy, upd, grads, w = _jax_float(tree, xf, jmod, jmode, train=train)
    ty, state, tgrads = _port_float(port, tree, xf, tmode, w, train=train)
    span = float(jy.max() - jy.min())
    d = np.abs(ty - jy)
    assert (d > REL_FLOAT * span).mean() <= FLIP_FRACTION, (d.max(), span)
    jflat = flatten_variables({"batch_stats": jax.tree.map(np.asarray, upd.get("batch_stats", {})),
                               "quant": jax.tree.map(np.asarray, upd.get("quant", {}))})
    for k, v in jflat.items():
        rng_ = float(np.max(np.abs(v))) + 1e-6
        assert np.max(np.abs(state[k] - v)) <= 0.05 * rng_, k


def test_dense_int8_folded_grid_and_band():
    """``QDense`` in INT8: the weight fake-quantized once on the folded
    grid, the output on the folded grid (IEEE ``1 / s``): the frozen JAX
    layer's values on ``QDense``'s own grid, within one quantum where the
    dense product's summation order decides, on few elements."""
    port = tblocks.QDense(96, 40, use_bias=True, act="relu")
    tree = _block_tree(port, 41, act_range=(0.0, 3.0))
    x = np.random.RandomState(42).randn(16, 96).astype(np.float32)
    jmod = jblocks.QDense(40, use_bias=True, act="relu")
    jy = np.asarray(jax.jit(lambda xx: jmod.apply(jax_variables(tree), xx, mode=jnn.INT8))(
        jnp.asarray(x)))
    from_jax_variables(port, tree)
    port.prepare_int8("cpu")
    with torch.no_grad():
        ty = port(torch.as_tensor(x), mode=tnn.INT8).numpy()
    scale, zp = jq.calculate_qparams(jax_variables(tree)["quant"]["act_obs"], jq.QNNPACK.activation)
    s = float(scale)
    d = np.abs(ty - jy)
    assert d.max() <= s * 1.0001 and (d > 0).mean() <= FLIP_FRACTION, (d.max(), s)
    # every output on the grid: (q - zp) * s exactly
    k = np.round(ty / s)
    np.testing.assert_array_equal((k * np.float32(s)).astype(np.float32), ty)
    # the traced qparams (the train step's) are another grid in general
    from frostnet_tpu_torch.quant import calculate_qparams_folded, calculate_qparams_traced
    st = port.act_obs.state()
    assert calculate_qparams_folded(st, get_qconfig("qnnpack").activation)[0] == np.float32(s)
    assert calculate_qparams_traced(st, get_qconfig("qnnpack").activation)[0] is not None


def test_se_module_int8_band():
    """The squeeze-excite alone in INT8: codes within one of JAX's, on few."""
    port = tblocks.QSEModule(48)
    q, grid, xf = _block_input(48, 51, size=14)
    jmod = jblocks.QSEModule()
    tree = _calibrate_jax(jmod, _block_tree(port, 52), xf, {})
    flips, worst, n = _int8_compare(jmod, port, tree, q, grid, {})
    assert flips <= SE_FLIP_FRACTION * n and worst <= 1, (flips, worst, n)


@pytest.mark.parametrize("cfg", V3_BLOCKS[3:4] + V2_BLOCKS[2:3], ids=lambda c: c[0])
def test_block_bf16_qat_within_band(cfg):
    """bf16 QAT (the benchmarked step's dtype): same output dtype as JAX
    (bf16 from a bottleneck), values within ``BF16_REL`` of the range on
    all but ``FLIP_FRACTION`` of the elements."""
    jmod, port = (_v3_pair if len(cfg) == 8 else _v2_pair)(cfg, torch.bfloat16)
    cin = cfg[5] if len(cfg) == 8 else cfg[1]
    _, _, xf = _block_input(cin, 61)
    tree = _calibrate_jax(jmod, _block_tree(port, 62), xf, {"train": False})
    v = jax_variables(tree)
    jy = jax.jit(lambda vv, xx: jmod.apply(vv, xx, mode=jnn.QAT, train=True,
                                           mutable=["batch_stats", "quant"])[0])(
        v, jnp.asarray(xf, jnp.bfloat16))
    from_jax_variables(port, tree)
    ty = port(torch.tensor(xf).to(torch.bfloat16), mode=tnn.QAT, train=True)
    assert str(ty.dtype).split(".")[-1] == str(jy.dtype)
    jy = np.asarray(jy.astype(jnp.float32))
    d = np.abs(ty.detach().to(torch.float32).numpy() - jy)
    span = float(jy.max() - jy.min())
    assert (d > BF16_REL * span).mean() <= FLIP_FRACTION, (d.max(), span)
