"""PyTorch port, quant core: bit-exact against frostnet_tpu.quant.

Also pins the requant arithmetic of the frozen graph that the port copies
(frostnet_tpu_torch/ops/requant.py): the single-rounding FMA helper, the
residual add's rounding, and the QuantStub, QAdd and QCat requant sites,
each against the JAX module frozen the way ``freeze`` freezes it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frostnet_tpu import nn as jnn
from frostnet_tpu import quant as jq
from frostnet_tpu.quant.qtensor import QTensor as JQTensor
from frostnet_tpu_torch import nn as tnn
from frostnet_tpu_torch import quant as tq
from frostnet_tpu_torch.ops.requant import fma_f32, reciprocal
from frostnet_tpu_torch.quant.export import from_jax_variables

SPECS = {"qnnpack_act": (jq.QNNPACK_ACT, tq.QNNPACK_ACT),
         "fbgemm_act": (jq.FBGEMM_ACT, tq.FBGEMM_ACT),
         "qnnpack_weight": (jq.QNNPACK_WEIGHT, tq.QNNPACK_WEIGHT),
         "fbgemm_weight": (jq.FBGEMM_WEIGHT, tq.FBGEMM_WEIGHT)}


def _observer_values(n, seed):
    rng = np.random.RandomState(seed)
    mags = rng.choice([1e-3, 0.05, 1.0, 7.0], n)
    mins = (-np.abs(rng.randn(n)) * mags).astype(np.float32)
    maxs = (np.abs(rng.randn(n)) * mags).astype(np.float32)
    mins[:8] = 0.0                      # all-positive ranges
    maxs[8:16] = 0.0                    # all-negative ranges
    mins[16:24] = maxs[16:24] = 0.0     # degenerate: the SCALE_EPS floor
    mins[24:32], maxs[24:32] = np.inf, -np.inf  # uninitialized
    return mins, maxs


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_calculate_qparams_matches_jax(spec):
    jspec, tspec = SPECS[spec]
    mins, maxs = _observer_values(4096, seed=len(spec))
    state = jq.ObserverState(jnp.asarray(mins), jnp.asarray(maxs))
    # freeze() folds qparams at compile time: close over the state
    js, jz = jax.jit(lambda: jq.calculate_qparams(state, jspec))()
    ts, tz = tq.calculate_qparams_folded(tq.ObserverState(torch.as_tensor(mins),
                                                   torch.as_tensor(maxs)), tspec)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    assert ts.dtype == torch.float32 and tz.dtype == torch.int32
    assert (ts.numpy()[16:24] == np.float32(tq.SCALE_EPS)).all()
    assert (ts.numpy()[24:32] == 1.0).all() and (tz.numpy()[24:32] == 0).all()


def test_calculate_qparams_scalar_and_fresh_observer():
    s, z = tq.calculate_qparams_folded(tq.init_observer(), tq.QNNPACK_ACT)
    assert float(s) == 1.0 and int(z) == 0 and s.dim() == 0
    s, z = tq.calculate_qparams_folded(tq.init_observer(5), tq.FBGEMM_WEIGHT)
    assert s.shape == (5,) and (z == 0).all()
    assert tq.SCALE_EPS == float(np.finfo(np.float32).eps)


@pytest.mark.parametrize("spec", ["qnnpack_act", "fbgemm_act", "qnnpack_weight"])
def test_quantize_ties_round_half_even(spec):
    jspec, tspec = SPECS[spec]
    scale, zp = np.float32(0.5), np.int32(3 if jspec.qmin == 0 else 0)
    # exact ties (k + 0.5) * scale land on both even and odd integers
    k = np.arange(-300, 300, dtype=np.float32)
    x = np.concatenate([(k + 0.5) * scale, k * scale,
                        np.random.RandomState(0).randn(10000).astype(np.float32) * 40])
    want = np.asarray(jax.jit(lambda: jq.quantize(jnp.asarray(x), jnp.float32(scale),
                                                  jnp.int32(zp), jspec))())
    got = tq.quantize(torch.as_tensor(x), torch.tensor(scale), torch.tensor(zp), tspec)
    assert got.dtype == tspec.storage_dtype
    np.testing.assert_array_equal(got.numpy(), want)
    # half to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2 (plus the zero point)
    ties = tq.quantize(torch.tensor([0.25, 0.75, 1.25]), torch.tensor(0.5), torch.tensor(zp), tspec)
    assert ties.tolist() == [int(zp) + 0, int(zp) + 2, int(zp) + 2]


def test_quantize_per_channel_and_dequantize():
    rng = np.random.RandomState(1)
    w = rng.randn(3, 3, 8, 16).astype(np.float32)
    s = (rng.rand(16) * 0.02 + 1e-3).astype(np.float32)
    z = np.zeros(16, np.int32)
    want = np.asarray(jax.jit(lambda: jq.quantize(jnp.asarray(w), jnp.asarray(s), jnp.asarray(z),
                                                  jq.FBGEMM_WEIGHT, channel_axis=-1))())
    got = tq.quantize(torch.as_tensor(w), torch.as_tensor(s), torch.as_tensor(z),
                      tq.FBGEMM_WEIGHT, channel_axis=-1)
    np.testing.assert_array_equal(got.numpy(), want)
    back = tq.dequantize(got.to(torch.int32), torch.as_tensor(s), torch.as_tensor(z), -1)
    jback = jq.dequantize(jnp.asarray(want, jnp.int32), jnp.asarray(s), jnp.asarray(z), -1)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jback))


def test_fold_bn_matches_jax():
    rng = np.random.RandomState(2)
    c = 64
    w = rng.randn(1, 1, 32, c).astype(np.float32)
    b = rng.randn(c).astype(np.float32)
    gamma, beta = (rng.rand(c) + 0.5).astype(np.float32), rng.randn(c).astype(np.float32)
    mean, var = rng.randn(c).astype(np.float32), (rng.rand(c) + 0.1).astype(np.float32)
    for bias in (b, None):
        jw, jb = jax.jit(lambda: jq.fold_bn(
            jnp.asarray(w), None if bias is None else jnp.asarray(bias), jnp.asarray(gamma),
            jnp.asarray(beta), jnp.asarray(mean), jnp.asarray(var), 1e-5))()
        tw, tb = tq.fold_bn(torch.as_tensor(w), None if bias is None else torch.as_tensor(bias),
                            torch.as_tensor(gamma), torch.as_tensor(beta),
                            torch.as_tensor(mean), torch.as_tensor(var), 1e-5)
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def test_fma_f32_rounds_once():
    """fma_f32 equals the exactly rounded a*b+c, including a case where a
    float64 sum rounded again to float32 (double rounding) is wrong."""
    from fractions import Fraction

    i = 3
    a = np.float32(1 + i * 2.0 ** -23)
    b = np.float32(-(1 - i * 2.0 ** -23) * 2.0 ** -24)
    c = np.float32(1 + 2.0 ** -23)
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    twice = np.float32(np.float64(a) * np.float64(b) + np.float64(c))
    once = fma_f32(torch.tensor([a]), torch.tensor([b]), torch.tensor([c]))[0].item()
    assert float(twice) == 1.0                       # the tie went to even: wrong
    assert once == float(np.float32(1 + 2.0 ** -23))  # above the tie: up
    assert abs(Fraction(once) - exact) < abs(Fraction(float(twice)) - exact)

    rng = np.random.RandomState(0)
    n = 3000
    a = (rng.randn(n) * 1e4).astype(np.float32)
    b = (rng.rand(n) * 1e-3).astype(np.float32)
    c = (-a.astype(np.float64) * b + rng.randn(n) * 1e-3).astype(np.float32)  # cancellation
    got = fma_f32(torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(c)).numpy()
    for k in range(n):
        e = Fraction(float(a[k])) * Fraction(float(b[k])) + Fraction(float(c[k]))
        lo = np.float32(float(e))  # nearest float32 of the float64 nearest e ...
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo, np.nextafter(lo, np.float32(np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - e),
                                         int(np.float32(v).view(np.int32)) & 1))
        assert got[k] == best, k


def test_xla_folds_division_into_reciprocal():
    """Why the port multiplies by f32(1/s): with ``s`` a compile-time
    constant (as under freeze) XLA computes ``x * (1/s)``, not ``x / s``."""
    x = (np.random.RandomState(0).randn(100000) * 100).astype(np.float32)
    s = np.float32(0.0123457)
    got = np.asarray(jax.jit(lambda v: v / jnp.asarray(s))(x))
    np.testing.assert_array_equal(got, x * np.float32(reciprocal(s)))
    assert (got != x / s).any()


def _jax_frozen(module, variables, *args):
    consts = jax.tree.map(jnp.asarray, variables)
    return np.asarray(jax.jit(lambda *a: module.apply(consts, *a, mode=jnn.INT8).q)(*args))


def _jax_served_qadd(jqc, obs, a, b, ga, gb):
    """The JAX QAdd as the frozen model runs it: the codes it adds are made
    in the same jitted program (there, by the producing layers' saturating
    uint8 converts, which XLA recomputes inside the add's fusion)."""
    consts = jax.tree.map(jnp.asarray, {"quant": obs})
    qmax = jqc.activation.qmax

    def fn(fa, fb):
        qa = jnp.clip(jnp.round(fa), 0, qmax).astype(jnp.uint8)
        qb = jnp.clip(jnp.round(fb), 0, qmax).astype(jnp.uint8)
        return jnn.QAdd(jqc).apply(consts, JQTensor(qa, *ga), JQTensor(qb, *gb),
                                   mode=jnn.INT8).q

    return np.asarray(jax.jit(fn)(jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32)))


def test_residual_add_rounding_follows_the_fusion():
    """XLA contracts the QAdd's first product into an FMA when the add reads
    its codes from memory, and contracts nothing when the codes are made in
    the same fusion, as in the frozen model: the port follows the latter.
    Both are pinned here on inputs where they differ."""
    jqc = jq.get_qconfig("qnnpack")
    rng = np.random.RandomState(3)
    obs = {"act": jq.ObserverState(np.float32(-3.1), np.float32(4.3))}
    shape = (8, 64, 64, 32)
    a = rng.randint(0, 256, shape).astype(np.uint8)
    b = rng.randint(0, 256, shape).astype(np.uint8)
    ga, gb = (np.float32(0.0313), np.int32(17)), (np.float32(0.0471), np.int32(127))
    loaded = _jax_frozen(jnn.QAdd(jqc), {"quant": obs},
                         JQTensor(jnp.asarray(a), *ga), JQTensor(jnp.asarray(b), *gb))
    served = _jax_served_qadd(jqc, obs, a, b, ga, gb)

    s_out, z_out = tq.calculate_qparams_folded(tq.ObserverState(torch.tensor(-3.1), torch.tensor(4.3)),
                                        tq.QNNPACK_ACT)
    mult = np.float32(reciprocal(s_out))
    xa = a.astype(np.float32) - np.float32(17)
    xb = b.astype(np.float32) - np.float32(127)

    def codes(y):
        return np.clip(np.rint(y * mult) + int(z_out), 0, 255).astype(np.uint8)

    fused = fma_f32(torch.as_tensor(xa), torch.full(shape, float(ga[0])),
                    torch.as_tensor(xb * gb[0])).numpy()
    np.testing.assert_array_equal(loaded, codes(fused))
    np.testing.assert_array_equal(served, codes(xa * ga[0] + xb * gb[0]))
    assert (loaded != served).any()


@pytest.mark.parametrize("backend", ["qnnpack", "fbgemm"])
def test_quant_stub_qadd_qcat_match_frozen_jax(backend):
    jqc, tqc = jq.get_qconfig(backend), tq.get_qconfig(backend)
    qmax = jqc.activation.qmax
    rng = np.random.RandomState(3)
    obs = {"act": jq.ObserverState(np.float32(-3.1), np.float32(4.3))}
    dev = torch.device("cpu")

    x = (rng.randn(8, 64, 64, 3) * 2).astype(np.float32)
    want = _jax_frozen(jnn.QuantStub(jqc), {"quant": obs}, jnp.asarray(x))
    stub = from_jax_variables(tnn.QuantStub(tqc), {"quant": obs})
    stub.prepare_int8(dev)
    np.testing.assert_array_equal(stub(torch.as_tensor(x), tnn.INT8).q.numpy(), want)

    shape = (8, 64, 64, 32)
    a = rng.randint(0, qmax + 1, shape).astype(np.uint8)
    b = rng.randint(0, qmax + 1, shape).astype(np.uint8)
    ga, gb = (np.float32(0.0313), np.int32(17)), (np.float32(0.0471), np.int32(qmax // 2))
    ja, jb = JQTensor(jnp.asarray(a), *ga), JQTensor(jnp.asarray(b), *gb)
    ta = tq.QTensor(torch.as_tensor(a), None, None)
    tb = tq.QTensor(torch.as_tensor(b), None, None)
    grids = [tq.QParams(float(s), int(z)) for s, z in (ga, gb)]

    want = _jax_served_qadd(jqc, obs, a, b, ga, gb)
    add = from_jax_variables(tnn.QAdd(tqc), {"quant": obs})
    add.prepare_int8(grids, dev)
    np.testing.assert_array_equal(add(ta, tb, tnn.INT8).q.numpy(), want)

    want = _jax_frozen(jnn.QCat(jqc), {"quant": obs}, [ja, jb])
    cat = from_jax_variables(tnn.QCat(tqc), {"quant": obs})
    cat.prepare_int8(grids, dev)
    np.testing.assert_array_equal(cat([ta, tb], tnn.INT8).q.numpy(), want)
