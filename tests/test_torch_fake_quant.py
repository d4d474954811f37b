"""PyTorch port, the observe + fake-quant chain of training: bit-exact to JAX.

The JAX side runs as the train step runs it: jitted, with the observer
state and the data as runtime arguments (not closed over, as ``freeze``
does). XLA then rounds the chain in its own way, and the port follows:

* the observer's moving-average step is one fused multiply-add;
* the traced qparams multiply the range by ``f32(1 / (qmax - qmin))``
  (``f32(2 / (qmax - qmin))`` symmetric) where the folded ones divide, and
  keep the zero point's division;
* fake-quant multiplies by ``1 / scale``.

Each test feeds numpy-seeded inputs to both packages and compares bit for
bit: ``update_observer``, both qparams forms, the plain
``ops.fake_quant_observe`` (y, mask, new state, qparams) in float32 and
bfloat16, the STE gradient, and the TPU kernel's own function
(``fake_quant_observe`` in interpret mode) for a given scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frostnet_tpu import quant as jq
from frostnet_tpu.ops.pallas_fake_quant import fake_quant_observe as pallas_fake_quant_observe
from frostnet_tpu_torch import ops
from frostnet_tpu_torch import quant as tq
from frostnet_tpu_torch.nn import QAT, QAT_FROZEN, Observer
from frostnet_tpu_torch.ops.fake_quant import (ObservedFakeQuant, fake_quant_observe,
                                               fake_quant_observe_plain)

SPECS = {"qnnpack_act": (jq.QNNPACK_ACT, tq.QNNPACK_ACT),
         "fbgemm_act": (jq.FBGEMM_ACT, tq.FBGEMM_ACT),
         "qnnpack_weight": (jq.QNNPACK_WEIGHT, tq.QNNPACK_WEIGHT),
         "fbgemm_weight": (jq.FBGEMM_WEIGHT, tq.FBGEMM_WEIGHT)}
N_SITES = 48  # observer states per batch of sites


def _jax_update(jspec, channel_axis=None):
    return jax.jit(lambda mn, mx, x: tuple(jq.update_observer(
        jq.ObserverState(mn, mx), x, jspec, channel_axis)))


def _jax_qparams(jspec):
    return jax.jit(lambda mn, mx: jq.calculate_qparams(jq.ObserverState(mn, mx), jspec))


def _states(n, seed):
    """Observer states across magnitudes, with the edge cases of the
    qparams: all-positive, all-negative, degenerate (the SCALE_EPS floor)
    and uninitialized."""
    rng = np.random.RandomState(seed)
    mags = rng.choice([1e-3, 0.05, 1.0, 7.0], n)
    mins = (-np.abs(rng.randn(n)) * mags).astype(np.float32)
    maxs = (np.abs(rng.randn(n)) * mags).astype(np.float32)
    mins[:8] = 0.0
    maxs[8:16] = 0.0
    mins[16:24] = maxs[16:24] = 0.0
    mins[24:32], maxs[24:32] = np.inf, -np.inf
    return mins, maxs


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_traced_qparams_match_jitted_jax(spec):
    jspec, tspec = SPECS[spec]
    mins, maxs = _states(20000, seed=len(spec))
    js, jz = _jax_qparams(jspec)(mins, maxs)
    ts, tz = tq.calculate_qparams_traced(tq.ObserverState(torch.as_tensor(mins),
                                                          torch.as_tensor(maxs)), tspec)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    # the folded form (freeze's) is another function on the same states
    fs, _ = tq.calculate_qparams_folded(tq.ObserverState(torch.as_tensor(mins),
                                                         torch.as_tensor(maxs)), tspec)
    assert (fs != ts).any()
    assert (ts.numpy()[24:32] == 1.0).all() and (tz.numpy()[24:32] == 0).all()
    assert (ts.numpy()[16:24] == np.float32(tq.SCALE_EPS)).all()


@pytest.mark.parametrize("spec", ["qnnpack_act", "qnnpack_weight"])
def test_update_observer_matches_jitted_jax(spec):
    """Per-tensor states, stepped on batches: the moving average is one FMA
    (a twice-rounded step differs on about 2% of states), an uninitialized
    state snaps to the batch."""
    jspec, tspec = SPECS[spec]
    rng = np.random.RandomState(7)
    mins, maxs = _states(N_SITES, seed=11)
    upd = _jax_update(jspec)
    for i in range(N_SITES):
        x = (rng.randn(37, 29) * rng.choice([0.01, 1.0, 9.0]) + rng.randn()).astype(np.float32)
        jmin, jmax = upd(np.float32(mins[i]), np.float32(maxs[i]), x)
        st = tq.update_observer(tq.ObserverState(torch.tensor(mins[i]), torch.tensor(maxs[i])),
                                torch.as_tensor(x), tspec)
        assert float(st.min_val) == float(jmin) and float(st.max_val) == float(jmax)
        if not np.isfinite(mins[i]):
            assert float(st.min_val) == x.min() and float(st.max_val) == x.max()
    # the same on many scalar states at once (vectorized: one value per "batch")
    mins, maxs = _states(200000, seed=3)
    b = (np.random.RandomState(4).randn(2, 200000) * 3).astype(np.float32)
    bmin, bmax = b.min(0), b.max(0)
    jmin, jmax = _jax_update(jspec, channel_axis=-1)(mins, maxs, b)
    st = tq.update_observer(tq.ObserverState(torch.as_tensor(mins), torch.as_tensor(maxs)),
                            torch.as_tensor(b), tspec, channel_axis=-1)
    np.testing.assert_array_equal(st.min_val.numpy(), np.asarray(jmin))
    np.testing.assert_array_equal(st.max_val.numpy(), np.asarray(jmax))
    fin = np.isfinite(mins)
    with np.errstate(invalid="ignore"):
        two = mins + np.float32(0.01) * (bmin - mins)
    assert (two[fin] != np.asarray(jmin)[fin]).mean() > 0.005  # the FMA shows


def test_running_min_max_observer():
    """``averaging_constant=None``: plain running min/max."""
    spec_j = jq.QSpec(0, 255, False, averaging_constant=None)
    spec_t = tq.QSpec(0, 255, False, averaging_constant=None)
    mins, maxs = _states(1000, seed=5)
    b = (np.random.RandomState(6).randn(3, 1000) * 2).astype(np.float32)
    jmin, jmax = _jax_update(spec_j, channel_axis=-1)(mins, maxs, b)
    st = tq.update_observer(tq.ObserverState(torch.as_tensor(mins), torch.as_tensor(maxs)),
                            torch.as_tensor(b), spec_t, channel_axis=-1)
    np.testing.assert_array_equal(st.min_val.numpy(), np.asarray(jmin))
    np.testing.assert_array_equal(st.max_val.numpy(), np.asarray(jmax))


def _jax_site(jspec):
    """apply_observer's body with its STE mask: (y, mask, min, max, scale, zp)."""

    def site(mn, mx, x):
        st = jq.update_observer(jq.ObserverState(mn, mx), x, jspec)
        s, z = jq.calculate_qparams(st, jspec)
        y, vjp = jax.vjp(lambda v: jq.fake_quantize(v, s, z, jspec), x)
        (g,) = vjp(jnp.ones_like(y))
        return y, g != 0, st.min_val, st.max_val, s, z

    return jax.jit(site)


def _site_inputs(n, dtype, seed):
    rng = np.random.RandomState(seed)
    mins, maxs = _states(n, seed + 1)
    for i in range(n):
        shape = (2, 7 + i % 5, 9, 11 + (i % 3))  # ragged sizes: vector and tail paths
        x = rng.randn(*shape).astype(np.float32) * rng.choice([0.02, 1.0, 6.0])
        if i % 4 == 1:
            x = np.maximum(x, 0)  # a ReLU output
        yield mins[i], maxs[i], (x + rng.choice([0.0, 0.5])).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("spec", ["qnnpack_act", "fbgemm_act", "qnnpack_weight"])
def test_plain_fake_quant_observe_matches_jax(spec, dtype):
    jspec, tspec = SPECS[spec]
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                           torch.bfloat16)
    site = _jax_site(jspec)
    for mn, mx, x in _site_inputs(N_SITES, dtype, seed=len(spec)):
        xt = torch.as_tensor(x).to(tdt)
        xj = jnp.asarray(x).astype(jdt)
        jy, jm, jmin, jmax, js, jz = site(jnp.float32(mn), jnp.float32(mx), xj)
        y, mask, st, s, z = fake_quant_observe_plain(
            xt, tq.ObserverState(torch.tensor(mn), torch.tensor(mx)), tspec)
        assert y.dtype == tdt and mask.dtype == torch.bool
        np.testing.assert_array_equal(y.to(torch.float32).numpy(),
                                      np.asarray(jy.astype(jnp.float32)))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))
        assert float(st.min_val) == float(jmin) and float(st.max_val) == float(jmax)
        assert float(s) == float(js) and int(z) == int(jz)


def test_wrapper_on_cpu_updates_state_in_place_and_launches_nothing():
    spec = tq.QNNPACK_ACT
    ops.reset_launch_counts()
    obs = Observer()
    for _, _, x in _site_inputs(6, "float32", seed=9):
        xt = torch.as_tensor(x)
        py, pmask, pst, _, _ = fake_quant_observe_plain(xt, obs.state(), spec)
        y, mask, qp = fake_quant_observe(xt, obs.min_val, obs.max_val, spec)
        assert torch.equal(y, py) and torch.equal(mask, pmask)
        assert torch.equal(obs.min_val, pst.min_val) and torch.equal(obs.max_val, pst.max_val)
        assert qp.shape == (2,)
        s, z = tq.calculate_qparams_traced(obs.live(), spec)
        assert float(qp[0]) == float(s) and float(qp[1]) == float(z)
        # QAT_FROZEN: the quantize pass alone, on the state as it is
        before = obs.state()
        y2, mask2, none = fake_quant_observe(xt, obs.min_val, obs.max_val, spec, observe=False)
        assert none is None and torch.equal(y2, y) and torch.equal(mask2, mask)
        assert torch.equal(obs.state().min_val, before.min_val)
    assert ops.launch_counts()["fake_quant_observe"] == 0
    with pytest.raises(TypeError):
        fake_quant_observe(torch.zeros(4, dtype=torch.int32), obs.min_val, obs.max_val, spec)
    with pytest.raises(ValueError):  # per-channel state: not a per-tensor site
        fake_quant_observe(torch.zeros(4), torch.zeros(4), torch.zeros(4), spec)


@pytest.mark.parametrize("mode", ["qat", "qat_frozen"])
def test_ste_gradient_matches_jax(mode):
    """The autograd op of a site (kernel forward, STE backward) against
    jax.grad of apply_observer + fake_quantize, through a loss that weights
    every element differently."""
    jspec, tspec = SPECS["qnnpack_act"]
    rng = np.random.RandomState(2)
    x = (rng.randn(4, 9, 9, 16) * 3).astype(np.float32)
    w = rng.randn(*x.shape).astype(np.float32)
    mn, mx = np.float32(-1.5), np.float32(2.0)  # many elements clip

    def jloss(v, a, b):
        st = jq.ObserverState(a, b)
        if mode == "qat":
            st = jq.update_observer(st, v, jspec)
        s, z = jq.calculate_qparams(st, jspec)
        return jnp.sum(jq.fake_quantize(v, s, z, jspec) * w)

    jg = np.asarray(jax.jit(jax.grad(jloss))(x, mn, mx))
    obs = Observer()
    obs.min_val.fill_(float(mn))
    obs.max_val.fill_(float(mx))
    xt = torch.as_tensor(x).requires_grad_(True)
    y = ObservedFakeQuant.apply(xt, obs, tspec, mode == "qat")
    (y * torch.as_tensor(w)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), jg)
    assert (jg == 0).any() and (jg != 0).any()


def test_quantize_pass_matches_the_tpu_kernel_for_a_given_scale():
    """The TPU kernel's function (interpret mode): for a given (scale, zp),
    y and the mask equal the port's quantize pass, and its min/max the
    port's batch statistics (mirrors tests/test_pallas_fake_quant.py)."""
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 13, 17, 5) * 3).astype(np.float32)
    scale, zp = np.float32(0.0213), np.int32(7)
    y, mn, mx = pallas_fake_quant_observe(jnp.asarray(x), jnp.float32(scale), jnp.int32(zp),
                                          0, 255, True)
    ty, tmask = tq.fake_quant.fake_quant_forward(torch.as_tensor(x), torch.tensor(scale),
                                                 torch.tensor(zp), 0, 255)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(y))
    bmin, bmax = tq.batch_min_max(torch.as_tensor(x))
    assert float(bmin) == float(mn) and float(bmax) == float(mx)

    def jloss(v):
        out, _, _ = pallas_fake_quant_observe(v, jnp.float32(scale), jnp.int32(zp), 0, 255, True)
        return jnp.sum(out)

    jmask = np.asarray(jax.grad(jloss)(jnp.asarray(x))) != 0
    np.testing.assert_array_equal(tmask.numpy(), jmask)


def test_observed_fake_quant_per_channel_weights():
    """fbgemm weights: per-channel observers and fake-quant in torch ops."""
    from frostnet_tpu_torch.nn.quant_ops import observed_fake_quant

    jspec, tspec = SPECS["fbgemm_weight"]
    rng = np.random.RandomState(3)
    w = (rng.randn(3, 3, 8, 16) * 0.2).astype(np.float32)

    def jsite(v, a, b):
        st = jq.update_observer(jq.ObserverState(a, b), v, jspec, -1)
        s, z = jq.calculate_qparams(st, jspec)
        return jq.fake_quantize(v, s, z, jspec, -1), st.min_val, st.max_val

    mins = np.full(16, np.inf, np.float32)
    maxs = np.full(16, -np.inf, np.float32)
    jy, jmin, jmax = jax.jit(jsite)(w, mins, maxs)
    obs = Observer(16)
    y = observed_fake_quant(torch.as_tensor(w), obs, tspec, QAT, channel_axis=-1)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(obs.min_val.numpy(), np.asarray(jmin))
    np.testing.assert_array_equal(obs.max_val.numpy(), np.asarray(jmax))
    y2 = observed_fake_quant(torch.as_tensor(w), obs, tspec, QAT_FROZEN, channel_axis=-1)
    assert torch.equal(y2, y)
