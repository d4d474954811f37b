"""PyTorch port, StatAssist + GradBoost optimizers: bit-exact to the JAX chain.

The JAX side is the optax chain jitted with the optimizer state, the
gradients and the parameters as runtime arguments, as the train step runs
it. XLA contracts the multiply-adds there (EMA, decay, momentum, update),
and the port rounds each of them once; the tests hold every parameter and
every EMA equal bit for bit over several steps. The noise phase is held
with the same draws injected into both packages (the JAX PRNG's bits
cannot be matched), and by its properties (tests/test_gradboost.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from frostnet_tpu import optim as jopt
from frostnet_tpu_torch import optim as topt

SHAPES = {"a_conv": (3, 3, 8, 16), "b_dw": (5, 5, 1, 24), "c_scale": (24,), "d_bias": (10,),
          "e_fc": (1, 1, 16, 10)}


def _params(seed=0):
    rng = np.random.RandomState(seed)
    return {k: (rng.randn(*s) * 0.3).astype(np.float32) for k, s in SHAPES.items()}


def _grads(step, seed=1):
    rng = np.random.RandomState(seed + step)
    return {k: (rng.randn(*s) * rng.choice([1e-3, 0.05, 1.0])).astype(np.float32)
            for k, s in SHAPES.items()}


def _jax_update(tx):
    @jax.jit
    def update(params, opt_state, grads):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    return update


def _torch_params():
    # dict order is the JAX tree's leaf order (sorted keys)
    return [torch.nn.Parameter(torch.as_tensor(v).clone()) for v in _params().values()]


def _set_grads(ps, grads):
    for p, g in zip(ps, grads.values()):
        p.grad = torch.as_tensor(g).clone()


def test_grouped_weight_decay_shape_rule():
    rule = topt.grouped_weight_decay(4e-5)
    assert rule(torch.zeros(3, 3, 8, 16)) == 4e-5
    assert rule(torch.zeros(5, 5, 1, 24)) == 0.0     # depthwise HWIO
    assert rule(torch.zeros(24)) == pytest.approx(4e-7)
    assert rule(torch.zeros(1, 1, 16, 10)) == 4e-5


@pytest.mark.parametrize("name,wd", [("QSGD", "grouped"), ("QSGD", 0.37), ("SGD", "grouped"),
                                     ("SGD", 0.0)])
def test_warmup_steps_match_jitted_jax(name, wd):
    """Warm-up (StatAssist) steps: GradBoost's EMAs and the parameters equal
    the jitted JAX chain bit for bit, step after step."""
    jwd = jopt.grouped_weight_decay(4e-5) if wd == "grouped" else wd
    twd = topt.grouped_weight_decay(4e-5) if wd == "grouped" else wd
    tx = jopt.get_optimizer(name, 0.04, weight_decay=jwd)
    params = {k: jnp.asarray(v) for k, v in _params().items()}
    opt_state = tx.init(params)
    update = _jax_update(tx)
    ps = _torch_params()
    opt = topt.get_optimizer(name, 0.04, weight_decay=twd)(ps)
    for step in range(6):
        grads = _grads(step)
        params, opt_state = update(params, opt_state, {k: jnp.asarray(v) for k, v in grads.items()})
        _set_grads(ps, grads)
        opt.step()
        for p, (k, want) in zip(ps, params.items()):
            np.testing.assert_array_equal(p.detach().numpy(), np.asarray(want), err_msg=k)
        if name == "QSGD":
            gb = opt_state[0]
            st = opt.state["group0"]
            for key, got in (("exp_min", st["exp_min"]), ("exp_max", st["exp_max"])):
                want = np.concatenate([np.asarray(v).reshape(-1)
                                       for v in getattr(gb, key).values()])
                np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{key} step {step}")


def test_qsgd_nesterov_matches_jitted_jax():
    tx = jopt.qsgd(0.1, momentum=0.8, weight_decay=1e-3, nesterov=True)
    params = {k: jnp.asarray(v) for k, v in _params().items()}
    opt_state = tx.init(params)
    update = _jax_update(tx)
    ps = _torch_params()
    opt = topt.QSGD(ps, lr=0.1, momentum=0.8, weight_decay=1e-3, nesterov=True)
    for step in range(3):
        grads = _grads(step)
        params, opt_state = update(params, opt_state, {k: jnp.asarray(v) for k, v in grads.items()})
        _set_grads(ps, grads)
        opt.step()
    for p, want in zip(ps, params.values()):
        np.testing.assert_array_equal(p.detach().numpy(), np.asarray(want))


class _Draws:
    """The same Laplace magnitudes and coins for both packages, in leaf order."""

    def __init__(self, seed):
        rng = np.random.RandomState(seed)
        self.lap = [np.abs(rng.laplace(size=s)).astype(np.float32) for s in SHAPES.values()]
        self.coin = [rng.rand(*s) < 0.5 for s in SHAPES.values()]

    def torch(self, params):
        return ([torch.as_tensor(v) for v in self.lap],
                [torch.as_tensor(v.astype(np.float32)) for v in self.coin])

    def patch_jax(self, monkeypatch):
        lap, coin = iter(self.lap), iter(self.coin)
        monkeypatch.setattr(jax.random, "laplace",
                            lambda key, shape, dtype=jnp.float32: -jnp.asarray(next(lap)))
        monkeypatch.setattr(jax.random, "bernoulli",
                            lambda key, p=0.5, shape=None: jnp.asarray(next(coin)))


@pytest.mark.parametrize("clip_by", [1e-3, 1e6])
def test_noise_phase_with_injected_draws_matches_jax(monkeypatch, clip_by):
    """After ``set_warmup(False)``: the same draws give the same boosted
    update, bit for bit (one warm-up step fills the EMAs first). The JAX
    Laplace draws are fed negative, so the ``abs`` of both packages is
    exercised."""
    tx = jopt.qsgd(0.04, weight_decay=jopt.grouped_weight_decay(4e-5), clip_by=clip_by,
                   noise_decay=0.3)
    params = {k: jnp.asarray(v) for k, v in _params().items()}
    opt_state = tx.init(params)
    ps = _torch_params()
    opt = topt.QSGD(ps, lr=0.04, weight_decay=topt.grouped_weight_decay(4e-5), clip_by=clip_by,
                    noise_decay=0.3)
    for step in range(3):
        grads = _grads(step)
        draws = _Draws(step)
        with monkeypatch.context() as m:
            draws.patch_jax(m)
            # traced anew each step, so the patched draws are this step's
            params, opt_state = _jax_update(tx)(params, opt_state,
                                                {k: jnp.asarray(v) for k, v in grads.items()})
        opt.noise_draws = draws.torch
        _set_grads(ps, grads)
        opt.step()
        for p, want in zip(ps, params.values()):
            np.testing.assert_array_equal(p.detach().numpy(), np.asarray(want), err_msg=str(step))
        if step == 0:
            opt_state = jopt.set_warmup(opt_state, False)
            topt.set_warmup(opt, False)
    assert opt.param_groups[0]["restart_step"] == int(opt_state[0].restart_step) == 2


def test_noise_phase_properties():
    """Bounded by clip_by, sign-aligned, zero where the coin lands 0 (about
    half), restart_step counting up (tests/test_gradboost.py:117)."""
    clip_by = 1e-3
    g = torch.full((1000,), 0.5)
    p = torch.nn.Parameter(torch.zeros(1000))
    opt = topt.QSGD([p], lr=1.0, momentum=0.0, clip_by=clip_by, seed=42)
    p.grad = g.clone()
    opt.step()                                   # warm-up: EMAs only
    assert torch.equal(p.detach(), -g)
    topt.set_warmup(opt, False)
    for sign in (1.0, -1.0):
        before = p.detach().clone()
        p.grad = g * sign
        opt.step()
        noise = -(p.detach() - before) - g * sign  # lr 1, no momentum: p -= g + noise
        assert (noise * sign >= -1e-9).all()
        assert (noise.abs() <= clip_by + 1e-6).all()
        frac_zero = (noise.abs() < 1e-9).float().mean()
        assert 0.3 < frac_zero < 0.7
    assert opt.param_groups[0]["restart_step"] == 2


def test_noise_decays_with_restart_step():
    """Amplitude scales by (1 - noise_decay) ** restart_step: with the same
    draws, noise_decay 0.5 halves it each step (tests/test_gradboost.py:141)."""
    g = torch.ones(4096)
    draws = (torch.as_tensor(np.abs(np.random.RandomState(0).laplace(size=4096))
                             .astype(np.float32)), torch.ones(4096))
    mags = []
    for restart in range(3):
        p = torch.nn.Parameter(torch.zeros(4096))
        opt = topt.QSGD([p], lr=1.0, momentum=0.0, clip_by=1e6, toss_coin=False,
                        noise_decay=0.5, noise_draws=lambda ps: ([draws[0]], [draws[1]]))
        group = opt.param_groups[0]
        group.update(gb_step=1000, restart_step=restart, is_warmup=False)
        opt.state["group0"].update(exp_min=torch.zeros(4096), exp_max=torch.ones(4096),
                                   wd=None, momentum_buffer=None)
        p.grad = g.clone()
        opt.step()
        assert group["restart_step"] == restart + 1
        mags.append(float((-p.detach() - g).abs().mean()))
    assert mags[0] > 0
    np.testing.assert_allclose(mags[1] / mags[0], 0.5, rtol=1e-5)
    np.testing.assert_allclose(mags[2] / mags[0], 0.25, rtol=1e-5)


def test_get_optimizer_and_set_warmup():
    ps = _torch_params()
    opt = topt.get_optimizer("QSGD", 0.04, weight_decay=topt.grouped_weight_decay(4e-5))(ps)
    assert isinstance(opt, topt.QSGD) and opt.param_groups[0]["is_warmup"]
    topt.set_warmup(opt, False)
    assert not opt.param_groups[0]["is_warmup"]
    assert isinstance(topt.get_optimizer("SGD", 0.1)(ps), topt.SGD)
    assert isinstance(topt.get_optimizer("QRMS", 0.1)(ps), topt.QRMS)
    with pytest.raises(ValueError, match="QRMS"):  # the message lists the names
        topt.get_optimizer("QRMSprop", 0.1)
