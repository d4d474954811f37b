"""PyTorch port, every optimizer of the JAX package against its jitted optax chain.

The JAX side is the chain jitted with the optimizer state, the gradients and
the parameters as runtime arguments, as the train step runs it
(``tests/test_torch_gradboost.py`` holds SGD and QSGD the same way). Each of
the 10 names runs with a float weight decay and with
``grouped_weight_decay``, the Adam family also with ``amsgrad``, and each
with a ``cos_lr`` schedule in place of the float lr: six StatAssist warm-up
steps, every parameter equal bit for bit after each. The GradBoost names
then run the noise phase with the same Laplace draws and coins injected into
both packages (the JAX PRNG's bits cannot be matched).

RMSTF is the one exception to bit equality: XLA's CPU ``rsqrt`` is the
hardware estimate refined by two Newton steps and the port takes the
correctly rounded ``1 / sqrt`` (the two differ by at most 1 ulp). Its
parameters are held within ``RMSTF_ULP`` float32 ulps of each tensor's
largest magnitude; the largest difference seen over the six steps is 1 ulp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from frostnet_tpu import optim as jopt
from frostnet_tpu_torch import optim as topt
from _torch_port import few_threads  # noqa: F401 - a fixture

pytestmark = pytest.mark.usefixtures("few_threads")

SHAPES = {"a_conv": (3, 3, 8, 16), "b_dw": (5, 5, 1, 24), "c_scale": (24,), "d_bias": (10,),
          "e_fc": (1, 1, 16, 10)}
NAMES = ["SGD", "RMS", "Adam", "AdamW", "QSGD", "QRMS", "QAdam", "QAdamW", "QAdamN", "RMSTF"]
BOOSTED = [n for n in NAMES if n.startswith("Q")]
RMSTF_ULP = 1


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


def _cases():
    out = []
    for name in NAMES:
        for wd in (0.013, "grouped"):
            out.append((name, wd, False, False))
        if name in ("Adam", "AdamW", "QAdam", "QAdamW"):
            out.append((name, 0.013, True, False))
        out.append((name, "grouped", False, True))
    return out


def _pair(name, wd, amsgrad, schedule, **extra):
    """(JAX transform, port factory) with the same hyper-parameters."""
    jwd = jopt.grouped_weight_decay(4e-3) if wd == "grouped" else wd
    twd = topt.grouped_weight_decay(4e-3) if wd == "grouped" else wd
    kw = dict(amsgrad=True) if amsgrad else {}
    kw.update(extra)
    sched = dict(base_lr=0.04, total_steps=9, warmup_steps=2, warmup_lr=1e-3)
    jlr = jopt.get_lr_scheduler("cos_lr", **sched) if schedule else 0.04
    tlr = topt.get_lr_scheduler("cos_lr", **sched) if schedule else 0.04
    return (jopt.get_optimizer(name, jlr, weight_decay=jwd, **kw),
            topt.get_optimizer(name, tlr, weight_decay=twd, **kw))


def _check(name, ps, params, what):
    for p, (k, want) in zip(ps, params.items()):
        got, want = p.detach().numpy(), np.asarray(want)
        if name == "RMSTF":
            # ulps at the tensor's largest magnitude: near-zero entries, where
            # the update cancels the parameter, would count ulps of nothing
            ulp = np.spacing(np.max(np.abs(want)).astype(np.float32))
            err = float(np.max(np.abs(got - want)) / ulp)
            assert err <= RMSTF_ULP, f"{what} {k}: {err} ulp"
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"{what} {k}")


@pytest.mark.parametrize("name,wd,amsgrad,schedule", _cases(),
                         ids=lambda v: str(v) if not isinstance(v, bool) else ("y" if v else "n"))
def test_warmup_steps_match_jitted_jax(name, wd, amsgrad, schedule):
    """Six StatAssist warm-up steps: the parameters equal the jitted JAX
    chain's after every step."""
    jtx, factory = _pair(name, wd, amsgrad, schedule)
    params = {k: jnp.asarray(v) for k, v in _params().items()}
    opt_state = jtx.init(params)
    update = _jax_update(jtx)
    ps = [torch.nn.Parameter(torch.as_tensor(v).clone()) for v in _params().values()]
    opt = factory(ps)
    for step in range(6):
        grads = _grads(step)
        params, opt_state = update(params, opt_state, {k: jnp.asarray(v) for k, v in grads.items()})
        for p, g in zip(ps, grads.values()):
            p.grad = torch.as_tensor(g).clone()
        opt.step()
        _check(name, ps, params, f"step {step}")
    assert opt.param_groups[0]["count"] == 6


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


@pytest.mark.parametrize("schedule", [False, True], ids=["const", "cos_lr"])
@pytest.mark.parametrize("name", BOOSTED)
def test_noise_phase_with_injected_draws_matches_jax(monkeypatch, name, schedule):
    """Two warm-up steps, ``set_warmup(False)``, then four noise steps with
    the same draws in both packages: the parameters agree bit for bit."""
    jtx, factory = _pair(name, "grouped", False, schedule, noise_decay=0.3, clip_by=0.02)
    params = {k: jnp.asarray(v) for k, v in _params().items()}
    opt_state = jtx.init(params)
    ps = [torch.nn.Parameter(torch.as_tensor(v).clone()) for v in _params().values()]
    opt = factory(ps)
    for step in range(6):
        if step == 2:
            opt_state = jopt.set_warmup(opt_state, False)
            topt.set_warmup(opt, False)
        grads = _grads(step)
        draws = _Draws(step)
        with monkeypatch.context() as m:
            draws.patch_jax(m)
            # traced anew each step, so the patched draws are this step's
            params, opt_state = _jax_update(jtx)(params, opt_state,
                                                 {k: jnp.asarray(v) for k, v in grads.items()})
        opt.noise_draws = draws.torch
        for p, g in zip(ps, grads.values()):
            p.grad = torch.as_tensor(g).clone()
        opt.step()
        _check(name, ps, params, f"step {step}")
    group = opt.param_groups[0]
    assert (group["gb_step"], group["restart_step"], group["count"]) == (6, 4, 6)


def test_noise_changes_the_update():
    """The noise phase moves the parameters off the noiseless trajectory
    (so the injected-draw test above checks a non-zero noise)."""
    runs = []
    for warm in (True, False):
        p = torch.nn.Parameter(torch.zeros(512))
        opt = topt.QAdam([p], lr=0.01, clip_by=1.0, noise_decay=0.0)
        p.grad = torch.linspace(-1, 1, 512)
        opt.step()
        topt.set_warmup(opt, warm)
        opt.step()
        runs.append(p.detach().clone())
    assert not torch.equal(runs[0], runs[1])


def test_param_ema_matches_jitted_jax():
    """``param_ema`` at decay 0.9999 over five updates: bit for bit with the
    jitted JAX ``param_ema`` (XLA contracts ``decay * e + (1 - decay) * p``)."""
    jinit, jupdate = jopt.param_ema(0.9999)
    tinit, tupdate = topt.param_ema(0.9999)
    params = _params()
    jst = jinit({k: jnp.asarray(v) for k, v in params.items()})
    tst = tinit({k: torch.as_tensor(v) for k, v in params.items()})
    jup = jax.jit(jupdate)
    for step in range(5):
        new = {k: v + _grads(step)[k] for k, v in params.items()}
        jst = jup(jst, {k: jnp.asarray(v) for k, v in new.items()})
        tst = tupdate(tst, {k: torch.as_tensor(v) for k, v in new.items()})
        for k in params:
            np.testing.assert_array_equal(tst.ema[k].numpy(), np.asarray(jst.ema[k]), err_msg=k)


def test_unknown_optimizer_lists_the_names():
    with pytest.raises(ValueError, match="QAdamN"):
        topt.get_optimizer("Lion", 0.1)


def test_train_step_ema_matches_the_jitted_jax_step():
    """The EMA of the train step at ``ema_decay=0.9999``: inside the jitted
    JAX step (``frostnet_tpu.train.state.make_train_step``, here on a small
    two-layer model so that it compiles in seconds) XLA contracts
    ``decay * e + (1 - decay) * p`` into ``fma(e, decay, p * (1 - decay))``.
    ``ema_update`` of the EMA before a JAX step and the parameters after it
    gives that step's EMA bit for bit (the two roundings differ in about a
    quarter of the elements at this decay; the same holds on the JAX
    FrostNet step), and the port's step applies ``ema_update`` to its own
    parameters."""
    import flax.linen as fnn

    from frostnet_tpu.nn import FP32 as JFP32
    from frostnet_tpu.train.state import create_train_state as jax_state
    from frostnet_tpu.train.state import make_train_step as jax_step
    from frostnet_tpu_torch.models import create_model
    from frostnet_tpu_torch.nn import FP32
    from frostnet_tpu_torch.train import create_train_state, make_train_step

    class Tiny(fnn.Module):
        @fnn.compact
        def __call__(self, x, mode=None, train=False):
            x = fnn.relu(fnn.Dense(64)(x.reshape(x.shape[0], -1)))
            return fnn.Dense(10)(x)

    decay = 0.9999
    rng = np.random.RandomState(0)
    batches = [{"image": rng.randn(2, 32, 32, 3).astype(np.float32),
                "label": np.array([1, 2], np.int32)} for _ in range(2)]
    tx = jopt.get_optimizer("QSGD", 0.04, weight_decay=jopt.grouped_weight_decay(4e-5))
    st = jax_state(Tiny(), tx, jax.random.PRNGKey(0), jnp.asarray(batches[0]["image"]),
                   ema_decay=decay)
    step = jax_step(Tiny(), JFP32, num_classes=10, ema_decay=decay, donate=False)
    differ = 0
    for b in batches:
        st = st.replace(ema=jax.tree.map(lambda e: e * 1.01 + 1e-3, st.ema))  # e != p
        before = [np.asarray(e) for e in jax.tree.leaves(st.ema)]
        st, _ = step(st, {k: jnp.asarray(v) for k, v in b.items()})
        for e0, p, want in zip(before, jax.tree.leaves(st.params), jax.tree.leaves(st.ema)):
            e = torch.as_tensor(e0).clone()
            topt.ema_update(e, torch.as_tensor(np.asarray(p)), decay)
            np.testing.assert_array_equal(e.numpy(), np.asarray(want))
            differ += int(np.count_nonzero(
                e0 * np.float32(decay) + np.asarray(p) * np.float32(1 - decay) != want))
    assert differ > 0  # the uncontracted rounding would have failed

    port = create_model("frostnet_quant_small_0_35", num_classes=10)
    state = create_train_state(port, topt.get_optimizer("QSGD", 0.04), device="cpu",
                               ema_decay=decay)
    pstep = make_train_step(FP32, num_classes=10, ema_decay=decay)
    for b in batches:
        for e in state.ema.values():
            e.mul_(1.01).add_(1e-3)
        before = {n: e.clone() for n, e in state.ema.items()}
        pstep(state, b)
        for n, p in state.model.named_parameters():
            topt.ema_update(before[n], p, decay)
            assert torch.equal(state.ema[n], before[n]), n
