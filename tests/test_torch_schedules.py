"""PyTorch port, LR schedules: bit-exact to the jitted JAX schedules.

Each JAX schedule runs under ``jax.jit`` with the step an int32 argument,
as the optimizer chain calls it inside the train step; the port's host
function must give the same float32 at every step of a range that crosses
the warm-up, the restarts, the milestones and the end of the schedule.
XLA's float32 ``cos`` and ``pow`` on the CPU are the C library's ``cosf``
and ``powf``, which the port calls too: the largest difference is 0 ulp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from frostnet_tpu.optim import schedules as js
from frostnet_tpu_torch.optim import schedules as ts

CASES = [
    ("cos_lr", dict(base_lr=0.04, total_steps=300, warmup_steps=10, warmup_lr=1e-4)),
    ("cos_lr", dict(base_lr=0.1, total_steps=97)),
    ("cos_lr", dict(base_lr=0.04, total_steps=300, warmup_steps=7, warmup_lr=1e-4,
                    restart_period=45)),
    ("cos_lr", dict(base_lr=0.04, total_steps=16)),
    ("linear_lr", dict(base_lr=0.04, total_steps=300, warmup_steps=10, warmup_lr=1e-4)),
    ("linear_lr", dict(base_lr=0.3, total_steps=123, warmup_steps=0, restart_period=41)),
    ("step_lr", dict(base_lr=0.04, steps_per_epoch=7, warmup_steps=10, warmup_lr=1e-4,
                     decay_epochs=2.4, gamma=0.97)),
    ("step_lr", dict(base_lr=0.1, steps_per_epoch=3, decay_epochs=30, gamma=0.1)),
    ("multistep", dict(base_lr=0.1, milestones=[90, 30, 60], gamma=0.1)),
    ("multistep", dict(base_lr=1e-3, milestones=[5, 7, 50, 51], gamma=0.5)),
    ("poly", dict(base_lr=0.01, total_steps=300, power=0.9)),
    ("poly", dict(base_lr=0.03, total_steps=250, power=2.0)),
    ("poly", dict(base_lr=0.03, total_steps=250, power=1.0)),
    ("linear", dict(base_lr=0.01, total_steps=299)),
    ("cosine", dict(base_lr=0.007, total_steps=300)),
    ("clr", dict(min_lr=1e-3, cycle_len=5, milestones=(51,), gamma=0.5)),
    ("clr", dict(min_lr=3e-4, cycle_len=7, milestones=(1, 20, 90), gamma=0.3)),
    ("hybrid", dict(base_lr=1e-3, total_steps=300, clr_max=60, cycle_len=5)),
    ("warmpoly", dict(base_lr=0.01, total_steps=300, warmup_ratio=0.05, power=0.9)),
    ("warmpoly", dict(base_lr=0.02, total_steps=10, warmup_ratio=0.05, power=0.9)),
    ("warmpoly", dict(base_lr=0.02, total_steps=290, warmup_ratio=0.1, power=1.0)),
    ("warmpolycycle", dict(base_lr=0.01, total_steps=300, warmup_ratio=0.05, power=0.9,
                           restart_ratio=0.5)),
    ("warmpolycycle", dict(base_lr=0.05, total_steps=211, warmup_ratio=0.1, power=2.0,
                           restart_ratio=0.3)),
    ("gan_linear", dict(base_lr=2e-4, n_epochs=100, n_epochs_decay=100, epoch_count=1)),
    ("gan_linear", dict(base_lr=2e-4, n_epochs=30, n_epochs_decay=70, epoch_count=5)),
]


@pytest.mark.parametrize("name,kwargs", CASES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_schedule_matches_jitted_jax(name, kwargs):
    steps = np.arange(0, 320, dtype=np.int32)
    jitted = jax.jit(js.get_lr_scheduler(name, **kwargs))
    want = np.array([jitted(jnp.int32(s)) for s in steps], np.float32)
    sched = ts.get_lr_scheduler(name, **kwargs)
    got = np.array([sched(int(s)) for s in steps], np.float32)
    bad = np.nonzero(got.view(np.int32) != want.view(np.int32))[0]
    assert bad.size == 0, (f"steps {bad[:8].tolist()}: port {got[bad[:4]].tolist()} "
                           f"JAX {want[bad[:4]].tolist()}")
    assert isinstance(sched(3), float)


@pytest.mark.parametrize("mode", ["min", "max"])
def test_plateau_matches_jax(mode):
    rng = np.random.RandomState(3)
    metrics = np.cumsum(rng.randn(60)) * 0.1 + 5.0
    a = js.ReduceLROnPlateau(0.1, mode=mode, factor=0.5, threshold=0.01, patience=2)
    b = ts.ReduceLROnPlateau(0.1, mode=mode, factor=0.5, threshold=0.01, patience=2)
    lrs = [(a.step(float(m)), b.step(float(m))) for m in metrics]
    assert all(x == y for x, y in lrs)
    assert len({x for x, _ in lrs}) > 1  # the lr did decay


def test_unknown_schedule_raises():
    with pytest.raises(ValueError, match="cos_lr"):
        ts.get_lr_scheduler("nope", base_lr=0.1)
