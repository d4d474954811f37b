"""Learning-rate schedules (``frostnet_tpu/optim/schedules.py``).

Each schedule is a host function ``step -> lr`` (a float32 value as a
Python float): the optimizers read it once a step, so the step needs no
device synchronisation. ``ReduceLROnPlateau`` is metric-driven host state.

Every value is the float32 value the jitted JAX schedule computes, because
the operations are those of XLA's optimized program, in its order:

* a division by a constant ``c`` is a multiply by ``f32(1 / c)``, and a chain
  of multiplies by constants is folded into one multiply by their float32
  product (``pi * cur / total`` is ``cur * (f32(pi) * f32(1 / total))``,
  ``base_lr * (1 + cos) / 2`` is ``(cos + 1) * (f32(base_lr) * 0.5)``);
* added integer constants are folded (``step - warmup + ...``); steps are
  exact in float32 below 2 ** 24;
* ``cos`` and ``pow`` are the C library's float32 ``cosf`` and ``powf``,
  which XLA's CPU backend calls, with results below the smallest normal
  float32 flushed to zero as XLA flushes them;
* a multiply that feeds an add or a subtract is contracted into one fused
  multiply-add (``1 - cur / total`` rounds once; of two products the
  subtract's first operand), as the CPU backend contracts it; other
  products and sums round on their own;
* ``x ** 2`` with a constant exponent is ``x * x``, ``x ** 1`` is ``x``.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
from typing import Sequence

import numpy as np

_F32 = np.float32
_TINY = np.finfo(np.float32).tiny


@functools.lru_cache(maxsize=None)
def _libm():
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    for name in ("cosf", "powf"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_float
        fn.argtypes = [ctypes.c_float] * (2 if name == "powf" else 1)
    return lib


def _ftz(x) -> np.float32:
    x = _F32(x)
    return _F32(0.0) * np.sign(x) if abs(x) < _TINY else x


def _cos(x) -> np.float32:
    return _ftz(_libm().cosf(float(x)))


def _pow(base, exponent) -> np.float32:
    return _ftz(_libm().powf(float(_F32(base)), float(_F32(exponent))))


def _pow_const(x, power) -> np.float32:
    """``x ** power`` for a constant ``power``: XLA squares for 2 and drops
    the power for 1 and 0."""
    if power in (0, 1, 2):
        return (_F32(1.0), _F32(x), _F32(x) * _F32(x))[int(power)]
    return _pow(x, power)


def _rcp(c) -> np.float32:
    """``f32(1 / c)``: XLA's rewrite of a division by the constant ``c``."""
    return _F32(1.0) / _F32(c)


def _mod(x: np.float32, c) -> np.float32:
    """``jnp.mod`` in float32 (floored remainder)."""
    c = _F32(c)
    r = _F32(np.fmod(x, c))
    return r + c if (r < 0 and r != 0) else r


def _fma(a, b, c) -> np.float32:
    """float32 ``a * b + c`` rounded once: the float64 product is exact, and
    the float64 sum rounded to odd rounds to float32 as the exact sum does."""
    p, c = np.float64(_F32(a)) * np.float64(_F32(b)), np.float64(_F32(c))
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    if err != 0 and (np.array(s).view(np.int64) & 1) == 0:
        s = np.nextafter(s, np.inf if err > 0 else -np.inf)
    return _F32(s)


def _warmup(x, warmup_steps, warmup_lr, base_lr) -> np.float32:
    """``warmup_lr + (base_lr - warmup_lr) * step / warmup_steps``, one fused
    multiply-add."""
    return _fma(x, _F32(base_lr - warmup_lr) * _rcp(warmup_steps), warmup_lr)


def _lr(fn):
    """Wrap ``fn(x: float32 step) -> float32`` as ``step -> float``."""
    def schedule(step):
        return float(fn(_F32(int(step))))
    return schedule


def warmup_cosine(base_lr, total_steps, warmup_steps=0, warmup_lr=0.0, restart_period=None):
    """Per-iteration cosine with a linear warm-up; ``restart_period`` restarts it."""
    total = (restart_period if restart_period is not None else total_steps) - warmup_steps
    arg = _F32(np.pi) * _rcp(total)
    half = _F32(base_lr / 2)

    def fn(x):
        if restart_period is not None:
            x = _mod(x, restart_period)
        if warmup_steps > 0 and x < warmup_steps:
            return _warmup(x, warmup_steps, warmup_lr, base_lr)
        return (_cos((x + _F32(-warmup_steps)) * arg) + _F32(1.0)) * half

    return _lr(fn)


def warmup_linear(base_lr, total_steps, warmup_steps=0, warmup_lr=0.0, restart_period=None):
    """Per-iteration linear decay with a linear warm-up."""
    total = (restart_period if restart_period is not None else total_steps) - warmup_steps
    inv = _rcp(total)

    def fn(x):
        if restart_period is not None:
            x = _mod(x, restart_period)
        if warmup_steps > 0 and x < warmup_steps:
            return _warmup(x, warmup_steps, warmup_lr, base_lr)
        return _fma(-(x + _F32(-warmup_steps)), inv, 1.0) * _F32(base_lr)

    return _lr(fn)


def warmup_step(base_lr, steps_per_epoch, warmup_steps=0, warmup_lr=0.0, decay_epochs=30,
                gamma=0.1):
    """Decay by ``gamma`` every ``decay_epochs`` epochs, after a linear warm-up."""
    per_epoch, per_decay = _rcp(steps_per_epoch), _rcp(decay_epochs)

    def fn(x):
        if warmup_steps > 0 and x < warmup_steps:
            return _warmup(x, warmup_steps, warmup_lr, base_lr)
        epoch = np.floor(x * per_epoch)
        return _pow(gamma, np.floor(epoch * per_decay)) * _F32(base_lr)

    return _lr(fn)


def multistep(base_lr, milestones: Sequence[int], gamma=0.1):
    """Decay by ``gamma`` at each milestone step."""
    ms = [_F32(m) for m in sorted(milestones)]

    def fn(x):
        return _pow(gamma, sum(x >= m for m in ms)) * _F32(base_lr)

    return _lr(fn)


def poly(base_lr, total_steps, power=0.9):
    """``base_lr * (1 - step / total_steps) ** power``."""
    inv = _rcp(total_steps)
    return _lr(lambda x: _pow_const(_fma(-x, inv, 1.0), power) * _F32(base_lr))


def linear(base_lr, total_steps):
    """``base_lr * (1 - step / total_steps)``."""
    inv = _rcp(total_steps)
    return _lr(lambda x: _fma(-x, inv, 1.0) * _F32(base_lr))


def cosine(base_lr, total_steps):
    """``base_lr * (1 + cos(pi * step / total_steps)) / 2``."""
    arg = _F32(np.pi) * _rcp(total_steps)
    half = _F32(base_lr) * _rcp(2)
    return _lr(lambda x: (_cos(x * arg) + _F32(1.0)) * half)


def _cyclic(x, min_lr, cycle_len, ms, gamma):
    n = sum((x >= m) and (m > 1) for m in ms)
    p = _pow(gamma, n)
    base = p * _F32(min_lr)
    if x < 1:  # epoch 0: the warm-up interval at min_lr
        return base
    return _fma(p, _F32(min_lr) * _F32(cycle_len), -(_mod(x + _F32(-1), cycle_len) * base))


def cyclic(min_lr, cycle_len=5, milestones: Sequence[int] = (51,), gamma=0.5):
    """Cyclic LR with warm restarts: within each cycle the lr ramps down from
    ``min_lr * cycle_len`` to ``min_lr``; ``min_lr`` decays by ``gamma`` at
    each milestone; the first epoch runs at ``min_lr``."""
    ms = [_F32(m) for m in sorted(milestones)]
    return _lr(lambda x: _cyclic(x, min_lr, cycle_len, ms, gamma))


def hybrid(base_lr, total_steps, clr_max, cycle_len=5):
    """Cyclic until ``clr_max``, then linear."""
    ms = [_F32(clr_max)]
    inv = _rcp(total_steps - clr_max + 1)

    def fn(x):
        if x < clr_max:
            return _cyclic(x, base_lr, cycle_len, ms, 1.0)
        return _fma(-(x + _F32(1 - clr_max)), inv, 1.0) * _F32(base_lr)

    return _lr(fn)


def _warm_poly(pos, base_lr, cycle, warmup_steps, power):
    if pos < warmup_steps:
        a, r = pos + _F32(1.0), _rcp(max(warmup_steps, 1))
        if power in (0, 1, 2):  # the constant factor r ** power joins base_lr
            return _pow_const(a, power) * (_pow_const(r, power) * _F32(base_lr))
        return _pow(a * r, power) * _F32(base_lr)
    down = _fma(-(pos + _F32(-warmup_steps)), _rcp(cycle - warmup_steps), 1.0)
    return _pow_const(down, power) * _F32(base_lr)


def warmup_poly(base_lr, total_steps, warmup_ratio=0.05, power=0.9):
    """Poly ramp-up for ``warmup_ratio`` of the steps, then poly decay."""
    warmup_steps = int(warmup_ratio * total_steps)
    return _lr(lambda x: _warm_poly(x, base_lr, total_steps, warmup_steps, power))


def warmup_poly_cycle(base_lr, total_steps, warmup_ratio=0.05, power=0.9, restart_ratio=0.5):
    """:func:`warmup_poly` restarted every ``restart_ratio * total_steps``."""
    cycle = max(int(total_steps * restart_ratio), 1)
    warmup_steps = int(warmup_ratio * cycle)
    return _lr(lambda x: _warm_poly(_mod(x, cycle), base_lr, cycle, warmup_steps, power))


def gan_linear(base_lr, n_epochs, n_epochs_decay, epoch_count=1):
    """Flat for ``n_epochs``, then linear decay to zero over ``n_epochs_decay``."""
    inv = _rcp(n_epochs_decay + 1)

    def fn(x):
        frac = _fma(-max(_F32(0.0), x + _F32(epoch_count - n_epochs)), inv, 1.0)
        return frac * _F32(base_lr)

    return _lr(fn)


class ReduceLROnPlateau:
    """Metric-driven decay: call ``.step(metric)`` once an epoch."""

    def __init__(self, base_lr, mode="min", factor=0.2, threshold=0.01, patience=5):
        self.lr = base_lr
        self.mode = mode
        self.factor = factor
        self.threshold = threshold
        self.patience = patience
        self.best = None
        self.bad_epochs = 0

    def step(self, metric: float) -> float:
        better = (
            self.best is None
            or (self.mode == "min" and metric < self.best * (1 - self.threshold))
            or (self.mode == "max" and metric > self.best * (1 + self.threshold))
        )
        if better:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr *= self.factor
                self.bad_epochs = 0
        return self.lr


_SCHEDULES = {
    "cos_lr": warmup_cosine,
    "linear_lr": warmup_linear,
    "step_lr": warmup_step,
    "multistep": multistep,
    "poly": poly,
    "linear": linear,
    "cosine": cosine,
    "clr": cyclic,
    "hybrid": hybrid,
    "warmpoly": warmup_poly,
    "warmpolycycle": warmup_poly_cycle,
    "gan_linear": gan_linear,
}


def get_lr_scheduler(name: str, **kwargs):
    """A schedule by the reference's names."""
    try:
        return _SCHEDULES[name](**kwargs)
    except KeyError:
        raise ValueError(f"unknown schedule {name!r}; options: {list(_SCHEDULES)}")
