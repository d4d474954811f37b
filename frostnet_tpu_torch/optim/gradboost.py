"""StatAssist + GradBoost: the SGD and QSGD optimizers of the JAX package.

``frostnet_tpu/optim/gradboost.py`` chains optax transforms; here each
optimizer is a ``torch.optim.Optimizer`` that applies the same chain, in the
same order, to the whole parameter group at once (flattened into one
float32 vector per step, so a step is a few dozen device ops whatever the
parameter count):

* QSGD: GradBoost, then weight decay, then heavy-ball momentum, then
  ``-lr`` (``qsgd``, ``gradboost.py:174-182``); SGD the same without
  GradBoost.
* GradBoost (``gradboost.py:45-112``): per-element EMAs of the running min
  and max of ``|g|``, ``m <- (beta * m + (1 - beta) * min(m, |g|)) / bc1``
  with ``bc1 = 1 - beta ** step`` (the reference's compound bias
  correction); after the warm-up, sign-aligned, coin-masked ``|Laplace(0,
  1)|`` noise scaled by ``(exp_max - exp_min) * (1 - noise_decay) **
  restart_step`` and clipped to ``+-clip_by`` is added to the gradient.
  :func:`set_warmup` ends the StatAssist warm-up.
* Weight decay is a float (plain L2) or :func:`grouped_weight_decay`.

Rounding follows the jitted JAX step, where XLA contracts multiply-adds:
the EMA is ``fma(beta, m, (1 - beta) * min(m, |g|)) / bc1`` (true
division), the decay ``fma(wd, p, g)``, the momentum ``fma(mu, buf, d)``,
the update ``fma(buf, -lr, p)``; each is rounded once (``ops.requant.
fma_f32``). ``bc1`` and the noise decay are powers taken in float64 of the
float32 base and rounded to float32 on the host, which is what XLA's
float32 ``pow`` gives for these integer exponents (up to the step where
``beta ** step`` is subnormal, long after ``bc1`` is 1).

The noise draws from an explicit ``torch.Generator`` on the parameters'
device, seeded with ``seed`` (``|Laplace(0, 1)|`` is ``Exponential(1)``);
the draws cannot match the JAX PRNG's bits, so a ``noise_draws`` callable
can inject them.
"""
from __future__ import annotations

import functools
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops.requant import fma_f32

DecayRule = Callable[[torch.Tensor], float]
NoiseDraws = Callable[[Sequence[torch.Tensor]], Tuple[List[torch.Tensor], List[torch.Tensor]]]


def grouped_weight_decay(weight_decay: float, bn_scale: float = 0.01) -> DecayRule:
    """The reference's per-shape decay groups, by HWIO shape: depthwise conv
    kernels (I == 1) get 0, other conv kernels ``weight_decay``, everything
    else (BN scale and bias, biases) ``weight_decay * bn_scale``. Applied to
    every parameter, zeros included, as the JAX transform is."""

    def rule(p: torch.Tensor) -> float:
        if p.ndim == 4:
            return 0.0 if p.shape[2] == 1 else weight_decay
        return weight_decay * bn_scale

    return rule


def _f32(v: float, device) -> torch.Tensor:
    """float32 ``v`` as a 0-dim tensor filled on ``device`` (no host copy,
    so no synchronisation)."""
    return torch.full((), float(np.float32(v)), dtype=torch.float32, device=device)


def _pow_f32(base: float, exponent: int) -> float:
    """float32 ``base ** exponent`` as XLA computes it for these exponents."""
    return float(np.float32(np.float64(np.float32(base)) ** exponent))


class SGD(torch.optim.Optimizer):
    """``torch.optim.SGD`` semantics as the JAX ``sgd`` chain: decay added to
    the gradient, heavy-ball momentum (the buffer starts at the first
    update), ``p -= lr * buf``."""

    gradboost = False

    def __init__(self, params, lr: float, momentum: float = 0.9,
                 weight_decay: Union[float, DecayRule] = 0.0, nesterov: bool = False):
        super().__init__(params, dict(lr=lr, momentum=momentum, weight_decay=weight_decay,
                                      nesterov=nesterov))

    def _boost(self, group, st, g: torch.Tensor, params) -> torch.Tensor:
        return g

    def _group_state(self, gi: int, group, params, x: torch.Tensor):
        st = self.state[f"group{gi}"]
        if not st:
            wd = group["weight_decay"]
            if callable(wd):
                st["wd"] = torch.cat([torch.full((p.numel(),), float(np.float32(wd(p))),
                                                 dtype=torch.float32) for p in params]).to(x.device)
            elif wd:
                st["wd"] = torch.full_like(x, float(np.float32(wd)))
            else:
                st["wd"] = None
            st["momentum_buffer"] = None
        return st

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for gi, group in enumerate(self.param_groups):
            params = list(group["params"])
            if not params:
                continue
            dev = params[0].device
            x = torch.cat([p.reshape(-1) for p in params]).to(torch.float32)
            g = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p))
                           .reshape(-1) for p in params]).to(torch.float32)
            st = self._group_state(gi, group, params, x)
            g = self._boost(group, st, g, params)
            if st["wd"] is not None:
                g = fma_f32(st["wd"], x, g)
            mu = group["momentum"]
            if mu:
                mu_t = _f32(mu, dev)
                buf = st["momentum_buffer"]
                buf = g.clone() if buf is None else fma_f32(mu_t, buf, g)
                st["momentum_buffer"] = buf
                g = fma_f32(mu_t, buf, g) if group["nesterov"] else buf
            x = fma_f32(g, _f32(-group["lr"], dev), x)
            torch._foreach_copy_(params, [t.view_as(p) for t, p in
                                          zip(torch.split(x, [p.numel() for p in params]),
                                              params)])
        return loss


class QSGD(SGD):
    """QSGD (reference optimizer.py:50-206): GradBoost on the raw gradient,
    then SGD. Starts in the StatAssist warm-up (EMAs only, no noise)."""

    def __init__(self, params, lr: float, momentum: float = 0.9,
                 weight_decay: Union[float, DecayRule] = 0.0, nesterov: bool = False,
                 beta: float = 0.9, clip_by: float = 1e-3, toss_coin: bool = True,
                 noise_decay: float = 1e-2, seed: int = 0,
                 noise_draws: Optional[NoiseDraws] = None):
        super().__init__(params, lr, momentum, weight_decay, nesterov)
        for group in self.param_groups:
            group.update(beta=beta, clip_by=clip_by, toss_coin=toss_coin,
                         noise_decay=noise_decay, gb_step=0, restart_step=0, is_warmup=True)
        self.seed, self.noise_draws, self.generator = seed, noise_draws, None

    def _draws(self, params):
        """``|Laplace(0, 1)|`` magnitudes and fair coins for ``params``."""
        if self.noise_draws is not None:
            return self.noise_draws(params)
        if self.generator is None:
            self.generator = torch.Generator(device=params[0].device)
            self.generator.manual_seed(self.seed)
        lap = [torch.empty_like(p).exponential_(1.0, generator=self.generator) for p in params]
        coin = [torch.empty_like(p).bernoulli_(0.5, generator=self.generator) for p in params]
        return lap, coin

    def _boost(self, group, st, g, params):
        dev = g.device
        beta = group["beta"]
        group["gb_step"] += 1
        if "exp_min" not in st:
            st["exp_min"] = torch.zeros_like(g)
            st["exp_max"] = torch.zeros_like(g)
        bc1 = _f32(np.float32(1.0) - np.float32(_pow_f32(beta, group["gb_step"])), dev)
        b_t, c_t = _f32(beta, dev), _f32(1.0 - beta, dev)
        a = g.abs()
        st["exp_min"] = fma_f32(b_t, st["exp_min"], c_t * torch.minimum(st["exp_min"], a)) / bc1
        st["exp_max"] = fma_f32(b_t, st["exp_max"], c_t * torch.maximum(st["exp_max"], a)) / bc1
        if group["is_warmup"]:
            return g
        group["restart_step"] += 1
        amp = _f32(_pow_f32(1.0 - group["noise_decay"], group["restart_step"]), dev)
        lap, coin = self._draws(params)
        noise = torch.cat([t.reshape(-1) for t in lap]).to(torch.float32) * (
            (st["exp_max"] - st["exp_min"]) * amp)
        if group["toss_coin"]:
            noise = noise * torch.cat([t.reshape(-1) for t in coin]).to(torch.float32)
        clip = group["clip_by"]
        if clip > 0.0:
            return g + torch.clamp(noise * torch.sign(g), -clip, clip)
        return fma_f32(noise, torch.sign(g), g)


def set_warmup(optimizer: torch.optim.Optimizer, is_warmup: bool) -> None:
    """Flip the StatAssist warm-up flag (``optimizer.is_warmup = False``)."""
    for group in optimizer.param_groups:
        if "is_warmup" in group:
            group["is_warmup"] = bool(is_warmup)


_OPTIMIZERS = {"SGD": SGD, "QSGD": QSGD}


def get_optimizer(name: str, learning_rate: float, **kwargs) -> Callable:
    """The reference's optimizer names: a factory ``params -> optimizer``.

    Only ``SGD`` and ``QSGD`` are ported; ``create_train_state`` calls the
    factory on the model's parameters.
    """
    try:
        cls = _OPTIMIZERS[name]
    except KeyError:
        raise ValueError(f"unknown optimizer {name!r}; the port has {list(_OPTIMIZERS)}")
    return functools.partial(cls, lr=learning_rate, **kwargs)
