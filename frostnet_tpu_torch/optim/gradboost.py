"""StatAssist + GradBoost: the optimizers of the JAX package.

``frostnet_tpu/optim/gradboost.py`` chains optax transforms; here each
optimizer is a ``torch.optim.Optimizer`` that applies the same chain, in the
same order, to the whole parameter group at once (flattened into one
float32 vector per step, so a step is a few dozen device ops whatever the
parameter count). The chains (``stages``), then ``-lr``:

* SGD: decay, heavy-ball momentum; QSGD: GradBoost first.
* RMS: decay, RMS scaling, momentum; QRMS: GradBoost first.
* Adam: decay, Adam moments (or ``amsgrad``); QAdam: decay, GradBoost,
  moments.
* AdamW: moments, decoupled decay; QAdamW: GradBoost first.
* QAdamN: decay, GradBoost, Nesterov Adam moments.
* RMSTF: decay, TF-style RMS (``eps`` inside the root, second moment
  starting at 1), momentum.

GradBoost (``gradboost.py:45-112``): per-element EMAs of the running min
and max of ``|g|``, ``m <- (beta * m + (1 - beta) * min(m, |g|)) / bc1``
with ``bc1 = 1 - beta ** step``; after the warm-up, sign-aligned,
coin-masked ``|Laplace(0, 1)|`` noise scaled by ``(exp_max - exp_min) *
(1 - noise_decay) ** restart_step`` and clipped to ``+-clip_by`` is added to
the gradient. :func:`set_warmup` ends the StatAssist warm-up. Weight decay
is a float or :func:`grouped_weight_decay`. ``lr`` is a float or a schedule
(``optim.schedules``) read at the group's ``count``, the number of earlier
updates (optax's ``scale_by_schedule`` count).

Rounding follows the jitted JAX step. XLA contracts a multiply feeding an
add into one fused multiply-add (``ops.requant.fma_f32`` rounds it once);
of two products the first in LLVM's order is the fused one:

* GradBoost EMA ``fma(beta, m, (1 - beta) * min(m, |g|)) / bc1``;
* decay (L2 or decoupled) ``fma(wd, p, g)``; momentum ``fma(mu, buf, g)``;
  update ``fma(u, -lr, p)``;
* RMS ``nu = fma(g * g, 1 - a, a * nu)``, ``u = g * (1 / (sqrt(nu) + eps))``;
* Adam ``mu = fma(g, 1 - b1, b1 * mu)``, ``nu = fma(g * g, 1 - b2, b2 *
  nu)``; XLA turns ``(mu / bc1) / (sqrt(nu / bc2) + eps)`` into
  ``mu / (bc1 * (sqrt(nu / bc2) + eps))``;
* AMSGrad (``scale_by_amsgrad_torch``) ``mu = fma(b1, mu, (1 - b1) * g)``,
  ``nu = fma(b2, nu, ((1 - b2) * g) * g)``, the running max of ``nu``;
* Nesterov Adam ``fma(mu / bc1', b1, (g / bc1) * (1 - b1)) / (sqrt(nu /
  bc2) + eps)`` with ``bc1'`` one step ahead.

Square roots are taken in float64 and rounded once (torch's float32 CPU
``sqrt`` is not always correctly rounded). Bias corrections and the noise
decay are float32 ``powf`` on the host (``schedules``), as XLA computes
them. XLA's ``rsqrt`` on the CPU (RMSTF) is the hardware estimate refined by
two Newton steps; the port takes the correctly rounded ``1 / sqrt``, which
can differ by an ulp.

The noise draws from an explicit ``torch.Generator`` on the parameters'
device, seeded with ``seed`` at the first noise step (``|Laplace(0, 1)|`` is
``Exponential(1)``); the draws cannot match the JAX PRNG's bits, so a
``noise_draws`` callable can inject them.
"""
from __future__ import annotations

import functools
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops.requant import fma_f32
from ..utils.profiling import span
from .schedules import _pow

DecayRule = Callable[[torch.Tensor], float]
LearningRate = Union[float, Callable[[int], float]]
NoiseDraws = Callable[[Sequence[torch.Tensor]], Tuple[List[torch.Tensor], List[torch.Tensor]]]
# the per-group counters a checkpoint carries (tensors live in ``state``)
COUNTERS = ("count", "gb_step", "restart_step", "is_warmup")


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


def _one_minus_pow(base: float, exponent: int) -> float:
    """float32 ``1 - base ** exponent`` (a bias correction)."""
    return float(np.float32(1.0) - _pow(base, exponent))


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def learning_rate(group) -> float:
    """The group's lr for its next update: the float, or the schedule at
    ``count``."""
    lr = group["lr"]
    return float(lr(group["count"])) if callable(lr) else float(lr)


class _Chain(torch.optim.Optimizer):
    """A chain of stages over each group's flattened float32 gradient,
    then ``p <- fma(u, -lr, p)``. Subclasses name their ``stages``."""

    stages: Tuple[str, ...] = ()

    def __init__(self, params, lr: LearningRate, weight_decay: Union[float, DecayRule] = 0.0,
                 **hyper):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay, count=0, **hyper))

    def _group_state(self, gi: int, group, params, x: torch.Tensor):
        st = self.state[f"group{gi}"]
        if "wd" not in st:
            wd = group["weight_decay"]
            if callable(wd):
                st["wd"] = torch.cat([torch.full((p.numel(),), float(np.float32(wd(p))),
                                                 dtype=torch.float32) for p in params]).to(x.device)
            elif wd:
                st["wd"] = torch.full_like(x, float(np.float32(wd)))
            else:
                st["wd"] = None
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
            with span("optim.flatten"):
                x = torch.cat([p.reshape(-1) for p in params]).to(torch.float32)
                g = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p))
                               .reshape(-1) for p in params]).to(torch.float32)
                st = self._group_state(gi, group, params, x)
            lr = learning_rate(group)
            group["count"] += 1
            for stage in self.stages:
                with span("optim." + stage):
                    g = getattr(self, f"_{stage}")(group, st, g, x, params)
            with span("optim.write_back"):
                x = fma_f32(g, _f32(-lr, dev), x)
                torch._foreach_copy_(params, [t.view_as(p) for t, p in
                                              zip(torch.split(x, [p.numel() for p in params]),
                                                  params)])
        return loss

    # -- stages: (group, state, g, x, params) -> g ---------------------------

    def _decay(self, group, st, g, x, params):
        """L2 decay added to the gradient (``add_decayed_weights``)."""
        return g if st["wd"] is None else fma_f32(st["wd"], x, g)

    _decoupled = _decay  # the same sum, placed after the moments (AdamW)

    def _trace(self, group, st, g, x, params):
        """Heavy-ball momentum (``optax.trace``; the buffer starts at the
        first update)."""
        mu = group["momentum"]
        if not mu:
            return g
        mu_t = _f32(mu, g.device)
        buf = st.get("momentum_buffer")
        buf = g.clone() if buf is None else fma_f32(mu_t, buf, g)
        st["momentum_buffer"] = buf
        return fma_f32(mu_t, buf, g) if group.get("nesterov") else buf

    def _rms_nu(self, group, st, g, initial: float) -> torch.Tensor:
        """The second moment of ``scale_by_rms``: ``fma(g * g, 1 - a, a * nu)``."""
        dev, a = g.device, group["alpha"]
        if "square_avg" not in st:
            st["square_avg"] = torch.full_like(g, initial)
        nu = fma_f32(g * g, _f32(1.0 - a, dev), st["square_avg"] * _f32(a, dev))
        st["square_avg"] = nu
        return nu

    def _rms(self, group, st, g, x, params):
        """torch RMSprop's scaling: ``eps`` outside the root, the second
        moment from 0."""
        nu = self._rms_nu(group, st, g, 0.0)
        return g * (torch.ones((), device=g.device) / (_sqrt(nu) + _f32(group["eps"], g.device)))

    def _rms_tf(self, group, st, g, x, params):
        """TF's RMS scaling (``eps`` inside the root, the second moment from
        1) and the momentum, in one: XLA fuses the scaling's product, not the
        decayed buffer, ``buf = fma(rsqrt(nu + eps), g, mu * buf)``."""
        dev = g.device
        nu = self._rms_nu(group, st, g, 1.0)
        scale = (1.0 / torch.sqrt((nu + _f32(group["eps"], dev)).to(torch.float64))
                 ).to(torch.float32)
        mu = group["momentum"]
        if not mu:
            return g * scale
        buf = st.get("momentum_buffer")
        buf = g * scale if buf is None else fma_f32(scale, g, buf * _f32(mu, dev))
        st["momentum_buffer"] = buf
        return buf

    def _moments(self, st, g):
        if "exp_avg" not in st:
            st["exp_avg"] = torch.zeros_like(g)
            st["exp_avg_sq"] = torch.zeros_like(g)
        return st["exp_avg"], st["exp_avg_sq"]

    def _adam_moments(self, st, g, m, v, b1, b2, stage):
        """optax's ``update_moment`` of ``g`` and of ``g * g``. Which product
        LLVM fuses depends on where ``g`` comes from: loaded, the second
        moment's new term; computed by a decay in the same fusion, the decayed
        second moment; by GradBoost, the decayed first moment as well."""
        dev = g.device
        before = self.stages[:self.stages.index(stage)]
        boosted = "boost" in before
        computed = boosted or ("decay" in before and st["wd"] is not None)
        c1, c2, b1_t, b2_t = (_f32(1.0 - b1, dev), _f32(1.0 - b2, dev), _f32(b1, dev),
                              _f32(b2, dev))
        m = fma_f32(m, b1_t, g * c1) if boosted else fma_f32(g, c1, m * b1_t)
        v = fma_f32(v, b2_t, (g * g) * c2) if computed else fma_f32(g * g, c2, v * b2_t)
        return m, v

    def _adam(self, group, st, g, x, params):
        """``scale_by_adam``, or ``scale_by_amsgrad_torch`` with ``amsgrad``."""
        dev, b1, b2, n = g.device, group["b1"], group["b2"], group["count"]
        m, v = self._moments(st, g)
        if group.get("amsgrad"):
            m = fma_f32(_f32(b1, dev), m, g * _f32(1.0 - b1, dev))
            v = fma_f32(_f32(b2, dev), v, (g * _f32(1.0 - b2, dev)) * g)
            vmax = st.get("max_exp_avg_sq")
            vmax = v if vmax is None else torch.maximum(vmax, v)
            st["max_exp_avg_sq"] = vmax
        else:
            m, v = self._adam_moments(st, g, m, v, b1, b2, "adam")
            vmax = v
        st["exp_avg"], st["exp_avg_sq"] = m, v
        bc1, bc2 = _f32(_one_minus_pow(b1, n), dev), _f32(_one_minus_pow(b2, n), dev)
        return m / (bc1 * (_sqrt(vmax / bc2) + _f32(group["eps"], dev)))

    def _nadam(self, group, st, g, x, params):
        """``scale_by_adam(nesterov=True)``."""
        dev, b1, b2, n = g.device, group["b1"], group["b2"], group["count"]
        m, v = self._moments(st, g)
        m, v = self._adam_moments(st, g, m, v, b1, b2, "nadam")
        st["exp_avg"], st["exp_avg_sq"] = m, v
        m_hat = fma_f32(m / _f32(_one_minus_pow(b1, n + 1), dev), _f32(b1, dev),
                        (g / _f32(_one_minus_pow(b1, n), dev)) * _f32(1.0 - b1, dev))
        nu_hat = v / _f32(_one_minus_pow(b2, n), dev)
        return m_hat / (_sqrt(nu_hat) + _f32(group["eps"], dev))

    # -- GradBoost -----------------------------------------------------------

    def _init_gradboost(self, beta, clip_by, toss_coin, noise_decay, seed, noise_draws):
        for group in self.param_groups:
            group.update(beta=beta, clip_by=clip_by, toss_coin=toss_coin,
                         noise_decay=noise_decay, gb_step=0, restart_step=0, is_warmup=True)
        self.seed, self.noise_draws, self.generator = seed, noise_draws, None

    def _draws(self, params):
        """``|Laplace(0, 1)|`` magnitudes and fair coins for ``params``. A
        tensor-parallel block (``mp_block``, ``parallel.shard_params_for_mp``)
        draws its full parameter's values, in the same order on every rank,
        and keeps its block: the draws of the unsharded step."""
        if self.noise_draws is not None:
            return self.noise_draws(params)
        if self.generator is None:
            self.generator = torch.Generator(device=params[0].device)
            self.generator.manual_seed(self.seed)
        lap = [_block(torch.empty(_full_shape(p), dtype=p.dtype, device=p.device)
                      .exponential_(1.0, generator=self.generator), p) for p in params]
        coin = [_block(torch.empty(_full_shape(p), dtype=p.dtype, device=p.device)
                       .bernoulli_(0.5, generator=self.generator), p) for p in params]
        return lap, coin

    def _boost(self, group, st, g, x, params):
        dev = g.device
        beta = group["beta"]
        group["gb_step"] += 1
        if "exp_min" not in st:
            st["exp_min"] = torch.zeros_like(g)
            st["exp_max"] = torch.zeros_like(g)
        bc1 = _f32(_one_minus_pow(beta, group["gb_step"]), dev)
        b_t, c_t = _f32(beta, dev), _f32(1.0 - beta, dev)
        a = g.abs()
        st["exp_min"] = fma_f32(b_t, st["exp_min"], c_t * torch.minimum(st["exp_min"], a)) / bc1
        st["exp_max"] = fma_f32(b_t, st["exp_max"], c_t * torch.maximum(st["exp_max"], a)) / bc1
        if group["is_warmup"]:
            return g
        group["restart_step"] += 1
        amp = _f32(_pow(1.0 - group["noise_decay"], group["restart_step"]), dev)
        lap, coin = self._draws(params)
        noise = torch.cat([t.reshape(-1) for t in lap]).to(torch.float32) * (
            (st["exp_max"] - st["exp_min"]) * amp)
        if group["toss_coin"]:
            noise = noise * torch.cat([t.reshape(-1) for t in coin]).to(torch.float32)
        clip = group["clip_by"]
        if clip > 0.0:
            return g + torch.clamp(noise * torch.sign(g), -clip, clip)
        return fma_f32(noise, torch.sign(g), g)


def _full_shape(p: torch.Tensor) -> tuple:
    block = getattr(p, "mp_block", None)
    return tuple(p.shape) if block is None else block[0]


def _block(t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``p``'s block of the full-shape draw ``t``."""
    block = getattr(p, "mp_block", None)
    if block is None or tuple(p.shape) == block[0]:
        return t
    return t.narrow(block[1], block[2], block[3])


def _boosted(cls):
    """``__init__`` of the GradBoost ("Q") variant of ``cls``: ``cls``'s
    arguments, then GradBoost's; the variant's ``stages`` place ``boost``."""

    def __init__(self, params, lr: LearningRate, *args, beta: float = 0.9,
                 clip_by: float = 1e-3, toss_coin: bool = True, noise_decay: float = 1e-2,
                 seed: int = 0, noise_draws: Optional[NoiseDraws] = None, **kwargs):
        cls.__init__(self, params, lr, *args, **kwargs)
        self._init_gradboost(beta, clip_by, toss_coin, noise_decay, seed, noise_draws)

    return __init__


class SGD(_Chain):
    """``torch.optim.SGD`` semantics as the JAX ``sgd`` chain: decay added to
    the gradient, heavy-ball momentum, ``p -= lr * buf``."""

    stages = ("decay", "trace")

    def __init__(self, params, lr: LearningRate, momentum: float = 0.9,
                 weight_decay: Union[float, DecayRule] = 0.0, nesterov: bool = False):
        super().__init__(params, lr, weight_decay, momentum=momentum, nesterov=nesterov)


class QSGD(SGD):
    """QSGD (reference optimizer.py:50-206): GradBoost on the raw gradient,
    then SGD. Starts in the StatAssist warm-up (EMAs only, no noise)."""

    stages = ("boost", "decay", "trace")
    __init__ = _boosted(SGD)


class RMS(_Chain):
    """torch RMSprop as the JAX ``rmsprop`` chain: decay, RMS, momentum."""

    stages = ("decay", "rms", "trace")

    def __init__(self, params, lr: LearningRate, alpha: float = 0.9, momentum: float = 0.9,
                 eps: float = 1e-8, weight_decay: Union[float, DecayRule] = 0.0):
        super().__init__(params, lr, weight_decay, alpha=alpha, momentum=momentum, eps=eps)


class QRMS(RMS):
    """QRMSprop (reference optimizer.py:208-359): noise, decay, RMS, momentum."""

    stages = ("boost", "decay", "rms", "trace")
    __init__ = _boosted(RMS)


class RMSTF(RMS):
    """timm's RMSpropTF (the published FrostNet recipe): ``eps`` inside the
    root and the second moment starting at 1."""

    stages = ("decay", "rms_tf")

    def __init__(self, params, lr: LearningRate, alpha: float = 0.9, momentum: float = 0.9,
                 eps: float = 1e-3, weight_decay: Union[float, DecayRule] = 0.0):
        super().__init__(params, lr, alpha, momentum, eps, weight_decay)


class Adam(_Chain):
    """Adam with L2 decay added to the gradient first (the JAX ``adam``)."""

    stages = ("decay", "adam")

    def __init__(self, params, lr: LearningRate, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: Union[float, DecayRule] = 0.0,
                 amsgrad: bool = False):
        super().__init__(params, lr, weight_decay, b1=b1, b2=b2, eps=eps, amsgrad=amsgrad)


class QAdam(Adam):
    """QAdam (reference optimizer.py:361-512): decay, noise, Adam moments."""

    stages = ("decay", "boost", "adam")
    __init__ = _boosted(Adam)


class AdamW(Adam):
    """AdamW: Adam moments, then decoupled decay (a float or
    :func:`grouped_weight_decay`)."""

    stages = ("adam", "decoupled")

    def __init__(self, params, lr: LearningRate, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: Union[float, DecayRule] = 1e-2,
                 amsgrad: bool = False):
        super().__init__(params, lr, b1, b2, eps, weight_decay, amsgrad)


class QAdamW(AdamW):
    """QAdamW (reference optimizer.py:514-667): noise, Adam moments,
    decoupled decay."""

    stages = ("boost", "adam", "decoupled")
    __init__ = _boosted(AdamW)


class QAdamN(_Chain):
    """QAdamN: Adam with Nesterov momentum and GradBoost (decay, noise,
    moments)."""

    stages = ("decay", "boost", "nadam")

    def __init__(self, params, lr: LearningRate, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: Union[float, DecayRule] = 0.0,
                 beta: float = 0.9, clip_by: float = 1e-3, toss_coin: bool = True,
                 noise_decay: float = 1e-2, seed: int = 0,
                 noise_draws: Optional[NoiseDraws] = None):
        super().__init__(params, lr, weight_decay, b1=b1, b2=b2, eps=eps)
        self._init_gradboost(beta, clip_by, toss_coin, noise_decay, seed, noise_draws)


def set_warmup(optimizer: torch.optim.Optimizer, is_warmup: bool) -> None:
    """Flip the StatAssist warm-up flag (``optimizer.is_warmup = False``)."""
    for group in optimizer.param_groups:
        if "is_warmup" in group:
            group["is_warmup"] = bool(is_warmup)


class EmaState:
    """The parameter EMA (timm ``--model-ema``): ``ema`` maps each name to
    its float32 average."""

    def __init__(self, ema):
        self.ema = ema


def param_ema(decay: float = 0.9999):
    """``(init, update)`` of the parameter EMA: ``init(named_params)``, then
    ``update(state, named_params)`` after each optimizer step, rounded as
    the jitted JAX step rounds ``decay * e + (1 - decay) * p``
    (:func:`ema_update`)."""

    def init(named):
        return EmaState({n: p.detach().clone() for n, p in dict(named).items()})

    def update(state: EmaState, named):
        for n, p in dict(named).items():
            ema_update(state.ema[n], p, decay)
        return state

    return init, update


@torch.no_grad()
def ema_update(e: torch.Tensor, p: torch.Tensor, decay: float) -> None:
    """``e <- fma(e, decay, p * (1 - decay))`` in place, as XLA contracts
    ``decay * e + (1 - decay) * p``."""
    dev = e.device
    e.copy_(fma_f32(e, _f32(decay, dev), p.detach().to(torch.float32) * _f32(1.0 - decay, dev)))


_OPTIMIZERS = {"SGD": SGD, "RMS": RMS, "Adam": Adam, "AdamW": AdamW, "QSGD": QSGD,
               "QRMS": QRMS, "QAdam": QAdam, "QAdamW": QAdamW, "QAdamN": QAdamN,
               "RMSTF": RMSTF}


def get_optimizer(name: str, learning_rate: LearningRate, **kwargs) -> Callable:
    """The reference's optimizer names: a factory ``params -> optimizer``.

    ``learning_rate`` is a float or a schedule ``count -> lr``;
    ``create_train_state`` calls the factory on the model's parameters.
    """
    try:
        cls = _OPTIMIZERS[name]
    except KeyError:
        raise ValueError(f"unknown optimizer {name!r}; options: {list(_OPTIMIZERS)}")
    return functools.partial(cls, lr=learning_rate, **kwargs)
