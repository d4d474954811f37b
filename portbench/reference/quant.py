"""The arithmetic the plain references share: integer grids, observers,
fake quantization with its straight-through gradient, float32 rounded as
the program under test rounds it (a fused multiply-add, reciprocals), the
TF32 rounding of the control, the uint8 input normalization, and QSGD with
GradBoost. Plain PyTorch and NumPy; nothing of the program under test.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.1
OBS_AVG = 0.01
INPUT_MEAN = (0.485, 0.456, 0.406)
INPUT_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class Grid:
    qmin: int
    qmax: int
    symmetric: bool


ACT8, WEIGHT8 = Grid(0, 255, False), Grid(-128, 127, True)
ACT4, WEIGHT4 = Grid(0, 15, False), Grid(-8, 7, True)


# -- float32 arithmetic as the program rounds it ------------------------------

def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once: the float64 sum made round-to-odd
    from its exact error, then rounded to float32."""
    p = a.to(torch.float64) * b.to(torch.float64)
    s = p + c.to(torch.float64)
    with torch.no_grad():
        bb = s - p
        err = (p - (s - bb)) + (c.to(torch.float64) - bb)
        even = (s.view(torch.int64) & 1) == 0
        toward = torch.where(err > 0, torch.full_like(s, math.inf), torch.full_like(s, -math.inf))
        step = torch.where((err != 0) & even, torch.nextafter(s, toward) - s,
                           torch.zeros_like(s))
    return (s + step).to(torch.float32)


def f32(v: float, device) -> torch.Tensor:
    return torch.full((), float(np.float32(v)), dtype=torch.float32, device=device)


def recip(s: float) -> float:
    return float(torch.tensor(1.0, dtype=torch.float32) / torch.tensor(s, dtype=torch.float32))


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its mantissa rounded to TF32's 10 bits (nearest, ties to
    even), gradient passed straight through."""
    bits = x.detach().contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    r = bits.view(torch.float32).view_as(x)
    return x + (r - x).detach()


def qparams(lo: torch.Tensor, hi: torch.Tensor, g: Grid, traced: bool):
    """(scale, zero point) of an observer state: the train step multiplies
    by ``f32(1 / span)`` (``traced``), the frozen graph divides."""
    dev = lo.device
    min_neg, max_pos = torch.clamp(lo, max=0.0), torch.clamp(hi, min=0.0)
    span = (g.qmax - g.qmin) / 2.0 if g.symmetric else float(g.qmax - g.qmin)
    rng = torch.maximum(-min_neg, max_pos) if g.symmetric else max_pos - min_neg
    scale = rng * f32(recip(span), dev) if traced else rng / torch.full((), span, device=dev)
    scale = torch.clamp(scale, min=float(torch.finfo(torch.float32).eps))
    if g.symmetric:
        zp = torch.zeros_like(scale)
    else:
        zp = torch.clamp(g.qmin - torch.round(min_neg / scale), g.qmin, g.qmax)
    uninit = torch.isinf(lo)
    return (torch.where(uninit, torch.ones_like(scale), scale),
            torch.where(uninit, torch.zeros_like(zp), zp))


class _FakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, zp, qmin, qmax):
        inv = torch.ones((), dtype=torch.float32, device=x.device) / scale
        qraw = torch.round(x * inv) + zp
        mask = (qraw >= qmin) & (qraw <= qmax)
        ctx.save_for_backward(mask)
        return (torch.clamp(qraw, qmin, qmax) - zp) * scale

    @staticmethod
    def backward(ctx, g):
        (mask,) = ctx.saved_tensors
        return torch.where(mask, g, torch.zeros((), dtype=g.dtype, device=g.device)), \
            None, None, None, None


def batch_norm_train(y: torch.Tensor, gamma, beta, mean, var) -> torch.Tensor:
    """Train-mode BN of NHWC ``y`` on the batch's statistics, the running
    ones stepped once (unbiased variance). One value a channel normalizes
    to ``beta``: the mean steps toward that value, the variance toward 0."""
    if y.numel() == y.shape[-1]:
        bmean = y.reshape(-1)
        with torch.no_grad():
            mean.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * bmean.detach())
            var.mul_(1 - BN_MOMENTUM)
        inv = torch.rsqrt(torch.full_like(bmean, BN_EPS))
        return ((y - bmean) * inv * gamma + beta).reshape(y.shape)
    return F.batch_norm(y.permute(0, 3, 1, 2), mean, var, gamma, beta, training=True,
                        momentum=BN_MOMENTUM, eps=BN_EPS).permute(0, 2, 3, 1)


def observe_fake_quant(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, g: Grid
                       ) -> torch.Tensor:
    """One QAT site: the observer ``(lo, hi)`` steps in place on ``x``'s
    min and max (the first batch snaps), then ``x`` is fake-quantized on the
    traced qparams of the new state."""
    with torch.no_grad():
        xd = x.detach()
        bmin, bmax = torch.amin(xd).to(torch.float32), torch.amax(xd).to(torch.float32)
        c = torch.full((), OBS_AVG, dtype=torch.float32, device=x.device)
        uninit = torch.isinf(lo)
        lo.copy_(torch.where(uninit, bmin, fma_f32(c, bmin - lo, lo)))
        hi.copy_(torch.where(uninit, bmax, fma_f32(c, bmax - hi, hi)))
        scale, zp = qparams(lo, hi, g, traced=True)
    return _FakeQuant.apply(x, scale, zp, g.qmin, g.qmax)


def prep_image(image: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> ``fma(x, f32(1/255), -mean) * f32(1/std)``."""
    dev = image.device
    inv255 = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(255.0)
    mean = torch.tensor(INPUT_MEAN, dtype=torch.float32)
    inv_std = torch.ones(()) / torch.tensor(INPUT_STD, dtype=torch.float32)
    return fma_f32(image.to(torch.float32), inv255.to(dev), (-mean).to(dev)) * inv_std.to(dev)


def decay_rates(params: Sequence[torch.Tensor], weight_decay: float,
                bn_scale: float = 0.01) -> torch.Tensor:
    """The grouped L2 decay a element: depthwise kernels 0, other kernels
    ``weight_decay``, the rest ``weight_decay * bn_scale``."""
    def rate(p):
        if p.ndim == 4:
            return 0.0 if p.shape[2] == 1 else weight_decay
        return weight_decay * bn_scale
    return torch.cat([torch.full((p.numel(),), float(np.float32(rate(p))), dtype=torch.float32,
                                 device=p.device) for p in params])


class QSGDReference:
    """QSGD + GradBoost over one flat float32 vector."""

    def __init__(self, params: List[torch.Tensor], lr: float, weight_decay: float,
                 momentum: float = 0.9, beta: float = 0.9, clip_by: float = 1e-3,
                 noise_decay: float = 1e-2, noise_seed: int = 0):
        self.params, self.lr, self.momentum = params, lr, momentum
        self.beta, self.clip_by, self.noise_decay = beta, clip_by, noise_decay
        self.noise_seed, self.generator = noise_seed, None
        self.wd = decay_rates(params, weight_decay)
        self.gb_step = self.restart_step = 0
        self.exp_min = self.exp_max = self.buf = None
        self.is_warmup = True

    def state(self) -> dict:
        """The optimizer's state between steps (copies)."""
        return {"momentum_buffer": self.buf.clone(), "exp_min": self.exp_min.clone(),
                "exp_max": self.exp_max.clone(), "gb_step": self.gb_step,
                "restart_step": self.restart_step}

    def load(self, st: dict) -> None:
        """Start from a state of :meth:`state`'s form."""
        self.buf, self.exp_min, self.exp_max = (
            None if st[k] is None else st[k].clone()
            for k in ("momentum_buffer", "exp_min", "exp_max"))
        self.gb_step, self.restart_step = st["gb_step"], st["restart_step"]

    @staticmethod
    def _pow(base: float, exponent: int) -> float:
        return float(np.float32(float(np.float32(base)) ** exponent))

    @torch.no_grad()
    def step(self) -> None:
        ps = self.params
        dev = ps[0].device
        x = torch.cat([p.reshape(-1) for p in ps])
        g = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                       for p in ps])
        # GradBoost
        self.gb_step += 1
        if self.exp_min is None:
            self.exp_min, self.exp_max = torch.zeros_like(g), torch.zeros_like(g)
        bc1 = f32(float(np.float32(1.0) - np.float32(self._pow(self.beta, self.gb_step))), dev)
        b, c = f32(self.beta, dev), f32(1.0 - self.beta, dev)
        a = g.abs()
        self.exp_min = fma_f32(b, self.exp_min, c * torch.minimum(self.exp_min, a)) / bc1
        self.exp_max = fma_f32(b, self.exp_max, c * torch.maximum(self.exp_max, a)) / bc1
        if not self.is_warmup:
            self.restart_step += 1
            amp = f32(self._pow(1.0 - self.noise_decay, self.restart_step), dev)
            if self.generator is None:
                self.generator = torch.Generator(device=dev)
                self.generator.manual_seed(self.noise_seed)
            lap = [torch.empty(p.shape, dtype=p.dtype, device=dev)
                   .exponential_(1.0, generator=self.generator) for p in ps]
            coin = [torch.empty(p.shape, dtype=p.dtype, device=dev)
                    .bernoulli_(0.5, generator=self.generator) for p in ps]
            noise = torch.cat([t.reshape(-1) for t in lap]) * ((self.exp_max - self.exp_min) * amp)
            noise = noise * torch.cat([t.reshape(-1) for t in coin])
            g = g + torch.clamp(noise * torch.sign(g), -self.clip_by, self.clip_by)
        # decay, momentum, update
        g = fma_f32(self.wd, x, g)
        mu = f32(self.momentum, dev)
        self.buf = g.clone() if self.buf is None else fma_f32(mu, self.buf, g)
        x = fma_f32(self.buf, f32(-self.lr, dev), x)
        for t, p in zip(torch.split(x, [p.numel() for p in ps]), ps):
            p.copy_(t.view_as(p))


@contextlib.contextmanager
def no_tf32():
    """float32 convs and matmuls without TF32 while the block runs."""
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
