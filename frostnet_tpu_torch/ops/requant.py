"""Requantization arithmetic of the frozen INT8 graph, as plain torch ops.

The JAX package's ``freeze`` closes ``jax.jit`` over the variables, so every
scale is a compile-time constant and XLA rewrites the requant arithmetic
before it runs. The port computes what that program computes, site by site
(the tests hold it bit-exact against ``frostnet_tpu.quant.freeze``):

* ``y / s`` with a constant ``s`` becomes ``y * f32(1/s)``: XLA's
  "divide by a constant" simplification. Every activation requant here
  multiplies by a reciprocal computed once in float32 (:func:`reciprocal`).
* A multiply followed by an add inside one fusion is contracted into one
  fused multiply-add by the CPU backend where the add reads the product
  directly: the conv epilogue is ``fma(float(acc), scale, bias)``
  (:func:`fma_f32` rounds once).
* The residual add ``(qa - za) * sa + (qb - zb) * sb`` is not contracted in
  the frozen model: XLA recomputes both codes inside the add's fusion, and
  their saturating float-to-uint8 converts leave each product behind a
  select, which LLVM does not fuse across. Both products and the sum round
  on their own. (A QAdd jitted alone, on codes loaded from memory, does
  contract its first product; the served graph never runs it that way.)
* ``(acc * c1) * c2`` with two scalar constants and nothing between them is
  folded into ``acc * f32(c1 * c2)``. In a conv that happens when the bias
  is all zero, there is no activation and the weight scale is per-tensor
  (:func:`epilogue_constants`).
* Weight quantization, BN folding and qparams are folded at compile time
  with IEEE division and separate roundings (``quant.quantize``,
  ``quant.fold_bn``, ``quant.calculate_qparams_folded``).

These functions are the plain versions that the CUDA kernels reproduce;
they run on any device (every step is an IEEE-exact torch op).
"""
from __future__ import annotations

from typing import Tuple

import torch

_INF = float("inf")


def reciprocal(s) -> float:
    """float32(1 / s), as XLA folds it; returned as a Python float."""
    s = torch.as_tensor(s, dtype=torch.float32).reshape(())
    return float(torch.tensor(1.0, dtype=torch.float32) / s)


def _const(v: float, device) -> torch.Tensor:
    """float32 ``v`` as a 0-dim tensor filled on ``device``: no copy from
    the host (which would wait for the device and cannot be captured in a
    CUDA graph)."""
    return torch.full((), v, dtype=torch.float32, device=device)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once (a fused multiply-add).

    ``a`` and ``b`` are float32, so their product is exact in float64. The
    float64 sum is made round-to-odd from its exact error (TwoSum), and a
    round-to-odd result at 53 bits rounds to the nearest float32 exactly as
    the exact sum does: no double-rounding error.
    """
    p = a.to(torch.float64) * b.to(torch.float64)
    c = c.to(torch.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, _INF), torch.full_like(s, -_INF))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def epilogue_constants(comb: torch.Tensor, bias: torch.Tensor, out_scale,
                       relu: bool) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """(scale, bias, out_mult) of the frozen conv epilogue.

    The epilogue is ``q = rint(act(fma(float(acc), scale, bias)) * out_mult)``.
    ``comb`` is the input scale times the weight scale (scalar or per
    channel), ``bias`` the folded float bias. XLA folds the two products only
    when both are scalar constants, so a per-channel ``comb`` never merges.
    """
    comb = comb.to(torch.float32)
    bias = bias.to(torch.float32)
    inv = reciprocal(out_scale)
    if not relu and comb.dim() == 0 and bool(torch.all(bias == 0)):
        merged = comb.reshape(()) * torch.tensor(inv, dtype=torch.float32)
        n = bias.numel()
        return merged.expand(n).clone(), torch.zeros(n, dtype=torch.float32), 1.0
    return comb.expand(bias.shape).clone(), bias, inv


def requant_epilogue(acc: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     out_mult: float, out_zp: int, relu: bool,
                     qmin: int, qmax: int) -> torch.Tensor:
    """int32 accumulator (zero-point term included) -> uint8 codes."""
    y = fma_f32(acc.to(torch.float32), scale, bias)
    if relu:
        y = torch.clamp(y, min=0.0)
    y = y * _const(out_mult, y.device)
    q = torch.round(y) + float(out_zp)
    return torch.clamp(q, qmin, qmax).to(torch.uint8)


def requant_codes(q: torch.Tensor, z_in: int, s_in: float, mult: float,
                  z_out: int, qmin: int, qmax: int) -> torch.Tensor:
    """uint8 codes on one grid -> another: ``rint((q - z_in) * s_in * mult)``.

    The two products round separately (the QCat case, where a concatenate
    sits between them); ``mult = 1.0`` gives the single-multiply form.
    """
    dev = q.device
    y = (q.to(torch.float32) - float(z_in)) * _const(s_in, dev)
    y = y * _const(mult, dev)
    return torch.clamp(torch.round(y) + float(z_out), qmin, qmax).to(torch.uint8)


def qadd_codes(qa: torch.Tensor, za: int, sa: float, qb: torch.Tensor, zb: int,
               sb: float, mult: float, z_out: int, qmin: int, qmax: int) -> torch.Tensor:
    """Residual add: ``rint(((qa - za) * sa + (qb - zb) * sb) * mult)``, each
    product and the sum rounded on its own."""
    dev = qa.device
    f32 = torch.float32
    ya = (qa.to(f32) - float(za)) * _const(sa, dev)
    yb = (qb.to(f32) - float(zb)) * _const(sb, dev)
    y = (ya + yb) * _const(mult, dev)
    return torch.clamp(torch.round(y) + float(z_out), qmin, qmax).to(torch.uint8)


def depthwise_acc(x: torch.Tensor, w: torch.Tensor, kernel: int, stride: int,
                  zp: int) -> torch.Tensor:
    """int32 depthwise conv of uint8 NHWC codes around their zero point.

    ``w`` is (k*k, C) int8 taps in (dy, dx) order. Out-of-image taps read the
    zero point (qnnpack pad semantics), so they contribute exactly 0:
    ``acc = sum (x - zp) * w``, the same integer as the JAX package's
    zero-point-shifted form.
    """
    p = (kernel - 1) // 2
    b, h, w_sp, c = x.shape
    xi = x.to(torch.int32) - zp
    xi = torch.nn.functional.pad(xi, (0, 0, p, p, p, p))
    ho = (h + 2 * p - kernel) // stride + 1
    wo = (w_sp + 2 * p - kernel) // stride + 1
    acc = torch.zeros((b, ho, wo, c), dtype=torch.int32, device=x.device)
    wi = w.to(torch.int32)
    for dy in range(kernel):
        for dx in range(kernel):
            sl = xi[:, dy:dy + (ho - 1) * stride + 1:stride,
                    dx:dx + (wo - 1) * stride + 1:stride, :]
            acc += sl * wi[dy * kernel + dx]
    return acc
