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
* The residual add ``(qa - za) * sa + (qb - zb) * sb`` is not contracted
  where XLA recomputes both codes inside the add's fusion (the frozen
  FrostNet, every ResNet block but the first): their saturating
  float-to-uint8 converts leave each product behind a select, which LLVM
  does not fuse across, so both products and the sum round on their own.
  An operand whose codes the fusion loads from memory has its product
  contracted into the sum (the first ResNet block of ``BasicBlock`` models,
  whose identity is the max pool's output; a QAdd jitted alone on loaded
  codes contracts its first product): :func:`qadd_codes`'s ``contract``.
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

import contextlib
from typing import Optional, Tuple

import torch

from . import cuda_build

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
    the exact sum does: no double-rounding error. The round-to-odd step is
    an exact float64 offset added outside autograd, so the gradient is that
    of ``a * b + c`` (the segmentation tail's resize trains through it).
    """
    p = a.to(torch.float64) * b.to(torch.float64)
    s = p + c.to(torch.float64)
    # (no grad-mode switch where grad is off already: torch.export splits a
    # traced graph at each one)
    with torch.no_grad() if torch.is_grad_enabled() else contextlib.nullcontext():
        bb = s - p
        err = (p - (s - bb)) + (c.to(torch.float64) - bb)
        even = (s.view(torch.int64) & 1) == 0
        toward = torch.where(err > 0, torch.full_like(s, _INF), torch.full_like(s, -_INF))
        step = torch.where((err != 0) & even, torch.nextafter(s, toward) - s,
                           torch.zeros_like(s))
    return (s + step).to(torch.float32)


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
               sb: float, mult: float, z_out: int, qmin: int, qmax: int,
               relu: bool = False, contract: Optional[int] = None) -> torch.Tensor:
    """Residual add: ``rint(((qa - za) * sa + (qb - zb) * sb) * mult)``; with
    ``relu`` (``QAddReLU``) the sum is clamped at 0 before the multiply.

    ``contract`` says which product XLA fuses into the sum: None when the
    add's fusion makes both operands' codes itself (each product and the sum
    round on their own), else the index (0 or 1) of the operand whose codes
    it loads from memory, ``fma(q - z, s, other product)``. Read from the
    LLVM IR: a made operand's product sits behind the select of its
    saturating convert, a loaded one's feeds the add directly.
    """
    dev = qa.device
    f32 = torch.float32
    xa, xb = qa.to(f32) - float(za), qb.to(f32) - float(zb)
    if contract == 0:
        y = fma_f32(xa, _const(sa, dev), xb * _const(sb, dev))
    elif contract == 1:
        y = fma_f32(xb, _const(sb, dev), xa * _const(sa, dev))
    else:
        y = xa * _const(sa, dev) + xb * _const(sb, dev)
    if relu:
        y = torch.clamp(y, min=0.0)
    y = y * _const(mult, dev)
    return torch.clamp(torch.round(y) + float(z_out), qmin, qmax).to(torch.uint8)


def depthwise_acc(x: torch.Tensor, w: torch.Tensor, kernel, stride: int,
                  zp: int, dilation: int = 1, padding=None) -> torch.Tensor:
    """int32 depthwise conv of uint8 NHWC codes around their zero point.

    ``w`` is (kh*kw, Cout) int8 taps in (dy, dx) order (``kernel`` an int
    or a (kh, kw) pair); tap ``(dy, dx)`` reads the input ``dilation * (dy,
    dx)`` from the window's corner, and the padding is ``padding`` (an
    (h, w) pair) or, when None, ``dilation * (k - 1) // 2`` ('same').
    Out-of-image taps read the zero point (qnnpack pad semantics), so they
    contribute exactly 0: ``acc = sum (x - zp) * w``, the same integer as
    the JAX package's zero-point-shifted form. With a channel multiplier
    (``Cout = m * C``, the SSD extras' 32 -> 128) output channel ``oc``
    reads input channel ``oc // m``, as the JAX package repeats each input
    channel ``m`` times (lax's group-major order).

    Under ``torch.export`` the same integers come from one grouped float64
    conv (:func:`conv_acc`): a node where the loop over taps makes about
    five a tap, which the export and the program's load pay for.
    """
    kh, kw = (kernel, kernel) if isinstance(kernel, int) else tuple(kernel)
    d = dilation
    ph, pw = ((d * (kh - 1) // 2, d * (kw - 1) // 2) if padding is None else tuple(padding))
    b, h, w_sp, c = x.shape
    mult = w.shape[1] // c
    if cuda_build.traced(x):
        wc = w.to(torch.float64).t().reshape(c * mult, 1, kh, kw)
        return conv_acc(x, wc, zp, stride, (ph, pw), groups=c, dilation=d)
    xi = x.to(torch.int32) - zp
    xi = torch.nn.functional.pad(xi, (0, 0, pw, pw, ph, ph))
    ho = (h + 2 * ph - d * (kh - 1) - 1) // stride + 1
    wo = (w_sp + 2 * pw - d * (kw - 1) - 1) // stride + 1
    acc = torch.zeros((b, ho, wo, c * mult), dtype=torch.int32, device=x.device)
    wi = w.to(torch.int32)
    for dy in range(kh):
        for dx in range(kw):
            sl = xi[:, d * dy:d * dy + (ho - 1) * stride + 1:stride,
                    d * dx:d * dx + (wo - 1) * stride + 1:stride, :]
            if mult > 1:
                sl = sl.repeat_interleave(mult, dim=3)
            acc += sl * wi[dy * kw + dx]
    return acc


def conv_acc(x: torch.Tensor, w: torch.Tensor, zp: int, stride: int = 1, padding=1,
             groups: int = 1, dilation: int = 1) -> torch.Tensor:
    """The int32 sum of a conv of uint8 NHWC codes around their zero point.

    ``w`` is the (Cout, Cin / groups, kh, kw) weight as float64, ``padding``
    an int or an (h, w) pair (``dilation`` the taps' spacing). The JAX
    package computes this sum as an s32 ``lax.conv`` (``feature_group_count``
    ``groups``) over zero-point-padded codes; here it is a float64 conv of
    ``x - zp`` with zero padding, the same integer. Every product and
    partial sum is an integer of magnitude at most
    ``kh * kw * Cin / groups * 255 * 128`` (about 1.5e8 at a dense 3x3 with
    Cin = 512, far below 2^53), exact in float64 in any order. A library conv
    may still transform its operands (cuDNN's Winograd and FFT algorithms
    do, on the card), so the sum is rounded to the nearest integer before
    the cast: such errors are far below 0.5 in float64.
    """
    xs = (x.to(torch.float64) - float(zp)).permute(0, 3, 1, 2).contiguous()
    acc = torch.nn.functional.conv2d(xs, w, None, stride, padding, dilation, groups)
    return torch.round(acc).permute(0, 2, 3, 1).to(torch.int32)
