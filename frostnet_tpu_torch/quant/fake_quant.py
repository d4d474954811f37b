"""Real and fake quantization on an integer grid.

``quantize`` is ``clamp(round(x / scale) + zero_point, qmin, qmax)`` with
round-half-to-even (``torch.round``) and IEEE division, the formula of
``frostnet_tpu.quant.fake_quant.quantize``. The freeze pass uses it for
weights. Activations in the frozen graph requantize by a multiply with the
reciprocal scale instead: see ``frostnet_tpu_torch.ops.requant``.

``fake_quantize`` is the training op (aten's fake_quantize kernels, as the
JAX package writes them)::

    qraw = rint(x * f32(1 / scale)) + zero_point
    out  = (clamp(qraw, qmin, qmax) - zero_point) * scale      in float32

returned in the input's dtype. Its gradient is the straight-through
estimator with range masking: ``g`` where ``qmin <= qraw <= qmax``, else 0.
``scale`` and ``zero_point`` come from observers and get no gradient.
Per-tensor activation and weight sites run through the CUDA kernel of
``ops.fake_quant`` on the GPU; this function is its plain per-tensor
arithmetic and the per-channel (fbgemm weight) op.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .qtypes import QSpec


def _reshape_qparams(scale, zero_point, x, channel_axis: Optional[int]):
    scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    zero_point = torch.as_tensor(zero_point, device=x.device).to(torch.float32)
    if channel_axis is None:
        return scale, zero_point
    shape = [1] * x.ndim
    shape[channel_axis % x.ndim] = x.shape[channel_axis % x.ndim]
    return scale.reshape(shape), zero_point.reshape(shape)


def quantize(x: torch.Tensor, scale, zero_point, spec: QSpec,
             channel_axis: Optional[int] = None) -> torch.Tensor:
    """Quantize ``x`` to the integer grid of ``spec`` (storage dtype)."""
    s, zp = _reshape_qparams(scale, zero_point, x, channel_axis)
    q = torch.clamp(torch.round(x / s) + zp, spec.qmin, spec.qmax)
    return q.to(spec.storage_dtype)


def dequantize(q: torch.Tensor, scale, zero_point,
               channel_axis: Optional[int] = None) -> torch.Tensor:
    s, zp = _reshape_qparams(scale, zero_point, q, channel_axis)
    return (q.to(torch.float32) - zp) * s


def fake_quant_forward(x: torch.Tensor, scale, zero_point, qmin: int, qmax: int,
                       channel_axis: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y in x's dtype, bool STE mask): the forward of :func:`fake_quantize`.

    ``1 / scale`` is an IEEE float32 division (on the device, never a
    reciprocal of a host scalar), then one multiply per element.
    """
    s, zp = _reshape_qparams(scale, zero_point, x, channel_axis)
    inv = torch.ones((), dtype=torch.float32, device=x.device) / s
    qraw = torch.round(x.to(torch.float32) * inv) + zp
    mask = (qraw >= qmin) & (qraw <= qmax)
    y = (torch.clamp(qraw, qmin, qmax) - zp) * s
    return y.to(x.dtype), mask


def ste_backward(mask: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The straight-through gradient ``where(mask, g, 0)``."""
    return torch.where(mask, g, torch.zeros((), dtype=g.dtype, device=g.device))


class _FakeQuantize(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, zero_point, qmin, qmax, channel_axis):
        y, mask = fake_quant_forward(x, scale, zero_point, qmin, qmax, channel_axis)
        ctx.save_for_backward(mask)
        return y

    @staticmethod
    def backward(ctx, g):
        (mask,) = ctx.saved_tensors
        return ste_backward(mask, g), None, None, None, None, None


def fake_quantize(x: torch.Tensor, scale, zero_point, spec: QSpec,
                  channel_axis: Optional[int] = None) -> torch.Tensor:
    """Quantize-dequantize ``x`` on the grid of ``spec`` (STE gradient)."""
    return _FakeQuantize.apply(x, torch.as_tensor(scale).detach(),
                               torch.as_tensor(zero_point).detach(),
                               spec.qmin, spec.qmax, channel_axis)
