"""Real quantization to an integer grid and back.

``quantize`` is ``clamp(round(x / scale) + zero_point, qmin, qmax)`` with
round-half-to-even (``torch.round``) and IEEE division, the formula of
``frostnet_tpu.quant.fake_quant.quantize``. The freeze pass uses it for
weights. Activations in the frozen graph requantize by a multiply with the
reciprocal scale instead: see ``frostnet_tpu_torch.ops.requant``.
``fake_quantize`` (training) is not part of the serving port.
"""
from __future__ import annotations

from typing import Optional

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
