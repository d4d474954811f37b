"""Observer state and the (scale, zero_point) it implies.

An observer is a ``(min_val, max_val)`` pair of float32 tensors: scalars for
per-tensor grids, ``(C,)`` for per-channel ones. Uninitialized state is
``(+inf, -inf)``. The update rule belongs to training and is not part of the
serving port; here the state is read from a trained artifact.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .qtypes import QSpec, SCALE_EPS


class ObserverState(NamedTuple):
    min_val: torch.Tensor  # f32, scalar or (C,)
    max_val: torch.Tensor


def init_observer(num_channels: Optional[int] = None) -> ObserverState:
    """Fresh observer. ``num_channels=None`` -> per-tensor (scalar state)."""
    shape = () if num_channels is None else (num_channels,)
    return ObserverState(
        min_val=torch.full(shape, float("inf"), dtype=torch.float32),
        max_val=torch.full(shape, float("-inf"), dtype=torch.float32),
    )


def calculate_qparams(state: ObserverState, spec: QSpec) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale f32, zero_point int32) from observed min/max.

    The formulas of torch.ao.quantization's
    ``UniformQuantizationObserverBase._calculate_qparams`` (affine and
    symmetric branches), in float32 with IEEE division: in the frozen JAX
    graph these are compile-time constants, which XLA folds with true
    division. Uninitialized observers yield (1.0, 0).
    """
    qmin, qmax = spec.qmin, spec.qmax
    min_val = state.min_val.to(torch.float32)
    max_val = state.max_val.to(torch.float32)
    min_neg = torch.clamp(min_val, max=0.0)
    max_pos = torch.clamp(max_val, min=0.0)
    if spec.symmetric:
        amax = torch.maximum(-min_neg, max_pos)
        scale = amax / torch.tensor((qmax - qmin) / 2.0, dtype=torch.float32)
        scale = torch.clamp(scale, min=SCALE_EPS)
        # signed symmetric grid -> zp 0; unsigned symmetric -> mid-grid 128
        zero_point = torch.full_like(scale, 0 if qmin < 0 else 128, dtype=torch.int32)
    else:
        scale = (max_pos - min_neg) / torch.tensor(float(qmax - qmin), dtype=torch.float32)
        scale = torch.clamp(scale, min=SCALE_EPS)
        zero_point = qmin - torch.round(min_neg / scale)
        zero_point = torch.clamp(zero_point, qmin, qmax).to(torch.int32)
    uninit = torch.isinf(min_val)
    scale = torch.where(uninit, torch.ones_like(scale), scale)
    zero_point = torch.where(uninit, torch.zeros_like(zero_point), zero_point)
    return scale, zero_point
