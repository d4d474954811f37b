"""Observer state, its update, and the (scale, zero_point) it implies.

An observer is a ``(min_val, max_val)`` pair of float32 tensors: scalars for
per-tensor grids, ``(C,)`` for per-channel ones. Uninitialized state is
``(+inf, -inf)``; the first update snaps to the batch, later ones take a
moving-average step ``m + c * (batch - m)`` (torch.ao.quantization's
MovingAverage observers), or a running min/max when ``c`` is None.

The qparams come in two forms, because the JAX package computes them in two
different programs and XLA rounds them differently in each:

* :func:`calculate_qparams_folded` is what ``freeze`` computes. There the
  observer state is a compile-time constant and XLA folds the qparams with
  IEEE division.
* :func:`calculate_qparams_traced` is what the train step computes, with the
  state as a runtime value: XLA turns the division by the constant
  ``qmax - qmin`` (or half of it, symmetric) into a multiply by its float32
  reciprocal, and keeps the zero point's division a true division.

In the traced train step XLA also contracts the moving-average step into
one fused multiply-add, ``fma(c, batch - m, m)``; :func:`update_observer`
rounds it once (``ops.requant.fma_f32``).
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


def batch_min_max(x: torch.Tensor, channel_axis: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 (min, max) of ``x``, over all of it or per ``channel_axis``."""
    x = x.to(torch.float32)
    if channel_axis is None:
        return torch.amin(x), torch.amax(x)
    axes = tuple(i for i in range(x.ndim) if i != channel_axis % x.ndim)
    return torch.amin(x, dim=axes), torch.amax(x, dim=axes)


def global_batch_min_max(x: torch.Tensor, mesh, channel_axis: Optional[int] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The global batch's (min, max) of this rank's ``x`` over a
    data-parallel ``mesh`` (``parallel.Mesh``): one all-reduce (MAX) of
    ``(-min, max)``."""
    from torch.distributed import ReduceOp

    bmin, bmax = batch_min_max(x, channel_axis)
    stats = mesh.all_reduce(torch.stack([-bmin, bmax]), ReduceOp.MAX)
    return -stats[0], stats[1]


def update_observer(state: ObserverState, x: torch.Tensor, spec: QSpec,
                    channel_axis: Optional[int] = None,
                    batch: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> ObserverState:
    """One observer step on a batch (pure; the new state is returned).
    ``batch`` gives the batch's (min, max) in place of ``x``'s (the global
    batch's under data parallelism)."""
    from ..ops.requant import fma_f32  # ops imports this module: import at use

    bmin, bmax = batch_min_max(x, channel_axis) if batch is None else batch
    m_min, m_max = state.min_val.to(torch.float32), state.max_val.to(torch.float32)
    uninit = torch.isinf(m_min)
    c = spec.averaging_constant
    if c is None:
        new_min = torch.minimum(torch.where(uninit, bmin, m_min), bmin)
        new_max = torch.maximum(torch.where(uninit, bmax, m_max), bmax)
    else:
        ct = torch.full((), c, dtype=torch.float32, device=m_min.device)
        new_min = torch.where(uninit, bmin, fma_f32(ct, bmin - m_min, m_min))
        new_max = torch.where(uninit, bmax, fma_f32(ct, bmax - m_max, m_max))
    return ObserverState(new_min, new_max)


def qparams_range_factor(spec: QSpec) -> float:
    """float32 ``1 / (qmax - qmin)`` (``1 / ((qmax - qmin) / 2)`` symmetric):
    the reciprocal XLA folds the traced qparams' constant division into."""
    from ..ops.requant import reciprocal  # ops imports this module: import at use

    span = float(spec.qmax - spec.qmin)
    return reciprocal(span / 2.0 if spec.symmetric else span)


def _qparams(state: ObserverState, spec: QSpec, traced: bool):
    qmin, qmax = spec.qmin, spec.qmax
    min_val = state.min_val.to(torch.float32)
    max_val = state.max_val.to(torch.float32)
    dev = min_val.device
    min_neg = torch.clamp(min_val, max=0.0)
    max_pos = torch.clamp(max_val, min=0.0)
    if spec.symmetric:
        amax = torch.maximum(-min_neg, max_pos)
        if traced:
            scale = amax * torch.full((), qparams_range_factor(spec), device=dev)
        else:
            scale = amax / torch.full((), (qmax - qmin) / 2.0, device=dev)
        scale = torch.clamp(scale, min=SCALE_EPS)
        # signed symmetric grid -> zp 0; unsigned symmetric -> mid-grid 128
        zero_point = torch.full_like(scale, 0 if qmin < 0 else 128, dtype=torch.int32)
    else:
        if traced:
            scale = (max_pos - min_neg) * torch.full((), qparams_range_factor(spec), device=dev)
        else:
            scale = (max_pos - min_neg) / torch.full((), float(qmax - qmin), device=dev)
        scale = torch.clamp(scale, min=SCALE_EPS)
        zero_point = qmin - torch.round(min_neg / scale)
        zero_point = torch.clamp(zero_point, qmin, qmax).to(torch.int32)
    uninit = torch.isinf(min_val)
    scale = torch.where(uninit, torch.ones_like(scale), scale)
    zero_point = torch.where(uninit, torch.zeros_like(zero_point), zero_point)
    return scale, zero_point


def calculate_qparams_folded(state: ObserverState, spec: QSpec
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale f32, zero_point int32) as the frozen graph folds them.

    The formulas of torch.ao.quantization's
    ``UniformQuantizationObserverBase._calculate_qparams`` (affine and
    symmetric branches) in float32 with IEEE division: under ``freeze`` they
    are compile-time constants. Uninitialized observers yield (1.0, 0).
    """
    return _qparams(state, spec, traced=False)


def calculate_qparams_traced(state: ObserverState, spec: QSpec
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale f32, zero_point int32) as the train step computes them.

    The same formulas with the state a runtime value: the scale multiplies
    the range by :func:`qparams_range_factor`, the zero point divides.
    """
    return _qparams(state, spec, traced=True)
