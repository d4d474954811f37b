"""Quantization boundary and observed-arithmetic modules, INT8 serving.

* :class:`Observer` holds one observer's state as buffers.
* :class:`QuantStub` / :func:`dequant`: the QuantStub/DeQuantStub pair.
* :class:`QAdd` / :class:`QCat`: the ``FloatFunctional`` requant points of
  skips and concats, each with its own activation observer.

Each module is frozen once by ``prepare_int8``, which takes the input grids
(known at freeze time) and returns the output grid; ``forward`` then runs
only tensor ops on the device. ``qparams`` is the counterpart of the JAX
modules' ``qparams_only`` branch (the fused block reads the grid and runs
the op itself).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from ..ops.requant import qadd_codes, reciprocal, requant_codes
from ..quant import QConfig, QNNPACK, calculate_qparams
from ..quant.observer import ObserverState
from ..quant.qtensor import QParams, QTensor


class Observer(nn.Module):
    """Observer state ``(min_val, max_val)`` as buffers."""

    def __init__(self, num_channels: Optional[int] = None):
        super().__init__()
        shape = () if num_channels is None else (num_channels,)
        self.register_buffer("min_val", torch.full(shape, float("inf")))
        self.register_buffer("max_val", torch.full(shape, float("-inf")))

    def state(self) -> ObserverState:
        return ObserverState(self.min_val.detach().cpu(), self.max_val.detach().cpu())


def observed_qparams(obs: Observer, spec) -> QParams:
    scale, zp = calculate_qparams(obs.state(), spec)
    return QParams(float(scale), int(zp))


class QuantStub(nn.Module):
    """Entry of the quant region: float NHWC -> QTensor on the observed grid."""

    def __init__(self, qconfig: QConfig = QNNPACK):
        super().__init__()
        self.qconfig = qconfig
        self.act = Observer()

    def prepare_int8(self, device) -> QParams:
        self._out = observed_qparams(self.act, self.qconfig.activation)
        self._inv = torch.tensor(reciprocal(self._out.scale), device=device)
        self._out_t = self._out.tensors(device)
        return self._out

    def forward(self, x: torch.Tensor) -> QTensor:
        spec = self.qconfig.activation
        q = torch.round(x * self._inv) + float(self._out.zero_point)
        return QTensor(torch.clamp(q, spec.qmin, spec.qmax).to(torch.uint8), *self._out_t)


def dequant(x):
    """DeQuantStub: QTensor -> float."""
    return x.dequantize() if isinstance(x, QTensor) else x


class _QBinary(nn.Module):
    """An observed binary op (FloatFunctional equivalent)."""

    def __init__(self, qconfig: QConfig = QNNPACK):
        super().__init__()
        self.qconfig = qconfig
        self.act = Observer()

    def qparams(self) -> QParams:
        return observed_qparams(self.act, self.qconfig.activation)

    def prepare_int8(self, inputs: Sequence[QParams], device) -> QParams:
        self._in: List[QParams] = list(inputs)
        self._out = self.qparams()
        self._mult = reciprocal(self._out.scale)
        self._out_t = self._out.tensors(device)
        return self._out


class QAdd(_QBinary):
    """FloatFunctional.add: ``rint(((qa - za) * sa + (qb - zb) * sb) / s)``."""

    def forward(self, a: QTensor, b: QTensor) -> QTensor:
        (sa, za), (sb, zb) = self._in
        q = qadd_codes(a.q, za, sa, b.q, zb, sb, self._mult, self._out.zero_point,
                       self.qconfig.activation.qmin, self.qconfig.activation.qmax)
        return QTensor(q, *self._out_t)


class QCat(_QBinary):
    """FloatFunctional.cat along the channel axis."""

    def forward(self, xs: Sequence[QTensor]) -> QTensor:
        spec = self.qconfig.activation
        parts = [requant_codes(x.q, z, s, self._mult, self._out.zero_point,
                               spec.qmin, spec.qmax)
                 for x, (s, z) in zip(xs, self._in)]
        return QTensor(torch.cat(parts, dim=-1), *self._out_t)
