"""Quantization boundary and observed-arithmetic modules.

* :class:`Observer` holds one observer's state as buffers.
* :func:`observed_fake_quant`: ``apply_observer`` of the JAX package, the
  observer step and fake-quant of one site.
* :class:`QuantStub` / :func:`dequant`: the QuantStub/DeQuantStub pair.
* :func:`observed_standalone_act`: a bare ReLU6 module's FakeQuantize
  (observed in QAT, a pass-through for QTensors in INT8).
* :class:`QAdd` / :class:`QAddReLU` / :class:`QCat` / :class:`QMul`: the ``FloatFunctional``
  requant points of skips, concats and gates, each with its own activation
  observer; :func:`add_scalar` / :func:`mul_scalar` have none (they move the
  zero point or the scale of a QTensor).

``forward(..., mode)`` runs the phase ``mode`` names. In FP32 the modules
pass values through; in QAT and QAT_FROZEN each output goes through
:func:`observed_fake_quant`. In INT8 each module runs frozen: ``prepare_int8``
takes the input grids (known at freeze time) and returns the output grid,
and ``forward`` then runs only tensor ops on the device. ``qparams`` is the
counterpart of the JAX modules' ``qparams_only`` branch (the fused block
reads the grid and runs the op itself).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from ..ops.fake_quant import ObservedFakeQuant
from ..ops.requant import qadd_codes, reciprocal, requant_codes
from ..quant import (QConfig, QNNPACK, QSpec, calculate_qparams_folded,
                     calculate_qparams_traced, fake_quantize, update_observer)
from ..quant.observer import ObserverState
from ..quant.qtensor import QParams, QTensor
from .mode import FP32, QuantMode


class Observer(nn.Module):
    """Observer state ``(min_val, max_val)`` as buffers."""

    def __init__(self, num_channels: Optional[int] = None):
        super().__init__()
        shape = () if num_channels is None else (num_channels,)
        self.register_buffer("min_val", torch.full(shape, float("inf")))
        self.register_buffer("max_val", torch.full(shape, float("-inf")))

    def state(self) -> ObserverState:
        """A detached host copy of the state (for freezing)."""
        return ObserverState(self.min_val.detach().cpu(), self.max_val.detach().cpu())

    def live(self) -> ObserverState:
        """The state buffers themselves."""
        return ObserverState(self.min_val, self.max_val)


def observed_qparams(obs: Observer, spec) -> QParams:
    """The frozen grid of an observer (``freeze``'s folded qparams)."""
    scale, zp = calculate_qparams_folded(obs.state(), spec)
    return QParams(float(scale), int(zp))


def observed_fake_quant(x: torch.Tensor, obs: Observer, spec: QSpec, mode: QuantMode,
                        channel_axis: Optional[int] = None) -> torch.Tensor:
    """Observe ``x`` (``mode.observe``) and fake-quantize it (``mode.fake_quant``).

    The JAX package's ``apply_observer``: the state steps first, in place and
    outside autograd, and the qparams come from the updated state. A
    per-tensor site runs the ``ops.fake_quant`` kernel on the GPU; a
    per-channel site (fbgemm weights) runs torch ops.
    """
    if channel_axis is None and mode.fake_quant:
        return ObservedFakeQuant.apply(x, obs, spec, mode.observe)
    if mode.observe:
        with torch.no_grad():
            st = update_observer(obs.live(), x.detach(), spec, channel_axis)
            obs.min_val.copy_(st.min_val)
            obs.max_val.copy_(st.max_val)
    if mode.fake_quant:
        scale, zp = calculate_qparams_traced(obs.live(), spec)
        x = fake_quantize(x, scale, zp, spec, channel_axis)
    return x


def observed_standalone_act(x, obs: Observer, spec: QSpec, mode: QuantMode):
    """A standalone ``nn.ReLU6``'s FakeQuantize (``frostnet_tpu/nn/quant_ops.py``
    ``observed_standalone_act``): a float ``x`` is observed and fake-quantized
    as ``mode`` says (in INT8 neither: it passes), a QTensor passes untouched
    (the caller already clamped it on the integer grid)."""
    if isinstance(x, QTensor):
        return x
    return observed_fake_quant(x, obs, spec, mode)


def _div_round(s: float, scale) -> int:
    """``round(f32(s) / f32(scale))`` as an int (IEEE division, half to even)."""
    q = torch.tensor(s, dtype=torch.float32) / torch.as_tensor(scale, dtype=torch.float32)
    return int(torch.round(q))


def add_scalar(x, s: float):
    """FloatFunctional.add_scalar: a QTensor (or its frozen grid, QParams)
    keeps its codes and scale and its zero point moves down by
    ``round(s / scale)`` (int32; it may go below 0); a float tensor adds ``s``
    in its own dtype."""
    if isinstance(x, QParams):
        return QParams(x.scale, x.zero_point - _div_round(s, x.scale))
    if isinstance(x, QTensor):
        shift = torch.round(torch.full((), s, dtype=torch.float32, device=x.q.device) / x.scale)
        return QTensor(x.q, x.scale, x.zero_point - shift.to(torch.int32))
    return x + s


def mul_scalar(x, s: float):
    """FloatFunctional.mul_scalar: a QTensor (or QParams) keeps its codes and
    its scale takes the factor (float32 product); a float tensor multiplies
    by ``s`` rounded to its dtype, as JAX's weakly typed constant is."""
    if isinstance(x, QParams):
        return QParams(float(torch.tensor(x.scale, dtype=torch.float32)
                             * torch.tensor(s, dtype=torch.float32)), x.zero_point)
    if isinstance(x, QTensor):
        return QTensor(x.q, x.scale * torch.full((), s, dtype=torch.float32,
                                                 device=x.q.device), x.zero_point)
    return x * torch.full((), s, dtype=x.dtype, device=x.device)


def requantize(y: torch.Tensor, mult: torch.Tensor, zp: int, spec: QSpec) -> torch.Tensor:
    """float ``y`` -> codes on a frozen grid: ``clamp(rint(y * f32(1/s)) + zp)``
    (``quantize`` with XLA's reciprocal; ``mult`` a 0-dim device tensor)."""
    q = torch.round(y.to(torch.float32) * mult) + float(zp)
    return torch.clamp(q, spec.qmin, spec.qmax).to(spec.storage_dtype)


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

    def forward(self, x: torch.Tensor, mode: QuantMode = FP32):
        spec = self.qconfig.activation
        if not mode.int8:
            return observed_fake_quant(x, self.act, spec, mode)
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
        self._mult_t = torch.tensor(self._mult, dtype=torch.float32, device=device)
        self._out_t = self._out.tensors(device)
        return self._out


class QAdd(_QBinary):
    """FloatFunctional.add: ``rint(((qa - za) * sa + (qb - zb) * sb) / s)``,
    rounded as the frozen graph's fusion rounds it
    (``ops.requant.qadd_codes``): ``loaded`` names the operands whose codes
    that fusion reads from memory rather than makes."""

    _relu = False

    def prepare_int8(self, inputs: Sequence[QParams], device,
                     loaded: Sequence[bool] = (False, False)) -> QParams:
        self._contract = next((i for i, on in enumerate(loaded) if on), None)
        return super().prepare_int8(inputs, device)

    def _float(self, a, b):
        return a + b

    def forward(self, a, b, mode: QuantMode = FP32):
        if not mode.int8:
            return observed_fake_quant(self._float(a, b), self.act, self.qconfig.activation,
                                       mode)
        (sa, za), (sb, zb) = self._in
        q = qadd_codes(a.q, za, sa, b.q, zb, sb, self._mult, self._out.zero_point,
                       self.qconfig.activation.qmin, self.qconfig.activation.qmax,
                       relu=self._relu, contract=self._contract)
        return QTensor(q, *self._out_t)


class QAddReLU(QAdd):
    """FloatFunctional.add_relu (the ResNet blocks' joins): ``relu(a + b)``
    observed and fake-quantized; in INT8 the codes of
    ``relu((qa - za) * sa + (qb - zb) * sb)`` on the stored grid, rounded as
    :class:`QAdd` rounds (the max pool's output is loaded, for the first
    block of a BasicBlock ResNet)."""

    _relu = True

    def _float(self, a, b):
        return torch.relu(a + b)


class QMul(_QBinary):
    """FloatFunctional.mul (the hard-swish and squeeze-excite gates): in INT8
    each operand, a QTensor or a float, is dequantized, the float32 product
    requantized on the stored grid."""

    def forward(self, a, b, mode: QuantMode = FP32):
        if not mode.int8:
            return observed_fake_quant(a * b, self.act, self.qconfig.activation, mode)
        y = dequant(a) * dequant(b)
        return QTensor(requantize(y, self._mult_t, self._out.zero_point,
                                  self.qconfig.activation), *self._out_t)


class QCat(_QBinary):
    """FloatFunctional.cat along the channel axis. In INT8 a QTensor part is
    requantized from its own grid (``ops.requant.requant_codes``: its
    dequantize, then the multiply by ``f32(1/s)``), a float part (R-ASPP's
    pooled branch, resized) is quantized on the stored grid; the grid of a
    float part given to ``prepare_int8`` is None."""

    def forward(self, xs: Sequence, mode: QuantMode = FP32):
        if not mode.int8:
            return observed_fake_quant(torch.cat(list(xs), dim=-1), self.act,
                                       self.qconfig.activation, mode)
        spec = self.qconfig.activation
        parts = [requant_codes(x.q, g.zero_point, g.scale, self._mult, self._out.zero_point,
                               spec.qmin, spec.qmax) if isinstance(x, QTensor)
                 else requantize(x, self._mult_t, self._out.zero_point, spec)
                 for x, g in zip(xs, self._in)]
        return QTensor(torch.cat(parts, dim=-1), *self._out_t)
