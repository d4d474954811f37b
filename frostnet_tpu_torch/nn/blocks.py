"""Quant-aware composite blocks of the MobileNets (``frostnet_tpu/nn/blocks.py``).

Hard-swish and hard-sigmoid built from observed ops (each FloatFunctional
site keeps its own grid), squeeze-excite with a float ``QDense`` stack and
an observed gating multiply, and the MobileNetV2/V3 bottlenecks. Module and
variable names are the flax names, so JAX checkpoints and INT8 artifacts map
one to one.

In INT8 the blocks run frozen: ``prepare_int8(grid, device)`` takes the
input grid and returns the output grid, computing every constant once, and
``forward`` runs torch ops and the kernels of the convs. What the frozen JAX
graph computes, and the port with it:

* ``add_scalar(x, 3)`` keeps the codes and moves the zero point down by
  ``round(3 / s)`` (int32, often below 0); ``_relu6`` then clamps the codes
  as int32 between that zero point and ``round(6 / s) + zp``, which JAX casts
  to uint8 saturating at 255 (:func:`relu6_bounds`);
* ``QMul`` dequantizes both operands (the clamped int32 codes on the shifted
  grid, or the float SE gate) and requantizes the float32 product;
  ``mul_scalar(x, 1/6)`` scales the grid, ``f32(s * f32(1/6))``;
* the squeeze-excite's ``QDense`` layers run in float with weights
  fake-quantized once at freeze time, and their outputs fake-quantized on
  the folded grids (``calculate_qparams_folded``, IEEE ``1 / s``: the frozen
  graph's constants, not the train step's traced ones).

Two float reductions decide rare codes after the next requant: the SE's
spatial mean and the ``QDense`` products. XLA's CPU program sums the mean
sequentially in float32, and its dot has its own order; the port sums both
exactly (float64, rounded once to float32), so it gives the same answer on
every device, and the tests hold it to JAX within a stated band.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.requant import reciprocal
from ..quant import QConfig, QNNPACK, calculate_qparams_folded
from ..quant.fake_quant import fake_quant_forward
from ..quant.qtensor import QParams, QTensor
from .conv import QConvBNAct
from .mode import FP32, QuantMode
from .quant_ops import (Observer, QAdd, QMul, add_scalar, dequant, mul_scalar,
                        observed_fake_quant, observed_qparams, observed_standalone_act)

SIXTH = 1.0 / 6.0


def _relu(x):
    """ReLU; on a QTensor the codes clamp at the zero point (0.0)."""
    if isinstance(x, QTensor):
        return QTensor(torch.maximum(x.q, x.zero_point.to(x.q.dtype)), x.scale, x.zero_point)
    return torch.relu(x)


def relu6_bounds(x: QParams) -> Tuple[int, int]:
    """(lo, hi) of ``_relu6`` on grid ``x``: the int32 codes of 0.0 and 6.0,
    ``hi = round(f32(6) / s) + zp`` cast to uint8 as JAX casts it
    (saturating)."""
    q6 = torch.round(torch.tensor(6.0, dtype=torch.float32)
                     / torch.tensor(x.scale, dtype=torch.float32)) + float(x.zero_point)
    return x.zero_point, int(torch.clamp(q6, 0, 255))


def _relu6(x):
    """ReLU6; on a QTensor an int32 clamp on its grid (:func:`relu6_bounds`)."""
    if isinstance(x, QTensor):
        q6 = torch.round(torch.full((), 6.0, device=x.q.device) / x.scale) + x.zero_point
        q = torch.clamp(x.q.to(torch.int32), min=x.zero_point,
                        max=torch.clamp(q6, 0, 255).to(torch.int32))
        return QTensor(q, x.scale, x.zero_point)
    return torch.clamp(x, 0.0, 6.0)


def hswish_float(x: torch.Tensor) -> torch.Tensor:
    """``x * clip(x + 3, 0, 6) / 6`` of the float models (the division by a
    constant a multiply by its reciprocal, as XLA computes it)."""
    return mul_scalar(x * torch.clamp(x + 3.0, 0.0, 6.0), SIXTH)


class QHswish(nn.Module):
    """``x * relu6(x + 3) / 6`` as observed ops: add_scalar -> relu6 (a
    standalone ReLU6, observed in QAT) -> observed mul -> mul_scalar."""

    def __init__(self, qconfig: QConfig = QNNPACK):
        super().__init__()
        self.qconfig = qconfig
        self.relu6_obs = Observer()
        self.quant_mul = QMul(qconfig)

    def prepare_int8(self, x: QParams, device) -> QParams:
        shifted = add_scalar(x, 3.0)
        self._lo, self._hi = relu6_bounds(shifted)
        self._shift_t = shifted.tensors(device)
        out = mul_scalar(self.quant_mul.prepare_int8([x, shifted], device), SIXTH)
        self._out_t = out.tensors(device)
        return out

    def forward(self, x, mode: QuantMode = FP32):
        if isinstance(x, QTensor):  # INT8, frozen
            gate = QTensor(torch.clamp(x.q.to(torch.int32), self._lo, self._hi), *self._shift_t)
            return QTensor(self.quant_mul(x, gate, mode).q, *self._out_t)
        out = _relu6(add_scalar(x, 3.0))
        out = observed_standalone_act(out, self.relu6_obs, self.qconfig.activation, mode)
        return mul_scalar(self.quant_mul(x, out, mode), SIXTH)


class QHsigmoid(nn.Module):
    """``relu6(x + 3) / 6``; the standalone relu6 is observed in QAT. In the
    squeeze-excite its input is the float output of a ``QDense``, so in INT8
    it runs in float (the observer neither steps nor applies); in the
    LR-ASPP gate it takes a conv's QTensor, and ``prepare_int8`` freezes
    the ReLU6's int32 clamp on the shifted grid and the scaled output grid,
    as ``QHswish`` does."""

    def __init__(self, qconfig: QConfig = QNNPACK):
        super().__init__()
        self.qconfig = qconfig
        self.relu6_obs = Observer()

    def prepare_int8(self, x: QParams, device) -> QParams:
        shifted = add_scalar(x, 3.0)
        self._lo, self._hi = relu6_bounds(shifted)
        out = mul_scalar(shifted, SIXTH)
        self._out_t = out.tensors(device)
        return out

    def forward(self, x, mode: QuantMode = FP32):
        if isinstance(x, QTensor):  # INT8, frozen: int32 codes on the output grid
            return QTensor(torch.clamp(x.q.to(torch.int32), self._lo, self._hi), *self._out_t)
        out = _relu6(add_scalar(x, 3.0))
        out = observed_standalone_act(out, self.relu6_obs, self.qconfig.activation, mode)
        return mul_scalar(out, SIXTH)


def _exact_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """float32 ``x @ w`` from float64 products and sums, rounded once: the
    same on every device (the products are exact, the sums nearly so)."""
    return (x.to(torch.float64) @ w.to(torch.float64)).to(torch.float32)


def spatial_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over H and W of NHWC ``x``: the float32 sum (exact in float64,
    rounded once) times ``f32(1 / (H * W))``, in ``x``'s dtype."""
    s = x.to(torch.float64).sum(dim=(1, 2)).to(torch.float32)
    inv = torch.full((), reciprocal(float(x.shape[1] * x.shape[2])), device=s.device)
    return (s * inv).to(x.dtype)


class QDense(nn.Module):
    """Quant-aware fully connected layer (the SE stack, MobileNetV2's
    classifier): weight fake-quant and an output observer, like a fused
    LinearReLU. The kernel keeps JAX's ``(in, out, 1, 1)`` shape, which the
    artifact layout and the weight-decay groups (a 4-D kernel with
    ``shape[2] == 1`` decays by 0) depend on. Its output is float in every
    phase; in INT8 the weight and output are fake-quantized on the frozen
    grids."""

    def __init__(self, in_features: int, features: int, use_bias: bool = False,
                 act: Optional[str] = None, quantized: bool = True,
                 qconfig: QConfig = QNNPACK):
        super().__init__()
        if act not in (None, "relu"):
            raise ValueError(f"QDense takes act None or 'relu', got {act!r}")
        self.in_features, self.features = in_features, features
        self.use_bias, self.act, self.quantized, self.qconfig = use_bias, act, quantized, qconfig
        self.kernel = nn.Parameter(torch.zeros(in_features, features, 1, 1))
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(features))
        if quantized:
            self.w_obs = Observer(features if qconfig.weight.per_channel else None)
            self.act_obs = Observer(None)

    def prepare_int8(self, device) -> None:
        """Fake-quantize the weight once and fold the output grid."""
        if not self.quantized:
            return
        wspec, aspec = self.qconfig.weight, self.qconfig.activation
        w = self.kernel.detach().cpu()[..., 0, 0]
        scale, zp = calculate_qparams_folded(self.w_obs.state(), wspec)
        self._w = fake_quant_forward(w, scale, zp, wspec.qmin, wspec.qmax,
                                     -1 if wspec.per_channel else None)[0].to(device)
        out = observed_qparams(self.act_obs, aspec)
        self._out_t = out.tensors(device)

    def forward(self, x, mode: QuantMode = FP32):
        x = dequant(x)
        w = self.kernel[..., 0, 0]
        wspec, aspec = self.qconfig.weight, self.qconfig.activation
        if self.quantized and mode.int8:
            w = self._w
        elif self.quantized:
            w = observed_fake_quant(w, self.w_obs, wspec, mode,
                                    -1 if wspec.per_channel else None, replicated=True)
        y = _exact_matmul(x, w)
        if self.use_bias:
            y = y + self.bias
        if self.act == "relu":
            y = torch.relu(y)
        if self.quantized and mode.int8:
            y = fake_quant_forward(y, *self._out_t, aspec.qmin, aspec.qmax)[0]
        elif self.quantized:
            y = observed_fake_quant(y, self.act_obs, aspec, mode)
        return y


class QSEModule(nn.Module):
    """Squeeze-excite with a hard-sigmoid gate and an observed channel-wise
    mul; the fc stack runs in float in every phase (INT8 too)."""

    def __init__(self, channels: int, reduction: int = 4, quantized: bool = True,
                 qconfig: QConfig = QNNPACK):
        super().__init__()
        self.quantized = quantized
        kw = dict(quantized=quantized, qconfig=qconfig)
        self.fc1 = QDense(channels, channels // reduction, act="relu", **kw)
        self.fc2 = QDense(channels // reduction, channels, **kw)
        self.hsig = QHsigmoid(qconfig)
        if quantized:
            self.quant_mul = QMul(qconfig)

    def prepare_int8(self, x: QParams, device) -> QParams:
        self.fc1.prepare_int8(device)
        self.fc2.prepare_int8(device)
        return self.quant_mul.prepare_int8([x], device)

    def forward(self, x, mode: QuantMode = FP32):
        xf = dequant(x)
        s = self.fc2(self.fc1(spatial_mean(xf), mode), mode)
        s = self.hsig(s, mode)[:, None, None, :]
        if self.quantized:
            return self.quant_mul(x, s, mode)
        return xf * s


def _channels(x) -> int:
    return (x.q if isinstance(x, QTensor) else x).shape[-1]


class InvertedResidual(nn.Module):
    """MobileNetV2 inverted residual: expand 1x1 (ReLU) -> depthwise (ReLU)
    -> linear project, with an observed skip add where shapes allow."""

    def __init__(self, in_channels: int, out_channels: int, strides: int = 1,
                 expand_ratio: int = 6, kernel_size: int = 3, dilation: int = 1,
                 quantized: bool = True, qconfig: QConfig = QNNPACK,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = int(round(in_channels * expand_ratio))
        self.quantized = quantized
        self.use_res = strides == 1 and in_channels == out_channels
        kw = dict(quantized=quantized, qconfig=qconfig, dtype=dtype)
        if expand_ratio != 1:
            self.expand = QConvBNAct(in_channels, hidden, 1, act="relu", **kw)
        self.dw = QConvBNAct(hidden, hidden, kernel_size, strides=strides,
                             padding=dilation * (kernel_size - 1) // 2, dilation=dilation,
                             groups=hidden, act="relu", **kw)
        self.project = QConvBNAct(hidden, out_channels, 1, act=None, **kw)
        if self.use_res and quantized:
            self.skip_add = QAdd(qconfig)

    def prepare_int8(self, x: QParams, device) -> QParams:
        g = self.expand.prepare_int8(x, device) if hasattr(self, "expand") else x
        g = self.project.prepare_int8(self.dw.prepare_int8(g, device), device)
        if self.use_res:
            g = self.skip_add.prepare_int8([x, g], device)
        return g

    def forward(self, x, mode: QuantMode = FP32, train: bool = False):
        out = self.expand(x, mode, train) if hasattr(self, "expand") else x
        out = self.project(self.dw(out, mode, train), mode, train)
        if self.use_res:
            out = self.skip_add(x, out, mode) if self.quantized else x + out
        return out


class BottleneckV3(nn.Module):
    """MobileNetV3 bottleneck: expand 1x1 (HS or RE) -> depthwise ConvBN ->
    optional SE -> activation -> linear project, observed skip add. The
    expand conv exists even where ``exp_size`` equals the input width, and
    the bare ReLU after the SE of RE blocks has no observer (torch's eager
    QAT gives a plain ReLU none)."""

    def __init__(self, in_channels: int, out_channels: int, exp_size: int, kernel_size: int,
                 strides: int, dilation: int = 1, se: bool = False, nl: str = "RE",
                 quantized: bool = True, qconfig: QConfig = QNNPACK,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.quantized, self.hs, self.se_on = quantized, nl == "HS", se
        self.use_res = strides == 1 and in_channels == out_channels
        kw = dict(quantized=quantized, qconfig=qconfig, dtype=dtype)
        self.expand = QConvBNAct(in_channels, exp_size, 1, act=None if self.hs else "relu", **kw)
        if self.hs and quantized:
            self.expand_hs = QHswish(qconfig)
        self.dw = QConvBNAct(exp_size, exp_size, kernel_size, strides=strides,
                             padding=(kernel_size - 1) // 2 * dilation, dilation=dilation,
                             groups=exp_size, act=None, **kw)
        if se:
            self.se = QSEModule(exp_size, quantized=quantized, qconfig=qconfig)
        if self.hs and quantized:
            self.dw_hs = QHswish(qconfig)
        self.project = QConvBNAct(exp_size, out_channels, 1, act=None, **kw)
        if self.use_res and quantized:
            self.skip_add = QAdd(qconfig)

    def prepare_int8(self, x: QParams, device) -> QParams:
        g = self.expand.prepare_int8(x, device)
        if self.hs:
            g = self.expand_hs.prepare_int8(g, device)
        g = self.dw.prepare_int8(g, device)
        if self.se_on:
            g = self.se.prepare_int8(g, device)
        if self.hs:
            g = self.dw_hs.prepare_int8(g, device)
        g = self.project.prepare_int8(g, device)  # the bare ReLU keeps its grid
        if self.use_res:
            g = self.skip_add.prepare_int8([x, g], device)
        return g

    def _hswish(self, name: str, x, mode: QuantMode):
        return getattr(self, name)(x, mode) if self.quantized else hswish_float(x)

    def forward(self, x, mode: QuantMode = FP32, train: bool = False):
        out = self.expand(x, mode, train)
        if self.hs:
            out = self._hswish("expand_hs", out, mode)
        out = self.dw(out, mode, train)
        if self.se_on:
            out = self.se(out, mode)
        out = self._hswish("dw_hs", out, mode) if self.hs else _relu(out)
        out = self.project(out, mode, train)
        if self.use_res:
            out = self.skip_add(x, out, mode) if self.quantized else x + out
        return out
