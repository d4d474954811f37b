"""QConvBNAct: conv + BN + activation, quant-aware.

The variables are those of ``frostnet_tpu/nn/conv.py::QConvBNAct`` under the
same names: the parameters ``kernel`` (HWIO float), ``bias``, ``scale`` and
``bias_bn`` (BN gamma/beta), and the buffers ``mean`` and ``var`` (BN
running stats) and the observers ``w_obs`` and ``act_obs``. A block made
with ``quantized=False`` (the GAN generator's float tail) has no observers
and runs in float in every phase, INT8 included.

``forward(x, mode, train)`` runs the phase ``mode`` names, as the JAX
module does (activations NHWC at the boundary):

* FP32: conv -> BN (batch statistics in train mode, running ones in eval)
  -> act (the StatAssist warm-up; ``relu6`` is ``clamp(y, 0, 6)``);
* QAT train: the ``torch.nn.intrinsic.qat.ConvBn2d`` recipe:
  ``sf = gamma / sqrt(var + eps)``, the weight ``w * sf`` observed and
  fake-quantized, conv, ``/ sf``, BN on batch statistics (biased variance
  to normalize, unbiased into the running estimate, momentum 0.1), act;
* QAT eval: running-statistics BN folded into the weight and bias, the
  folded weight fake-quantized; without BN (the classifier) the weight
  itself;
* QAT and QAT_FROZEN then fake-quantize the activation on ``act_obs``'s
  grid (``observe`` steps the observers), and the output is stored in the
  compute ``dtype`` (bf16 for the benchmarked step);
* INT8: the frozen graph (below).

Convolutions run in ``dtype`` through ``torch.nn.functional.conv2d`` on
permuted views, so the NHWC activations are ``channels_last`` tensors to
cuDNN; BN runs in float32. The conv of a float block (``quantized=False``)
runs in float32 on the card whatever the caller set: TF32, which cuDNN
allows by default, is off for the call. The convs of quantized blocks
follow the caller's TF32 setting.

``prepare_int8`` freezes the conv once: BN fold, weight quantization on the
weight observer's grid (``fold_bn`` -> ``calculate_qparams_folded`` ->
``quantize``, the JAX chain op for op), column sums, the epilogue constants
and the packed operands, all on the target device. The INT8 forward then
takes one of five routes:

* 1x1: one INT8 matmul (``ops/int8_matmul``);
* depthwise kxk, dilated or not (the segmentation trunks' last stage runs
  dilation 2), with or without a channel multiplier (the SSD extras' 3x3
  maps 32 -> 128 channels, output channel ``oc`` reading input ``oc // 4``):
  k*k shifted integer multiply-adds in torch over (k*k, Cout) taps, tap
  ``(dy, dx)`` at ``dilation * (dy, dx)`` (JAX runs the same multiply-adds as
  XLA code, not a TPU kernel);
* dense 3x3 stride 1 dilation 1 with 'same' padding (the GAN's ResnetBlock
  and up convs): the dense 3x3 INT8 conv kernel (``ops/int8_conv``);
* any other dense kxk (the stems, strided convs, R-ASPP's atrous 3x3s):
  zero-point-padded im2col patches (dilated taps where the conv is) and one
  INT8 matmul, whatever K the patches have;
* grouped kxk (ResNeXt's ``groups=32`` 3x3s): the exact int32 sum of a
  float64 grouped conv in torch (``ops/requant.py::conv_acc``; JAX
  runs it as an s32 ``lax.conv``, XLA code, not a TPU kernel), then the
  shared epilogue. Padded 1x1 convs and dilated grouped convs are refused.

Every route takes ``relu6`` as a narrower clamp of the codes. The frozen
epilogue computes ``quantize(clip(y, 0, 6))``; quantize is monotone, so that
equals ``clamp(rint(y * f32(1/s)) + zp, max(qmin, zp), min(qmax, q6))`` with
``q6 = rint(f32(6) * f32(1/s)) + zp``, the epilogue's own arithmetic
(:meth:`QConvBNAct.code_range`).
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.int8_conv import conv3x3_operands, conv3x3_s1_int8
from ..ops.int8_matmul import conv1x1_operands, int8_matmul_requant
from ..ops.requant import (conv_acc, depthwise_acc, epilogue_constants, reciprocal,
                           requant_epilogue)
from ..quant import QConfig, QNNPACK, bn_scale_factor, calculate_qparams_folded, fold_bn, quantize
from ..quant.qtensor import QParams, QTensor
from .mode import FP32, QuantMode
from .quant_ops import Observer, observed_fake_quant, observed_qparams


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


@contextlib.contextmanager
def _full_f32(x: torch.Tensor, on: bool):
    """TF32 off for cuDNN while a float32 conv on the card runs, if ``on``."""
    if not on or x.device.type != "cuda" or x.dtype != torch.float32:
        yield
        return
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class QConvBNAct(nn.Module):
    """Conv2d + optional BatchNorm + optional activation, quant-aware."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Union[int, Sequence[int]] = 3, strides: int = 1,
                 padding: int = 0, dilation: int = 1, groups: int = 1, use_bn: bool = True,
                 use_bias: bool = False, act: Optional[str] = "relu",
                 quantized: bool = True, qconfig: QConfig = QNNPACK,
                 bn_momentum: float = 0.1, bn_eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        acts = (None, "relu", "relu6") if quantized else (None, "relu", "relu6", "tanh")
        if act not in acts:
            raise ValueError(f"the port supports act {acts} on a "
                             f"{'quantized' if quantized else 'float'} block, got {act!r}")
        kh, kw = _pair(kernel_size)
        self.in_features, self.features = in_features, features
        self.kernel_size, self.strides, self.padding = (kh, kw), strides, padding
        self.dilation = dilation
        self.groups, self.use_bn, self.use_bias, self.act = groups, use_bn, use_bias, act
        self.quantized = quantized
        self.qconfig, self.bn_momentum, self.bn_eps, self.dtype = qconfig, bn_momentum, bn_eps, dtype
        self.kernel = nn.Parameter(torch.zeros(kh, kw, in_features // groups, features))
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(features))
        if use_bn:
            self.scale = nn.Parameter(torch.ones(features))
            self.bias_bn = nn.Parameter(torch.zeros(features))
            self.register_buffer("mean", torch.zeros(features))
            self.register_buffer("var", torch.ones(features))
        if quantized:
            self.w_obs = Observer(features if qconfig.weight.per_channel else None)
            self.act_obs = Observer(None)

    @property
    def depthwise(self) -> bool:
        return self.groups > 1 and self.groups == self.in_features

    def int8_params(self):
        """(qw, w_scale, bias, out_scale, out_zp) on the CPU: the frozen INT8
        operands (the JAX module's ``int8_params_only`` branch)."""
        wspec = self.qconfig.weight
        w = self.kernel.detach().cpu()
        bias = self.bias.detach().cpu() if self.use_bias else None
        if self.use_bn:
            wf, bf = fold_bn(w, bias, self.scale.detach().cpu(), self.bias_bn.detach().cpu(),
                             self.mean.detach().cpu(), self.var.detach().cpu(), self.bn_eps)
        else:
            wf = w
            bf = bias if bias is not None else torch.zeros(self.features)
        w_scale, w_zp = calculate_qparams_folded(self.w_obs.state(), wspec)
        qw = quantize(wf, w_scale, w_zp, wspec, channel_axis=-1 if wspec.per_channel else None)
        out = observed_qparams(self.act_obs, self.qconfig.activation)
        return qw, w_scale, bf, out.scale, out.zero_point

    def code_range(self, out_mult: float, out_zp: int) -> Tuple[int, int]:
        """(qmin, qmax) of the frozen epilogue's output codes: the grid's, or
        for ``relu6`` the codes of [0, 6] (``out_mult`` is the epilogue's
        ``f32(1/s)``)."""
        aspec = self.qconfig.activation
        if self.act != "relu6":
            return aspec.qmin, aspec.qmax
        q6 = torch.round(torch.tensor(6.0, dtype=torch.float32)
                         * torch.tensor(out_mult, dtype=torch.float32))
        return max(aspec.qmin, out_zp), min(aspec.qmax, int(q6) + out_zp)

    def prepare_int8(self, x: QParams, device) -> QParams:
        """Freeze the conv for inputs on grid ``x``; returns the output grid."""
        qw, w_scale, bf, out_s, out_zp = self.int8_params()
        comb = torch.tensor(x.scale, dtype=torch.float32) * w_scale
        relu = self.act in ("relu", "relu6")
        qmin, qmax = self.code_range(reciprocal(out_s), int(out_zp))
        kh, kw = self.kernel_size
        self._in, self._out = x, QParams(out_s, out_zp)
        self._out_t = self._out.tensors(device)
        if kh == 1 and kw == 1 and self.groups == 1:
            if self.padding:
                raise ValueError("padded 1x1 convs are not part of the INT8 port")
            self._route = "matmul"
            self._op = conv1x1_operands(qw[0, 0], comb, bf, x.zero_point, out_s, out_zp,
                                        relu, qmin, qmax, device)
        elif self.depthwise:  # channel multiplier features // groups, 1 or more
            if kh != kw or self.padding != self.dilation * (kh - 1) // 2:
                raise ValueError("the INT8 depthwise route takes square kernels with "
                                 "'same' padding (dilation * (k - 1) // 2)")
            self._route = "depthwise"
            self._taps = qw.reshape(kh * kw, self.features).to(device)
            scale, bias, mult = epilogue_constants(comb, bf, out_s, relu)
            self._epilogue = (scale.to(device), bias.to(device), mult, qmin, qmax)
        elif ((kh, kw) == (3, 3) and self.strides == 1 and self.padding == 1
              and self.dilation == 1 and self.groups == 1):
            self._route = "dense3x3"
            self._op = conv3x3_operands(qw, comb, bf, x.zero_point, out_s, out_zp, relu,
                                        qmin, qmax, device)
        elif self.groups == 1:
            self._route = "im2col"
            self._op = conv1x1_operands(qw.reshape(kh * kw * self.in_features, self.features),
                                        comb, bf, x.zero_point, out_s, out_zp, relu,
                                        qmin, qmax, device)
        elif self.dilation == 1:
            self._route = "grouped"
            self._w64 = qw.to(torch.float64).permute(3, 2, 0, 1).contiguous().to(device)
            scale, bias, mult = epilogue_constants(comb, bf, out_s, relu)
            self._epilogue = (scale.to(device), bias.to(device), mult, qmin, qmax)
        else:
            raise ValueError(f"a dilated grouped conv ({self.in_features} -> {self.features}, "
                             f"groups {self.groups}) is not part of the INT8 port")
        return self._out

    def _patches(self, q: torch.Tensor) -> torch.Tensor:
        """Zero-point-padded im2col patches, columns in (dy, dx, cin) order
        (tap ``(dy, dx)`` reads ``dilation * (dy, dx)`` from the window's
        corner), then zero columns up to a multiple of 16: the matmul kernel
        reads 16-byte aligned rows, and the packed weight is zero there."""
        kh, kw = self.kernel_size
        s, p, d = self.strides, self.padding, self.dilation
        if p:
            q = torch.nn.functional.pad(q, (0, 0, p, p, p, p), value=self._in.zero_point)
        hp, wp = q.shape[1], q.shape[2]
        ho, wo = (hp - d * (kh - 1) - 1) // s + 1, (wp - d * (kw - 1) - 1) // s + 1
        cols = [q[:, d * dy:d * dy + (ho - 1) * s + 1:s, d * dx:d * dx + (wo - 1) * s + 1:s, :]
                for dy in range(kh) for dx in range(kw)]
        pad = -(kh * kw * q.shape[3]) % 16
        if pad:
            cols.append(q.new_zeros(q.shape[0], ho, wo, pad))
        return torch.cat(cols, dim=-1)

    def _conv(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """NHWC ``x`` (*) HWIO ``w`` -> NHWC, in the compute dtype."""
        xt = x.to(self.dtype).permute(0, 3, 1, 2)
        wt = w.to(self.dtype).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        with _full_f32(xt, not self.quantized):
            y = F.conv2d(xt, wt, None, self.strides, self.padding, self.dilation, self.groups)
        return y.permute(0, 2, 3, 1)

    def _batch_norm(self, y: torch.Tensor, train: bool) -> torch.Tensor:
        """BN over NHWC ``y`` in float32; in train mode it normalizes with the
        batch statistics and steps the running ones once."""
        y = F.batch_norm(y.to(torch.float32).permute(0, 3, 1, 2), self.mean, self.var,
                         self.scale, self.bias_bn, training=train,
                         momentum=self.bn_momentum, eps=self.bn_eps)
        return y.permute(0, 2, 3, 1)

    def _float_forward(self, x: torch.Tensor, mode: QuantMode, train: bool) -> torch.Tensor:
        wspec, aspec = self.qconfig.weight, self.qconfig.activation
        w_axis = -1 if wspec.per_channel else None
        bias = self.bias if self.use_bias else None
        q_on = self.quantized and (mode.fake_quant or mode.observe)
        if q_on and self.use_bn and train:
            sf = bn_scale_factor(self.scale, self.var, self.bn_eps)
            w_q = observed_fake_quant(self.kernel * sf, self.w_obs, wspec, mode, w_axis)
            y = self._conv(x, w_q) / sf
            if bias is not None:
                y = y + bias
            y = self._batch_norm(y, True)
        elif q_on and self.use_bn:
            wf, bf = fold_bn(self.kernel, bias, self.scale, self.bias_bn, self.mean, self.var,
                             self.bn_eps)
            w_q = observed_fake_quant(wf, self.w_obs, wspec, mode, w_axis)
            y = self._conv(x, w_q) + bf
        elif q_on:  # quantized conv without BN (the classifier)
            w_q = observed_fake_quant(self.kernel, self.w_obs, wspec, mode, w_axis)
            y = self._conv(x, w_q)
            if bias is not None:
                y = y + bias
        else:
            y = self._conv(x, self.kernel)
            if bias is not None:
                y = y + bias
            if self.use_bn:
                y = self._batch_norm(y, train)
        if self.act == "relu":
            y = F.relu(y)
        elif self.act == "relu6":
            y = torch.clamp(y, 0.0, 6.0)
        elif self.act == "tanh":
            y = torch.tanh(y)
        if q_on:
            y = observed_fake_quant(y, self.act_obs, aspec, mode)
        return y.to(self.dtype)

    def forward(self, x, mode: QuantMode = FP32, train: bool = False):
        """NHWC float ``x`` in FP32/QAT/QAT_FROZEN and into a float block; a
        QTensor into a quantized block in INT8 (frozen)."""
        if not mode.int8 or not self.quantized:
            return self._float_forward(x, mode, train)
        if self._route in ("depthwise", "grouped"):
            if self._route == "depthwise":
                acc = depthwise_acc(x.q, self._taps, self.kernel_size[0], self.strides,
                                    self._in.zero_point, self.dilation)
            else:
                acc = conv_acc(x.q, self._w64, self._in.zero_point, self.strides,
                               self.padding, self.groups)
            scale, bias, mult, qmin, qmax = self._epilogue
            q = requant_epilogue(acc, scale, bias, mult, self._out.zero_point,
                                 self.act in ("relu", "relu6"), qmin, qmax)
            return QTensor(q, *self._out_t)
        if self._route == "dense3x3":
            return QTensor(conv3x3_s1_int8(x.q, self._op), *self._out_t)
        a = self.matmul_input(x.q)
        q = int8_matmul_requant(a.reshape(-1, a.shape[-1]), self._op).reshape(a.shape[:3] + (self.features,))
        return QTensor(q, *self._out_t)

    def matmul_input(self, q: torch.Tensor) -> torch.Tensor:
        """The (B, Ho, Wo, K') matmul operand of the 1x1 and im2col routes:
        K' is the conv's K on the 1x1 route; the im2col route pads it with
        zero columns to a multiple of 16 (``_patches``)."""
        if self._route == "matmul":
            return q[:, ::self.strides, ::self.strides, :] if self.strides != 1 else q
        return self._patches(q)
