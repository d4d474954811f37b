"""Segmentation heads: Lite R-ASPP and R-ASPP (``frostnet_tpu/segmentation/heads.py``).

Module and variable names are the JAX package's. Each head runs the phase
``mode`` names; in INT8 it runs frozen (``prepare_int8(grid, device)``
first, as every quantized module of the port):

* ``LRASPP``: a 1x1 ConvBNReLU branch (``b0``) times a gate: the average
  pool of the input (window ``min(pool_window, H, W)``, stride
  ``min(pool_stride, window)``; one 1x1 window at the Cityscapes crop of
  768 and at the small crops), a 1x1 ConvBN (``b1_conv``), a hard-sigmoid
  (``b1_hsig``), dequantized and resized to the branch's size. The join is
  an observed multiply (``quant_mul``). In INT8 the pool averages the codes
  on the input's grid (``nn.pool.avg_pool``), ``b1_conv`` is one INT8 matmul
  of B rows, the hard-sigmoid clamps int32 codes on its shifted grid, and
  the 1x1 gate's resize is an exact broadcast (interpolation weight 1).
* ``LRASPPHead``: ``LRASPP`` on c4, resized in float to c1's size.
* ``RASPP`` / ``ASPPPooling`` / ``RASPPHead``: the R-ASPP head (a 1x1
  branch, three atrous 3x3 branches on the im2col route with dilated taps, a
  global-pool branch, an observed concat, a 1x1 projection and dropout), and
  the head around it (48-channel ``auxlayer`` on c1, concat, 3x3
  ``project``, float 1x1 ``reduce_conv``). No registered segmentation model
  builds it; it is held against the JAX module on its own.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..models.frostnet import dropout
from ..nn import QCat, QConvBNAct, QHsigmoid, QMul, avg_pool, dequant, global_avg_pool
from ..nn.blocks import SIXTH
from ..nn.mode import FP32, QuantMode
from ..nn.quant_ops import mul_scalar
from ..ops import resize
from ..quant import QConfig, QNNPACK
from ..quant.qtensor import QParams, QTensor


def _size(x):
    return tuple((x.q if isinstance(x, QTensor) else x).shape[1:3])


class LRASPP(nn.Module):
    """Lite R-ASPP. Pool window and stride follow the dataset's crop: (37,
    12) for Cityscapes' 768 crops, (25, 8) otherwise."""

    def __init__(self, in_channels: int, pool_window: int = 37, pool_stride: int = 12,
                 out_channels: int = 128, quantized: bool = True, qconfig: QConfig = QNNPACK,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pool_window, self.pool_stride, self.quantized = pool_window, pool_stride, quantized
        kw = dict(quantized=quantized, qconfig=qconfig, dtype=dtype)
        self.b0 = QConvBNAct(in_channels, out_channels, 1, act="relu", **kw)
        self.b1_conv = QConvBNAct(in_channels, out_channels, 1, act=None, **kw)
        if quantized:
            self.b1_hsig = QHsigmoid(qconfig)
            self.quant_mul = QMul(qconfig)

    def prepare_int8(self, x: QParams, device) -> QParams:
        g1 = self.b0.prepare_int8(x, device)
        g2 = self.b1_hsig.prepare_int8(self.b1_conv.prepare_int8(x, device), device)
        return self.quant_mul.prepare_int8([g1, g2], device)

    def forward(self, x, mode: QuantMode = FP32, train: bool = False):
        size = _size(x)
        feat1 = self.b0(x, mode, train)
        win = min(self.pool_window, *size)
        feat2 = self.b1_conv(avg_pool(x, win, min(self.pool_stride, win)), mode, train)
        if self.quantized:
            feat2 = self.b1_hsig(feat2, mode)
        else:
            feat2 = mul_scalar(torch.clamp(feat2 + 3.0, 0.0, 6.0), SIXTH)
        feat2 = resize.resize_bilinear(dequant(feat2), size)
        if self.quantized:
            return self.quant_mul(feat1, feat2, mode)
        return feat1 * feat2


class LRASPPHead(nn.Module):
    """LR-ASPP on c4, resized to c1's size; returns ``(c1, c4)``."""

    def __init__(self, in_channels: int, pool_window: int = 37, pool_stride: int = 12,
                 quantized: bool = True, qconfig: QConfig = QNNPACK,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.lr_aspp = LRASPP(in_channels, pool_window, pool_stride, quantized=quantized,
                              qconfig=qconfig, dtype=dtype)

    def prepare_int8(self, c4: QParams, device) -> QParams:
        return self.lr_aspp.prepare_int8(c4, device)

    def forward(self, c1, c4, mode: QuantMode = FP32, train: bool = False):
        c4 = self.lr_aspp(c4, mode, train)
        return c1, resize.resize_bilinear(dequant(c4), _size(c1))


class ASPPPooling(nn.Module):
    """The global-pool branch of ASPP: pool, 1x1 ConvBNReLU, resize back
    (float out)."""

    def __init__(self, in_channels: int, out_channels: int = 256, quantized: bool = True,
                 qconfig: QConfig = QNNPACK, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = QConvBNAct(in_channels, out_channels, 1, act="relu", quantized=quantized,
                               qconfig=qconfig, dtype=dtype)

    def prepare_int8(self, x: QParams, device) -> None:
        self.conv.prepare_int8(x, device)  # the pool keeps the grid; float out

    def forward(self, x, mode: QuantMode = FP32, train: bool = False):
        p = self.conv(global_avg_pool(x, keepdims=True), mode, train)
        return resize.resize_bilinear(dequant(p), _size(x))


class RASPP(nn.Module):
    """R-ASPP: 1x1 and three atrous 3x3 branches, the pooled branch, an
    observed concat, a 1x1 projection, dropout on a float output."""

    def __init__(self, in_channels: int, atrous_rates=(6, 12, 18), out_channels: int = 256,
                 drop_rate: float = 0.1, quantized: bool = True, qconfig: QConfig = QNNPACK,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.drop_rate, self.quantized = drop_rate, quantized
        kw = dict(quantized=quantized, qconfig=qconfig, dtype=dtype)
        self.b0 = QConvBNAct(in_channels, out_channels, 1, act="relu", **kw)
        self.atrous = []
        for i, r in enumerate(atrous_rates):
            conv = QConvBNAct(in_channels, out_channels, 3, padding=r, dilation=r, act="relu",
                              **kw)
            self.add_module(f"b{i + 1}", conv)
            self.atrous.append(conv)
        self._pool_name = f"b{len(atrous_rates) + 1}"
        self.add_module(self._pool_name, ASPPPooling(in_channels, out_channels, **kw))
        if quantized:
            self.quant_cat = QCat(qconfig)
        self.project = QConvBNAct(out_channels * (len(atrous_rates) + 2), out_channels, 1,
                                  act="relu", **kw)

    @property
    def pooling(self) -> ASPPPooling:
        return getattr(self, self._pool_name)

    def prepare_int8(self, x: QParams, device) -> QParams:
        grids = [self.b0.prepare_int8(x, device)]
        grids += [conv.prepare_int8(x, device) for conv in self.atrous]
        self.pooling.prepare_int8(x, device)
        g = self.quant_cat.prepare_int8(grids + [None], device)
        return self.project.prepare_int8(g, device)

    def forward(self, x, mode: QuantMode = FP32, train: bool = False,
                generator: Optional[torch.Generator] = None):
        feats = [self.b0(x, mode, train)] + [conv(x, mode, train) for conv in self.atrous]
        feats.append(self.pooling(x, mode, train))
        if self.quantized:
            out = self.quant_cat(feats if mode.int8 else [dequant(f) for f in feats], mode)
        else:
            out = torch.cat(feats, dim=-1)
        out = self.project(out, mode, train)
        if not isinstance(out, QTensor) and train and self.drop_rate > 0:
            out = dropout(out, self.drop_rate, generator)
        return out


class RASPPHead(nn.Module):
    """R-ASPP on c4 resized to c1, a 48-channel ``auxlayer`` on c1, an
    observed concat, a 3x3 ``project`` and a float 1x1 ``reduce_conv``."""

    def __init__(self, c1_channels: int, c4_channels: int, num_classes: int = 19,
                 quantized: bool = True, qconfig: QConfig = QNNPACK,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.quantized = quantized
        kw = dict(quantized=quantized, qconfig=qconfig, dtype=dtype)
        self.aspp = RASPP(c4_channels, **kw)
        self.auxlayer = QConvBNAct(c1_channels, 48, 1, act="relu", **kw)
        if quantized:
            self.quant_cat = QCat(qconfig)
        self.project = QConvBNAct(48 + 256, 256, 3, padding=1, act="relu", **kw)
        self.reduce_conv = QConvBNAct(256, num_classes, 1, use_bn=False, use_bias=True,
                                      act=None, quantized=False)

    def prepare_int8(self, c1: QParams, c4: QParams, device) -> None:
        self.aspp.prepare_int8(c4, device)
        g = self.quant_cat.prepare_int8([self.auxlayer.prepare_int8(c1, device), None], device)
        self.project.prepare_int8(g, device)

    def forward(self, c1, c4, mode: QuantMode = FP32, train: bool = False,
                generator: Optional[torch.Generator] = None):
        c4 = resize.resize_bilinear(dequant(self.aspp(c4, mode, train, generator)), _size(c1))
        c1 = self.auxlayer(c1, mode, train)
        if self.quantized:
            out = self.quant_cat([c1 if mode.int8 else dequant(c1), c4], mode)
        else:
            out = torch.cat([c1, c4], dim=-1)
        return self.reduce_conv(dequant(self.project(out, mode, train)), mode, train)
