"""Quantizable ShuffleNetV2 (``frostnet_tpu/models/shufflenetv2.py``).

Module names are the JAX package's: ``quant``, ``conv1`` (3x3/2, ReLU), a
3x3/2 max pool over the zero point's padding (``-inf`` for floats), the
units ``stage{s}_{b}`` of three stages (the first of each strides by 2),
``conv5`` (1x1, ReLU), global pool and ``fc`` (a ``QDense``, float in every
phase). A unit of stride 1 splits its input's channels in half, passes the
first half and runs the second through ``b2_pw1`` (1x1, ReLU), ``b2_dw``
(depthwise 3x3) and ``b2_pw2`` (1x1, ReLU); a unit of stride 2 runs its
whole input through ``b1_dw`` (depthwise 3x3/2) and ``b1_pw`` beside that
second branch. The branches join in an observed ``cat`` and the channels
are shuffled (groups of 2): in INT8 an exact permutation of the codes.
The float models (``quantized=False``) concatenate in float.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..nn import (FP32, QCat, QConvBNAct, QDense, QuantMode, QuantStub, dequant,
                  global_avg_pool, max_pool)
from ..quant import QConfig, QNNPACK
from ..quant.qtensor import QParams, QTensor
from .mobilenetv2 import _Classifier, _refuse


def channel_shuffle(x, groups: int = 2):
    """(..., groups * n) -> the channels interleaved, group-minor; a QTensor's
    codes alike (its grid unchanged)."""
    if isinstance(x, QTensor):
        return QTensor(channel_shuffle(x.q, groups), x.scale, x.zero_point)
    c = x.shape[-1]
    y = x.reshape(*x.shape[:-1], groups, c // groups).transpose(-1, -2)
    return y.reshape(x.shape).contiguous()


def _split(x):
    """The two channel halves of ``x`` (a QTensor's on its grid)."""
    if isinstance(x, QTensor):
        c = x.q.shape[-1] // 2
        return QTensor(x.q[..., :c], x.scale, x.zero_point), QTensor(x.q[..., c:], x.scale,
                                                                    x.zero_point)
    c = x.shape[-1] // 2
    return x[..., :c], x[..., c:]


class ShuffleUnit(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, strides: int = 1,
                 quantized: bool = True, qconfig: QConfig = QNNPACK,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(quantized=quantized, qconfig=qconfig, dtype=dtype)
        self.strides, self.quantized = strides, quantized
        branch_c = out_channels // 2
        if strides != 1:
            self.b1_dw = QConvBNAct(in_channels, in_channels, 3, strides=2, padding=1,
                                    groups=in_channels, act=None, **kw)
            self.b1_pw = QConvBNAct(in_channels, branch_c, 1, act="relu", **kw)
            c2 = in_channels
        else:
            c2 = in_channels - in_channels // 2
        self.b2_pw1 = QConvBNAct(c2, branch_c, 1, act="relu", **kw)
        self.b2_dw = QConvBNAct(branch_c, branch_c, 3, strides=strides, padding=1,
                                groups=branch_c, act=None, **kw)
        self.b2_pw2 = QConvBNAct(branch_c, branch_c, 1, act="relu", **kw)
        if quantized:
            self.cat = QCat(qconfig)

    def prepare_int8(self, x: QParams, device) -> QParams:
        g1 = (self.b1_pw.prepare_int8(self.b1_dw.prepare_int8(x, device), device)
              if self.strides != 1 else x)
        g2 = x
        for conv in (self.b2_pw1, self.b2_dw, self.b2_pw2):
            g2 = conv.prepare_int8(g2, device)
        return self.cat.prepare_int8([g1, g2], device)

    def forward(self, x, mode: QuantMode = FP32, train: bool = False):
        if self.strides == 1:
            x1, x2 = _split(x)
        else:
            x1 = self.b1_pw(self.b1_dw(x, mode, train), mode, train)
            x2 = x
        x2 = self.b2_pw2(self.b2_dw(self.b2_pw1(x2, mode, train), mode, train), mode, train)
        out = self.cat([x1, x2], mode) if self.quantized else torch.cat([x1, x2], dim=-1)
        return channel_shuffle(out, 2)


class ShuffleNetV2(_Classifier):
    def __init__(self, stage_repeats: Sequence[int] = (4, 8, 4),
                 stage_channels: Sequence[int] = (24, 116, 232, 464, 1024),
                 num_classes: int = 1000, quantized: bool = True, qconfig: QConfig = QNNPACK,
                 fuse_int8: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        _refuse(fuse_int8)
        self.num_classes, self.quantized, self.drop_rate = num_classes, quantized, 0.0
        kw = dict(quantized=quantized, qconfig=qconfig, dtype=dtype)
        if quantized:
            self.quant = QuantStub(qconfig)
        self.conv1 = QConvBNAct(3, stage_channels[0], 3, strides=2, padding=1, act="relu", **kw)
        self.units, c = [], stage_channels[0]
        for si, repeats in enumerate(stage_repeats):
            out_c = stage_channels[si + 1]
            for bi in range(repeats):
                unit = ShuffleUnit(c, out_c, strides=2 if bi == 0 else 1, **kw)
                self.add_module(f"stage{si + 2}_{bi}", unit)
                self.units.append(unit)
                c = out_c
        self.conv5 = QConvBNAct(c, stage_channels[-1], 1, act="relu", **kw)
        self.fc = QDense(stage_channels[-1], num_classes, use_bias=True, quantized=quantized,
                         qconfig=qconfig)

    def prepare_int8(self, device, image_size: int = 224) -> None:
        if not self.quantized:
            return
        g = self.conv1.prepare_int8(self.quant.prepare_int8(device), device)
        self._pool_zp = g.zero_point
        for unit in self.units:
            g = unit.prepare_int8(g, device)
        self.conv5.prepare_int8(g, device)
        self.fc.prepare_int8(device)
        self._frozen = True

    def forward(self, x, mode: QuantMode = FP32, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """(B, S, S, 3) float images -> (B, num_classes) float logits (no
        dropout: ``generator`` is accepted for the trainer's call)."""
        self._check(mode)
        if self.quantized:
            x = self.quant(x, mode)
        x = self.conv1(x, mode, train)
        x = max_pool(x, 3, 2, padding=1, zero_point=getattr(self, "_pool_zp", None))
        for unit in self.units:
            x = unit(x, mode, train)
        x = global_avg_pool(self.conv5(x, mode, train), keepdims=False)
        return dequant(self.fc(x, mode))


SHUFFLENET_SETTINGS = {
    "shufflenet_v2_x0_5": ((4, 8, 4), (24, 48, 96, 192, 1024)),
    "shufflenet_v2_x1_0": ((4, 8, 4), (24, 116, 232, 464, 1024)),
    "shufflenet_v2_x1_5": ((4, 8, 4), (24, 176, 352, 704, 1024)),
    "shufflenet_v2_x2_0": ((4, 8, 4), (24, 244, 488, 976, 2048)),
}


def shufflenetv2_factories():
    """The JAX registry's ShuffleNetV2 names, quantized (``q`` prefix) and
    float (1000 classes by default)."""
    reg = {}
    for name, (reps, chans) in SHUFFLENET_SETTINGS.items():
        for quant in (True, False):
            def make(r=reps, c=chans, q=quant, **kwargs):
                kwargs.setdefault("num_classes", 1000)
                return ShuffleNetV2(stage_repeats=r, stage_channels=c, quantized=q, **kwargs)

            reg[f"{'q' if quant else ''}{name}"] = make
    return reg
