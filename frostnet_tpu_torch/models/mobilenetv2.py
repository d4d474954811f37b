"""Quantizable MobileNetV2 (``frostnet_tpu/models/mobilenetv2.py``).

The architecture and module names are the JAX package's, so each variable of
a JAX checkpoint or INT8 artifact maps to one parameter or buffer here:
``quant``, ``conv_stem`` (3x3/2), ``block{i}`` inverted residuals over the
public (t, c, n, s) table, ``conv_head`` (1280 wide), global pool, dropout,
``classifier`` (a ``QDense``). The quantized models use ReLU where
torchvision's use ReLU6 (the reference's ``_replace_relu``); the ``_ReLU6``
names keep ReLU6 on the stem and the head.

``forward(x, mode, train, generator)`` runs one phase (FP32, QAT,
QAT_FROZEN, or the frozen INT8 graph that ``prepare_int8`` builds); the
float models (``quantized=False``) run in float in every phase. Dropout
draws from ``generator`` in train mode. The fused INT8 block is FrostNet's.

The segmentation backbone is the same module with ``dilated=True`` (output
stride 16: from the block whose stride would pass 16 on, stride 1 and the
dilation multiplied by it), ``input_stub=False`` (the wrapper quantizes)
and ``forward(..., features_only=True)``, which returns the dequantized
c1 (/4), c2 (/8), c3 (/16) and c4 (/16 dilated) as the JAX model does.
``conv_head`` exists and runs there too (its observer and BN statistics
step in QAT), though its output is unused: the JAX model creates and runs
it before it returns the features. The dilated model has no
``classifier``: the JAX model returns before it creates it.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn import FP32, QConvBNAct, QuantMode, QuantStub, dequant, global_avg_pool
from ..nn.blocks import InvertedResidual, QDense
from ..quant import QConfig, QNNPACK
from ..quant.qtensor import QTensor
from .frostnet import dropout, make_divisible

# (expand_ratio, channels, repeats, stride)
V2_SETTINGS = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2), (6, 96, 3, 1),
               (6, 160, 3, 2), (6, 320, 1, 1)]


def _refuse(fuse_int8: bool) -> None:
    if fuse_int8:
        raise ValueError("fuse_int8 is FrostNet-only: a MobileNet has no fused INT8 block")


class _Classifier(nn.Module):
    """What the two MobileNets share: the INT8 guard and dropout."""

    _frozen = False

    def _check(self, mode: QuantMode) -> None:
        if mode.int8 and self.quantized and not self._frozen:
            raise RuntimeError("INT8 runs frozen only: call quant.freeze(model) first")

    def _dropout(self, x, mode: QuantMode, train: bool, generator):
        if train and self.drop_rate > 0 and not isinstance(x, QTensor):
            return dropout(x, self.drop_rate, generator)
        return x


class MobileNetV2(_Classifier):
    def __init__(self, num_classes: int = 1000, width_mult: float = 1.0,
                 dilated: bool = False, drop_rate: float = 0.2, relu6: bool = False,
                 quantized: bool = True, input_stub: bool = True, qconfig: QConfig = QNNPACK,
                 fuse_int8: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        _refuse(fuse_int8)
        self.num_classes, self.drop_rate, self.quantized = num_classes, drop_rate, quantized
        self.dilated, self.input_stub = dilated, input_stub
        act = "relu6" if relu6 else "relu"
        kw = dict(quantized=quantized, qconfig=qconfig, dtype=dtype)
        if quantized and input_stub:
            self.quant = QuantStub(qconfig)
        c = make_divisible(32 * width_mult)
        self.conv_stem = QConvBNAct(3, c, 3, strides=2, padding=1, act=act, **kw)
        self.blocks, self.stage_ends = [], []
        cur_stride, dilation = 2, 1
        for t, ch, n, s in V2_SETTINGS:
            out_c = make_divisible(ch * width_mult)
            for i in range(n):
                stride = s if i == 0 else 1
                if dilated and cur_stride * stride > 16:
                    dilation, stride = dilation * stride, 1
                cur_stride *= stride
                blk = InvertedResidual(c, out_c, strides=stride, expand_ratio=t,
                                       dilation=dilation, **kw)
                self.add_module(f"block{len(self.blocks)}", blk)
                self.blocks.append(blk)
                c = out_c
            self.stage_ends.append(len(self.blocks))
        last_c = make_divisible(1280 * width_mult) if width_mult > 1.0 else 1280
        self.conv_head = QConvBNAct(c, last_c, 1, act=act, **kw)
        if dilated:  # the segmentation backbone: JAX never makes the classifier
            return
        self.classifier = QDense(last_c, num_classes, use_bias=True, quantized=quantized,
                                 qconfig=qconfig)

    def prepare_int8(self, device, image_size: int = 224) -> None:
        """Freeze every module for INT8 inputs on ``device`` (a float model
        needs nothing)."""
        if not self.quantized:
            return
        g = self.conv_stem.prepare_int8(self.quant.prepare_int8(device), device)
        for blk in self.blocks:
            g = blk.prepare_int8(g, device)
        self.conv_head.prepare_int8(g, device)
        if not self.dilated:
            self.classifier.prepare_int8(device)
        self._frozen = True

    def forward(self, x, mode: QuantMode = FP32, train: bool = False,
                generator: Optional[torch.Generator] = None, features_only: bool = False):
        """(B, S, S, 3) float images -> (B, num_classes) float logits; with
        ``features_only`` the dequantized [c1, c2, c3, c4]."""
        self._check(mode)
        if self.quantized and self.input_stub:
            x = self.quant(x, mode)
        x = self.conv_stem(x, mode, train)
        feats = []
        for i, blk in enumerate(self.blocks):
            x = blk(x, mode, train)
            if i + 1 in self.stage_ends:
                feats.append(x)
        head = self.conv_head(x, mode, train)
        if features_only:
            return [dequant(f) for f in (feats[1], feats[2], feats[4], feats[6])]
        x = global_avg_pool(head, keepdims=False)
        x = self._dropout(x, mode, train, generator)
        return dequant(self.classifier(x, mode))


def mobilenetv2_factories():
    """The JAX registry's MobileNetV2 names, with its factories' defaults."""
    reg = {}
    for quant in (True, False):
        for relu6, suffix in ((False, "ReLU"), (True, "ReLU6")):
            def make(q=quant, r6=relu6, **kwargs):
                kwargs.setdefault("num_classes", 1000)
                return MobileNetV2(quantized=q, relu6=r6, **kwargs)

            reg[f"{'q' if quant else ''}mobilenet_v2_{suffix}"] = make
    reg["mobilenet_v2"] = lambda **kw: MobileNetV2(quantized=False, **kw)
    reg["qmobilenet_v2"] = lambda **kw: MobileNetV2(quantized=True, **kw)
    return reg
