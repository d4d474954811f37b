"""Quantizable ResNet family: ResNet-18/34/50/101/152 and ResNeXt-101 32x8d
(``frostnet_tpu/models/resnet.py``).

The architecture and module names are the JAX package's, so each variable of
a JAX checkpoint or INT8 artifact maps to one parameter or buffer here:
``quant``, ``stem`` (7x7/2 conv, BN, ReLU), a 3x3/2 max pool, the blocks
``layer{s}_{b}`` of four stages (64, 128, 256 and 512 wide; the first block
of stages 2-4 strides by 2), global pool, ``fc`` (a ``QDense``, float in
every phase). A ``BasicBlock`` is ``conv1`` (3x3, ReLU) and ``conv2`` (3x3),
a ``Bottleneck`` ``conv1`` (1x1, ReLU), ``conv2`` (3x3 grouped, strided,
ReLU) and ``conv3`` (1x1, four times wider); each has a 1x1 ``downsample``
where the stride or the width changes, and joins with an observed
``add_relu`` (BasicBlock) or ``skip_add_relu`` (Bottleneck). The float
models (``quantized=False``) add and ReLU in float.

``forward(x, mode, train, generator)`` runs one phase (FP32, QAT,
QAT_FROZEN, or the frozen INT8 graph that ``prepare_int8`` builds). In INT8
the convs take the routes of ``nn/conv.py``: the non-strided 3x3s the dense
conv kernel, the stem and the strided 3x3s the im2col matmul, the 1x1s and
the strided 1x1 ``downsample`` the matmul kernel, ResNeXt's grouped 3x3s
torch ops. The model has no dropout; ``generator`` is accepted for the
trainer's call and unused.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..nn import (FP32, QAddReLU, QConvBNAct, QDense, QuantMode, QuantStub, dequant,
                  global_avg_pool, max_pool)
from ..quant import QConfig, QNNPACK
from ..quant.qtensor import QParams


def _prepare_join(block, add: QAddReLU, out: QParams, x: QParams, device,
                  input_loaded: bool) -> QParams:
    """Freeze a block's ``downsample`` and join. ``input_loaded``: the block's
    input codes are read from memory by the join's fusion in the frozen JAX
    graph (the max pool's output), which then contracts the identity's
    product (``ops.requant.qadd_codes``); a downsample's codes are made in
    that fusion."""
    if hasattr(block, "downsample"):
        return add.prepare_int8([out, block.downsample.prepare_int8(x, device)], device)
    return add.prepare_int8([out, x], device, loaded=(False, input_loaded))


def _join(x, identity, mode: QuantMode, add: Optional[QAddReLU]):
    if add is not None:
        return add(x, identity, mode)
    return torch.relu(x + dequant(identity))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_channels: int, features: int, strides: int = 1, groups: int = 1,
                 base_width: int = 64, quantized: bool = True, qconfig: QConfig = QNNPACK,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(quantized=quantized, qconfig=qconfig, dtype=dtype)
        self.conv1 = QConvBNAct(in_channels, features, 3, strides=strides, padding=1,
                                act="relu", **kw)
        self.conv2 = QConvBNAct(features, features, 3, padding=1, act=None, **kw)
        if strides != 1 or in_channels != features:
            self.downsample = QConvBNAct(in_channels, features, 1, strides=strides, act=None,
                                         **kw)
        self.add_relu = QAddReLU(qconfig) if quantized else None

    def prepare_int8(self, x: QParams, device, input_loaded: bool = False) -> QParams:
        g = self.conv2.prepare_int8(self.conv1.prepare_int8(x, device), device)
        return _prepare_join(self, self.add_relu, g, x, device, input_loaded)

    def forward(self, x, mode: QuantMode = FP32, train: bool = False):
        out = self.conv2(self.conv1(x, mode, train), mode, train)
        identity = self.downsample(x, mode, train) if hasattr(self, "downsample") else x
        return _join(out, identity, mode, self.add_relu)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_channels: int, features: int, strides: int = 1, groups: int = 1,
                 base_width: int = 64, quantized: bool = True, qconfig: QConfig = QNNPACK,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(quantized=quantized, qconfig=qconfig, dtype=dtype)
        width = int(features * (base_width / 64.0)) * groups
        out_c = features * 4
        self.conv1 = QConvBNAct(in_channels, width, 1, act="relu", **kw)
        self.conv2 = QConvBNAct(width, width, 3, strides=strides, padding=1, groups=groups,
                                act="relu", **kw)
        self.conv3 = QConvBNAct(width, out_c, 1, act=None, **kw)
        if strides != 1 or in_channels != out_c:
            self.downsample = QConvBNAct(in_channels, out_c, 1, strides=strides, act=None, **kw)
        self.skip_add_relu = QAddReLU(qconfig) if quantized else None

    def prepare_int8(self, x: QParams, device, input_loaded: bool = False) -> QParams:
        g = self.conv1.prepare_int8(x, device)
        g = self.conv3.prepare_int8(self.conv2.prepare_int8(g, device), device)
        return _prepare_join(self, self.skip_add_relu, g, x, device, input_loaded)

    def forward(self, x, mode: QuantMode = FP32, train: bool = False):
        out = self.conv3(self.conv2(self.conv1(x, mode, train), mode, train), mode, train)
        identity = self.downsample(x, mode, train) if hasattr(self, "downsample") else x
        return _join(out, identity, mode, self.skip_add_relu)


class ResNet(nn.Module):
    def __init__(self, block=BasicBlock, layers: Sequence[int] = (2, 2, 2, 2),
                 num_classes: int = 1000, groups: int = 1, width_per_group: int = 64,
                 quantized: bool = True, qconfig: QConfig = QNNPACK,
                 fuse_int8: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        if fuse_int8:
            raise ValueError("fuse_int8 is FrostNet-only: a ResNet has no fused INT8 block")
        self.num_classes, self.quantized = num_classes, quantized
        kw = dict(quantized=quantized, qconfig=qconfig, dtype=dtype)
        if quantized:
            self.quant = QuantStub(qconfig)
        self.stem = QConvBNAct(3, 64, 7, strides=2, padding=3, act="relu", **kw)
        self.blocks = []
        c = 64
        for si, (feats, n) in enumerate(zip((64, 128, 256, 512), layers)):
            for bi in range(n):
                blk = block(c, feats, strides=2 if bi == 0 and si > 0 else 1, groups=groups,
                            base_width=width_per_group, **kw)
                self.add_module(f"layer{si + 1}_{bi}", blk)
                self.blocks.append(blk)
                c = feats * block.expansion
        self.fc = QDense(c, num_classes, use_bias=True, quantized=quantized, qconfig=qconfig)

    def prepare_int8(self, device, image_size: int = 224) -> None:
        """Freeze every module for INT8 inputs on ``device`` (a float model
        needs nothing)."""
        if not self.quantized:
            return
        g = self.stem.prepare_int8(self.quant.prepare_int8(device), device)
        self._pool_zp = g.zero_point
        for i, blk in enumerate(self.blocks):
            g = blk.prepare_int8(g, device, input_loaded=i == 0)
        self.fc.prepare_int8(device)

    def forward(self, x: torch.Tensor, mode: QuantMode = FP32, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, S, S, 3) float images -> (B, num_classes) float logits."""
        if mode.int8 and self.quantized and not hasattr(self.quant, "_out"):
            raise RuntimeError("INT8 runs frozen only: call quant.freeze(model) first")
        if self.quantized:
            x = self.quant(x, mode)
        x = self.stem(x, mode, train)
        x = max_pool(x, 3, 2, padding=1, zero_point=getattr(self, "_pool_zp", None))
        for blk in self.blocks:
            x = blk(x, mode, train)
        return dequant(self.fc(global_avg_pool(x, keepdims=False), mode))


RESNET_SETTINGS = {
    "resnet18": (BasicBlock, (2, 2, 2, 2), {}),
    "resnet34": (BasicBlock, (3, 4, 6, 3), {}),
    "resnet50": (Bottleneck, (3, 4, 6, 3), {}),
    "resnet101": (Bottleneck, (3, 4, 23, 3), {}),
    "resnet152": (Bottleneck, (3, 8, 36, 3), {}),
    "resnext101_32x8d": (Bottleneck, (3, 4, 23, 3), {"groups": 32, "width_per_group": 8}),
}


def resnet_factories():
    """The JAX registry's ResNet names, quantized (``q`` prefix) and float,
    with its factories' defaults (1000 classes)."""
    reg = {}
    for name, (blk, layers, extra) in RESNET_SETTINGS.items():
        for quant in (True, False):
            def make(b=blk, l=layers, e=extra, q=quant, **kwargs):
                kwargs.setdefault("num_classes", 1000)
                return ResNet(block=b, layers=l, quantized=q, **e, **kwargs)

            reg[f"{'q' if quant else ''}{name}"] = make
    return reg
