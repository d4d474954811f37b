"""Quantizable MobileNetV3, large and small, HS and RE (``frostnet_tpu/models/mobilenetv3.py``).

Module names are the JAX package's: ``quant``, ``conv1`` (+ ``conv1_hs``),
``layer{s}_{b}`` bottlenecks, ``layer5`` (+ ``layer5_hs``), on small a
``cls_se``, dropout on the last map (before the pool), global pool,
``cls_conv1``, ``cls_hs``, ``cls_conv2``. Widths are ``int(c * width_mult)``
without rounding, and the stem and last widths scale only above 1.0. The RE
variants use ReLU everywhere but the head's hard-swish. Phases, dropout and
what is not ported are as for ``mobilenetv2.MobileNetV2``.

The segmentation backbone is ``dilated=True, input_stub=False``: stage 4
runs at stride 1 with dilation 2, its last block halves ``exp`` and ``c``,
``layer5`` is 576 / 2 or 960 / 2 wide, and the model returns the five
stage outputs ``[layer1, layer2, layer3, layer4, layer5]`` (as
``features_only`` does on any MobileNetV3). The dilated model has no
``cls_*`` modules: the JAX model returns before it creates them.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..nn import FP32, QConvBNAct, QuantMode, QuantStub, dequant, global_avg_pool
from ..nn.blocks import BottleneckV3, QHswish, QSEModule, hswish_float
from ..quant import QConfig, QNNPACK
from ..quant.qtensor import QParams
from .mobilenetv2 import _Classifier, _refuse

# MobileNetV3 (kernel, exp_size, out_c, se, nl, stride) per block and stage
V3_SETTINGS = {
    "large": (
        [(3, 16, 16, False, "RE", 1), (3, 64, 24, False, "RE", 2), (3, 72, 24, False, "RE", 1)],
        [(5, 72, 40, True, "RE", 2), (5, 120, 40, True, "RE", 1), (5, 120, 40, True, "RE", 1)],
        [(3, 240, 80, False, "HS", 2), (3, 200, 80, False, "HS", 1),
         (3, 184, 80, False, "HS", 1), (3, 184, 80, False, "HS", 1),
         (3, 480, 112, True, "HS", 1), (3, 672, 112, True, "HS", 1)],
        [(5, 672, 160, True, "HS", 2), (5, 960, 160, True, "HS", 1),
         (5, 960, 160, True, "HS", 1)],
    ),
    "small": (
        [(3, 16, 16, True, "RE", 2)],
        [(3, 72, 24, False, "RE", 2), (3, 88, 24, False, "RE", 1)],
        [(5, 96, 40, True, "HS", 2), (5, 240, 40, True, "HS", 1),
         (5, 240, 40, True, "HS", 1), (5, 120, 48, True, "HS", 1),
         (5, 144, 48, True, "HS", 1)],
        [(5, 288, 96, True, "HS", 2), (5, 576, 96, True, "HS", 1),
         (5, 576, 96, True, "HS", 1)],
    ),
}


class MobileNetV3(_Classifier):
    def __init__(self, num_classes: int = 1000, mode: str = "large", width_mult: float = 1.0,
                 relu_only: bool = False, dilated: bool = False, drop_rate: float = 0.2,
                 quantized: bool = True, input_stub: bool = True, qconfig: QConfig = QNNPACK,
                 fuse_int8: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        _refuse(fuse_int8)
        self.num_classes, self.drop_rate, self.quantized = num_classes, drop_rate, quantized
        self.small, self.hs = mode == "small", not relu_only
        self.dilated, self.input_stub = dilated, input_stub
        kw = dict(quantized=quantized, qconfig=qconfig, dtype=dtype)

        def scale_big(c):  # the stem and last widths scale only above 1.0
            return int(c * width_mult) if width_mult > 1.0 else c

        def hswish(name):
            if quantized:
                self.add_module(name, QHswish(qconfig))

        if quantized and input_stub:
            self.quant = QuantStub(qconfig)
        c = scale_big(16)
        self.conv1 = QConvBNAct(3, c, 3, strides=2, padding=1,
                                act=None if self.hs else "relu", **kw)
        if self.hs:
            hswish("conv1_hs")
        self.stages = []
        for si, stage in enumerate(V3_SETTINGS[mode]):
            dilation = 2 if dilated and si == 3 else 1
            blocks = []
            for bi, (k, exp, ch, se, nl, s) in enumerate(stage):
                if dilated and si == 3 and bi == len(stage) - 1:
                    exp, ch = exp // 2, ch // 2
                out_c = int(ch * width_mult)
                blk = BottleneckV3(c, out_c, int(exp * width_mult), k, s if dilation == 1 else 1,
                                   dilation=dilation, se=se, nl="RE" if relu_only else nl, **kw)
                self.add_module(f"layer{si + 1}_{bi}", blk)
                blocks.append(blk)
                c = out_c
            self.stages.append(blocks)
        last_c = scale_big((576 if self.small else 960) // (2 if dilated else 1))
        self.layer5 = QConvBNAct(c, last_c, 1, act=None if self.hs else "relu", **kw)
        if self.hs:
            hswish("layer5_hs")
        if dilated:
            return
        if self.small:
            self.cls_se = QSEModule(last_c, quantized=quantized, qconfig=qconfig)
        mid = 1024 if self.small else 1280
        self.cls_conv1 = QConvBNAct(last_c, mid, 1, use_bn=False, use_bias=True, act=None, **kw)
        hswish("cls_hs")
        self.cls_conv2 = QConvBNAct(mid, num_classes, 1, use_bn=False, use_bias=True, act=None,
                                    **kw)

    def prepare_trunk(self, x: QParams, device) -> QParams:
        """Freeze the trunk (stem to ``layer5``) for inputs on grid ``x``;
        returns the grid of ``layer5``'s output."""
        g = self.conv1.prepare_int8(x, device)
        if self.hs:
            g = self.conv1_hs.prepare_int8(g, device)
        for blocks in self.stages:
            for blk in blocks:
                g = blk.prepare_int8(g, device)
        g = self.layer5.prepare_int8(g, device)
        if self.hs:
            g = self.layer5_hs.prepare_int8(g, device)
        self._frozen = True
        return g

    def prepare_int8(self, device, image_size: int = 224) -> None:
        """Freeze every module for INT8 inputs on ``device`` (a float model
        needs nothing)."""
        if not self.quantized:
            return
        g = self.prepare_trunk(self.quant.prepare_int8(device), device)
        if self.small:
            g = self.cls_se.prepare_int8(g, device)
        g = self.cls_hs.prepare_int8(self.cls_conv1.prepare_int8(g, device), device)
        self.cls_conv2.prepare_int8(g, device)

    def _hswish(self, name: str, x, mode: QuantMode):
        return getattr(self, name)(x, mode) if self.quantized else hswish_float(x)

    def forward(self, x, mode: QuantMode = FP32, train: bool = False,
                generator: Optional[torch.Generator] = None, features_only: bool = False):
        """(B, S, S, 3) float images (a QTensor in INT8 without the input
        stub) -> (B, num_classes) float logits; the five stage outputs with
        ``features_only`` or on the dilated trunk."""
        self._check(mode)
        if self.quantized and self.input_stub:
            x = self.quant(x, mode)
        x = self.conv1(x, mode, train)
        if self.hs:
            x = self._hswish("conv1_hs", x, mode)
        feats = []
        for blocks in self.stages:
            for blk in blocks:
                x = blk(x, mode, train)
            feats.append(x)
        x = self.layer5(x, mode, train)
        if self.hs:
            x = self._hswish("layer5_hs", x, mode)
        feats.append(x)
        if features_only or self.dilated:
            return feats
        if self.small:
            x = self.cls_se(x, mode)
        x = global_avg_pool(self._dropout(x, mode, train, generator), keepdims=True)
        x = self._hswish("cls_hs", self.cls_conv1(x, mode, train), mode)
        x = dequant(self.cls_conv2(x, mode, train))
        return x.reshape(x.shape[0], x.shape[-1])


def mobilenetv3_factories():
    """The JAX registry's MobileNetV3 names, with its factories' defaults."""
    reg = {}
    for m in ("large", "small"):
        for relu_only, suffix in ((False, "HS"), (True, "ReLU")):
            for quant in (True, False):
                def make(mode=m, ro=relu_only, q=quant, **kwargs):
                    kwargs.setdefault("num_classes", 1000)
                    return MobileNetV3(mode=mode, relu_only=ro, quantized=q, **kwargs)

                reg[f"{'q' if quant else ''}mobilenet_v3_{m}_{suffix}"] = make
    return reg
