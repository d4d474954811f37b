"""Segmentation models (``frostnet_tpu/segmentation/models.py``).

The quantized region is ``quant`` (QuantStub) -> dilated ``backbone`` ->
LR-ASPP ``head`` -> two dequants; the float tail projects both streams to
``num_classes`` (``project`` on c4, ``auxlayer`` on c1: 1x1 convs with a
bias, ``quantized=False``, float32 in every phase), adds them, and resizes
the sum to the input size (bilinear, align_corners). Module and variable
names are the JAX package's, so ``from_jax_variables``, ``export_int8`` and
``load_int8`` work over the trees (``backbone/...``, ``head/lr_aspp/...``,
``project``, ``auxlayer``, ``quant``).

``forward(x, mode, train)`` takes (B, H, W, 3) float images and returns
(B, H, W, num_classes) float logits; INT8 runs frozen (``prepare_int8``).
``mobilenetv2`` is ported in FP32, QAT and QAT_FROZEN; its INT8 freeze
raises, as the JAX model's INT8 forward does (``MobileNetV2(features_only=
True)`` returns dequantized features, so the head's first conv meets a
float where INT8 needs a QTensor; ROADMAP.md, Queue C). ``espnetv2`` and
``espnet`` are ``segmentation/espnet.py``'s (``s``, the ``--width_scale``
of the CLIs, scales ESPNetv2).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..models.mobilenetv2 import MobileNetV2
from ..models.mobilenetv3 import MobileNetV3
from ..nn import FP32, QConvBNAct, QuantMode, QuantStub, dequant
from ..ops import resize
from ..quant import QConfig, QNNPACK
from .heads import LRASPPHead

V2_INT8 = ("mobilenetv2 has no INT8 forward: MobileNetV2(features_only=True) returns "
           "dequantized features, so the LR-ASPP head's first conv meets a float where INT8 "
           "needs a QTensor; the JAX model raises the same way (AssertionError 'INT8 mode "
           "needs a QTensor input'; ROADMAP.md, Queue C)")


def _pool_geometry(dataset: str):
    return (37, 12) if dataset == "city" else (25, 8)


class _SegModel(nn.Module):
    """The quant region's entry and the float tail, shared by both trunks."""

    def _build_tail(self, c1_channels: int, num_classes: int):
        self.project = QConvBNAct(128, num_classes, 1, use_bn=False, use_bias=True, act=None,
                                  quantized=False)
        self.auxlayer = QConvBNAct(c1_channels, num_classes, 1, use_bn=False, use_bias=True,
                                   act=None, quantized=False)

    def _tail(self, c1, c4, size, mode: QuantMode, train: bool):
        c4 = self.project(dequant(c4), mode, train)
        c1 = self.auxlayer(dequant(c1), mode, train)
        return resize.resize_bilinear(c1 + c4, size)


class MobileNetV3Seg(_SegModel):
    """MobileNetV3 (dilated, output stride 16) + LR-ASPP; c1 is stage 2's
    output (/8), c4 ``layer5``'s (/16)."""

    def __init__(self, num_classes: int = 19, mode: str = "large", relu_only: bool = False,
                 dataset: str = "city", quantized: bool = True, qconfig: QConfig = QNNPACK,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes, self.quantized = num_classes, quantized
        kw = dict(quantized=quantized, qconfig=qconfig, dtype=dtype)
        if quantized:
            self.quant = QuantStub(qconfig)
        self.backbone = MobileNetV3(mode=mode, relu_only=relu_only, dilated=True,
                                    input_stub=False, **kw)
        c1 = self.backbone.stages[1][-1].project.features
        c4 = self.backbone.layer5.features
        self.head = LRASPPHead(c4, *_pool_geometry(dataset), **kw)
        self._build_tail(c1, num_classes)

    def prepare_int8(self, device, image_size: Optional[int] = None) -> None:
        """Freeze the quant region for INT8 on ``device`` (the float tail
        needs nothing)."""
        if not self.quantized:
            return
        g = self.backbone.prepare_trunk(self.quant.prepare_int8(device), device)
        self.head.prepare_int8(g, device)

    def forward(self, x: torch.Tensor, mode: QuantMode = FP32, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        size = tuple(x.shape[1:3])
        if self.quantized:
            x = self.quant(x, mode)
        feats = self.backbone(x, mode, train)
        c1, c4 = self.head(feats[1], feats[4], mode, train)
        return self._tail(c1, c4, size, mode, train)


class MobileNetV2Seg(_SegModel):
    """MobileNetV2 (dilated, output stride 16) + LR-ASPP; c1 is the
    24-channel /4 stage, c4 the 320-channel /16 one."""

    def __init__(self, num_classes: int = 19, dataset: str = "city", quantized: bool = True,
                 qconfig: QConfig = QNNPACK, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes, self.quantized = num_classes, quantized
        kw = dict(quantized=quantized, qconfig=qconfig, dtype=dtype)
        if quantized:
            self.quant = QuantStub(qconfig)
        self.backbone = MobileNetV2(dilated=True, input_stub=False, **kw)
        blocks = self.backbone.blocks
        c1 = blocks[self.backbone.stage_ends[1] - 1].project.features
        c4 = blocks[-1].project.features
        self.head = LRASPPHead(c4, *_pool_geometry(dataset), **kw)
        self._build_tail(c1, num_classes)

    def prepare_int8(self, device, image_size: Optional[int] = None) -> None:
        raise NotImplementedError(V2_INT8)

    def forward(self, x: torch.Tensor, mode: QuantMode = FP32, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if mode.int8 and self.quantized:
            raise NotImplementedError(V2_INT8)
        size = tuple(x.shape[1:3])
        if self.quantized:
            x = self.quant(x, mode)
        feats = self.backbone(x, mode, train, features_only=True)
        c1, c4 = self.head(feats[0], feats[3], mode, train)
        return self._tail(c1, c4, size, mode, train)


def _v3(mode: str, relu_only: bool):
    def make(**kwargs):
        kwargs.setdefault("num_classes", 19)
        return MobileNetV3Seg(mode=mode, relu_only=relu_only, **kwargs)
    return make


def _espnet(cls_name: str):
    """ESPNetv2 or ESPNet (``segmentation/espnet.py``): 20 classes by default;
    ``dataset`` (the LR-ASPP pool geometry, which these heads do not have)
    is dropped, as the JAX registry drops it."""
    def make(**kwargs):
        from . import espnet

        kwargs.setdefault("num_classes", 20)
        kwargs.pop("dataset", None)
        return getattr(espnet, cls_name)(**kwargs)
    return make


SEG_MODELS = {f"mobilenetv3{suffix}_{m}": _v3(m, re)
              for m in ("large", "small") for re, suffix in ((False, ""), (True, "_RE"))}
SEG_MODELS["mobilenetv2"] = lambda **kw: MobileNetV2Seg(**{"num_classes": 19, **kw})
SEG_MODELS["espnetv2"] = _espnet("ESPNetv2Seg")
SEG_MODELS["espnet"] = _espnet("ESPNetSeg")


def get_seg_model(name: str, **kwargs):
    """The JAX registry's names (Semantic_Segmentation/train.py's model
    choices)."""
    try:
        factory = SEG_MODELS[name]
    except KeyError:
        raise ValueError(f"unknown seg model {name!r}; options: {sorted(SEG_MODELS)}") from None
    return factory(**kwargs)
