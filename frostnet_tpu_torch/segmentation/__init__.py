"""Semantic segmentation of the port: models, heads, data, trainer, evaluator
(``frostnet_tpu/segmentation``)."""
from .data import (CITYSCAPES_CLASS_WEIGHTS, CITYSCAPES_CLASSES, CITYSCAPES_IGNORE,
                   CityscapesSegmentation, CustomSegmentation, PairedTransforms,
                   SyntheticSegmentation, VOCSegmentation)
from .heads import ASPPPooling, LRASPP, LRASPPHead, RASPP, RASPPHead
from .models import SEG_MODELS, MobileNetV2Seg, MobileNetV3Seg, get_seg_model

__all__ = [
    "LRASPP", "LRASPPHead", "RASPP", "RASPPHead", "ASPPPooling", "MobileNetV3Seg",
    "MobileNetV2Seg", "SEG_MODELS", "get_seg_model", "CITYSCAPES_CLASSES", "CITYSCAPES_IGNORE",
    "CITYSCAPES_CLASS_WEIGHTS", "CityscapesSegmentation", "CustomSegmentation",
    "VOCSegmentation", "SyntheticSegmentation", "PairedTransforms",
]
