"""Object detection of the port (``frostnet_tpu/detection``): priors, box
matching, the MultiBox loss, fixed-shape NMS, SSDLite-MobileNetV2 and
Tiny-DSOD, datasets, the trainer and the evaluator."""
from .anchors import CONFIGS, COCO_CFG, TDSOD_VOC_CFG, VOC_CFG, make_priors
from .boxes import (batched_match_priors, center_form, decode, encode, intersect, jaccard,
                    match_priors, point_form)
from .losses import multibox_loss
from .nms import detect, nms_fixed
from .models import SSDHead, SSDMobileNetV2Feat, build_ssd
from .tdsod import TDSODFeat, TDSODHead, build_tdsod
from .data import (COCODetection, SyntheticDetection, VOCDetection, VOC_CLASSES, pad_targets,
                   ssd_augment)
from .evaluate import evaluate_map, voc_ap

__all__ = [
    "CONFIGS", "VOC_CFG", "TDSOD_VOC_CFG", "COCO_CFG", "make_priors", "point_form",
    "center_form", "intersect", "jaccard", "encode", "decode", "match_priors",
    "batched_match_priors", "multibox_loss", "nms_fixed", "detect", "SSDMobileNetV2Feat",
    "SSDHead", "build_ssd", "TDSODFeat", "TDSODHead", "build_tdsod", "VOCDetection",
    "COCODetection", "SyntheticDetection", "VOC_CLASSES", "ssd_augment", "pad_targets",
    "evaluate_map", "voc_ap",
]
