"""SSD priors and the detection configs (``frostnet_tpu/detection/anchors.py:13-71``).

Host numpy, computed once per config, bit-equal to the JAX package's: the
same Python floats in the same order, cast to float32 once and clipped.
The configs mirror the reference's ``data/config.py`` (voc, TDSOD_voc, coco,
TDSOD_coco); ``TDSOD_COCO_CFG`` takes the TDSOD net's true last source (2x2),
as the JAX package does.
"""
from __future__ import annotations

import math
from itertools import product

import numpy as np

VOC_CFG = {
    "num_classes": 21,
    "lr_steps": (80000, 100000, 120000),
    "max_iter": 120000,
    "feature_maps": [38, 19, 10, 5, 3, 1],
    "min_dim": 300,
    "steps": [8, 16, 32, 64, 100, 300],
    "min_sizes": [30, 60, 111, 162, 213, 264],
    "max_sizes": [60, 111, 162, 213, 264, 315],
    "aspect_ratios": [[2], [2, 3], [2, 3], [2, 3], [2], [2]],
    "variance": [0.1, 0.2],
    "clip": True,
    "name": "VOC",
}

TDSOD_VOC_CFG = {**VOC_CFG,
                 "lr_steps": (120000, 150000, 180000),
                 "max_iter": 180000,
                 "feature_maps": [38, 19, 10, 5, 3, 2]}

COCO_CFG = {**VOC_CFG,
            "num_classes": 201,
            "lr_steps": (280000, 360000, 400000),
            "max_iter": 400000,
            "min_sizes": [21, 45, 99, 153, 207, 261],
            "max_sizes": [45, 99, 153, 207, 261, 315],
            "name": "COCO"}

TDSOD_COCO_CFG = {**COCO_CFG, "feature_maps": [38, 19, 10, 5, 3, 2]}

CONFIGS = {"voc": VOC_CFG, "tdsod_voc": TDSOD_VOC_CFG, "coco": COCO_CFG,
           "tdsod_coco": TDSOD_COCO_CFG}


def make_priors(cfg: dict) -> np.ndarray:
    """(P, 4) center-form priors (cx, cy, w, h) in [0, 1]; 8,732 for VOC_CFG."""
    image_size = cfg["min_dim"]
    mean = []
    for k, f in enumerate(cfg["feature_maps"]):
        for i, j in product(range(f), repeat=2):
            f_k = image_size / cfg["steps"][k]
            cx = (j + 0.5) / f_k
            cy = (i + 0.5) / f_k
            s_k = cfg["min_sizes"][k] / image_size
            mean += [cx, cy, s_k, s_k]
            s_k_prime = math.sqrt(s_k * (cfg["max_sizes"][k] / image_size))
            mean += [cx, cy, s_k_prime, s_k_prime]
            for ar in cfg["aspect_ratios"][k]:
                mean += [cx, cy, s_k * math.sqrt(ar), s_k / math.sqrt(ar)]
                mean += [cx, cy, s_k / math.sqrt(ar), s_k * math.sqrt(ar)]
    out = np.asarray(mean, np.float32).reshape(-1, 4)
    if cfg.get("clip", True):
        out = np.clip(out, 0.0, 1.0)
    return out
