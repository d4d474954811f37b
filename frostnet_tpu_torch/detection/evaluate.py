"""Detection evaluation: VOC mAP with 11-point interpolation
(``frostnet_tpu/detection/evaluate.py``).

:func:`evaluate_map` runs the feature net in the phase asked for (QAT_FROZEN,
or the frozen INT8 graph), the float head, the softmax and ``detect`` on the
device, one batch at a time, and copies each batch's (B, C, K, 5) detections
to the host. There :func:`match_detections` (voc_eval's greedy TP/FP marking,
strict ``> iou_thresh``) and :func:`aps_from_records` (per-class 11-point AP)
are the JAX package's host numpy, line for line: equal detections give a
bit-equal mAP.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..data import prefetch_to_device
from ..nn.mode import QuantMode
from .nms import detect


def voc_ap(rec: np.ndarray, prec: np.ndarray, use_07_metric: bool = True) -> float:
    """11-point interpolated AP (qeval_convert.py voc_ap)."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.any(rec >= t) else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate([[0.0], rec, [1.0]])
    mpre = np.concatenate([[0.0], prec, [0.0]])
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def _iou(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    ix1 = np.maximum(box[0], boxes[:, 0])
    iy1 = np.maximum(box[1], boxes[:, 1])
    ix2 = np.minimum(box[2], boxes[:, 2])
    iy2 = np.minimum(box[3], boxes[:, 3])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    a1 = (box[2] - box[0]) * (box[3] - box[1])
    a2 = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return inter / np.maximum(a1 + a2 - inter, 1e-12)


def evaluate_map(feat, head, dataset, priors, mode: QuantMode, num_classes: int,
                 device="cuda", iou_thresh: float = 0.5, conf_thresh: float = 0.01,
                 max_batches: Optional[int] = None) -> Dict:
    """{'mAP': float, 'ap_per_class': (C,) float32} of ``feat`` (in ``mode``)
    and ``head`` over ``dataset``. In INT8 the feature net is frozen from its
    current state first (``prepare_int8`` on ``device``)."""
    device = torch.device(device)
    priors_t = torch.as_tensor(np.asarray(priors, np.float32), device=device)
    feat.eval()
    head.eval()
    if mode.int8:
        feat.prepare_int8(device)
    dets: List[List] = [[] for _ in range(num_classes)]
    npos = np.zeros(num_classes, np.int64)
    with torch.no_grad():
        for bi, batch in enumerate(prefetch_to_device(iter(dataset), device)):
            if max_batches is not None and bi >= max_batches:
                break
            loc, conf = head(feat(batch["image"], mode=mode))
            out = detect(loc, torch.softmax(conf, dim=-1), priors_t,
                         conf_thresh=conf_thresh).cpu().numpy()
            boxes, labels = batch["boxes"].cpu().numpy(), batch["labels"].cpu().numpy()
            valid = batch["valid"].cpu().numpy()
            for b in range(out.shape[0]):
                match_detections(dets, npos, out[b], boxes[b][valid[b]], labels[b][valid[b]],
                                 num_classes, iou_thresh)
    aps = aps_from_records(dets, npos, num_classes)
    present = npos > 0
    mean_ap = float(np.sum(aps[present]) / max(np.sum(present), 1))
    return {"mAP": mean_ap, "ap_per_class": aps}


def match_detections(dets: List[List], npos: np.ndarray, out_img: np.ndarray,
                     gt_boxes: np.ndarray, gt_labels: np.ndarray,
                     num_classes: int, iou_thresh: float = 0.5) -> None:
    """Greedy TP/FP assignment for one image (voc_eval's marking loop,
    qeval_convert.py:296-331). ``out_img`` is the (C, K, 5) detect() output
    with rows [score, x1, y1, x2, y2], score-sorted per class (the reference
    sorts globally by confidence, but GT 'det' flags are per image, so
    per-image score order is equivalent). Strict ``> iou_thresh`` like the
    reference's ``ovmax > ovthresh``."""
    for c in range(1, num_classes):
        cls_gt = gt_boxes[gt_labels == c - 1]
        npos[c] += len(cls_gt)
        matched = np.zeros(len(cls_gt), bool)
        rows = out_img[c]
        rows = rows[rows[:, 0] > 0]
        for score, x1, y1, x2, y2 in rows:
            tp = False
            if len(cls_gt):
                ious = _iou(np.array([x1, y1, x2, y2]), cls_gt)
                j = int(np.argmax(ious))
                if ious[j] > iou_thresh and not matched[j]:
                    matched[j] = True
                    tp = True
            dets[c].append((float(score), tp))


def aps_from_records(dets: List[List], npos: np.ndarray,
                     num_classes: int) -> np.ndarray:
    """Per-class 11-point AP from (score, is_tp) records
    (qeval_convert.py:333-345)."""
    aps = np.zeros(num_classes, np.float32)
    for c in range(1, num_classes):
        if npos[c] == 0:
            continue
        rows = sorted(dets[c], key=lambda r: -r[0])
        tp = np.cumsum([r[1] for r in rows]).astype(np.float64)
        fp = np.cumsum([not r[1] for r in rows]).astype(np.float64)
        rec = tp / npos[c]
        prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
        aps[c] = voc_ap(rec, prec)
    return aps
