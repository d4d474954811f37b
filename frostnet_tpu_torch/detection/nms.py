"""Fixed-shape NMS and test-time detection (``frostnet_tpu/detection/nms.py:18-80``).

The JAX package's masked O(K^2) greedy suppression over each class's top-K
boxes, written by hand in torch ops (no library NMS), batched over every
(image, class) pair at once on the device:

* the top-K: a stable descending sort of the scores, the first ``top_k``
  taken, so that among equal scores the lower index comes first, as
  ``jax.lax.top_k`` orders them (``torch.topk`` does not promise an order
  among ties);
* the pairwise IoU of the K candidates (one tensor op chain);
* the greedy pass, sequential in the candidate index as the JAX
  ``fori_loop`` is: ``top_k`` steps, each one masked update of the whole
  (B, C-1, K) keep mask on the device. NMS is XLA code in the JAX package,
  not a Pallas kernel, so torch ops are its port. A ``detect`` call's
  kernels grow with ``top_k`` (three a greedy step) and not with the
  batch: ``nms_fixed`` ran 636 kernels at ``top_k`` 200 on an H100, at
  batch 32 and at 256 alike (the detection cell's ``nms_launches.serve``,
  read from the device trace). On the card the greedy pass is one CUDA
  graph per shape (``utils/cuda_graphs.py::Replay``): the host issues one
  launch for its 600 kernels, which it took some 8 ms to issue one by one.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..utils.cuda_graphs import Replay
from ..utils.profiling import span
from .boxes import decode


def _pairwise_iou(b: torch.Tensor) -> torch.Tensor:
    """(..., K, 4) point-form -> (..., K, K) IoU, the JAX expression's order."""
    x1, y1, x2, y2 = b.unbind(-1)
    area = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    ix1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    iy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    ix2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    iy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    inter = torch.clamp(ix2 - ix1, min=0) * torch.clamp(iy2 - iy1, min=0)
    return inter / torch.clamp(area[..., :, None] + area[..., None, :] - inter, min=1e-12)


def top_k_stable(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the ``k`` largest along the last dim, ties by
    lower index first (``jax.lax.top_k``'s order)."""
    v, i = torch.sort(scores, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _greedy(cand: torch.Tensor) -> torch.Tensor:
    """The keep mask of the greedy pass over (..., K, K) ``cand`` (row i:
    the later candidates that i suppresses), one masked step a candidate."""
    keep = torch.ones(cand.shape[:-1], dtype=torch.bool, device=cand.device)
    for i in range(cand.shape[-1]):
        # suppress j > i overlapping i, if i is still kept
        keep = keep & ~(cand[..., i, :] & keep[..., i:i + 1])
    return keep


_GREEDY = Replay(_greedy)


def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.45,
              top_k: int = 200) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy NMS over the ``top_k`` highest scores.

    ``boxes`` (..., N, 4) point-form and ``scores`` (..., N), any leading
    dims (each row its own problem). Returns (boxes (..., K, 4), scores
    (..., K), keep (..., K) bool) in score order; suppressed entries and
    zero scores have keep False.
    """
    k = min(top_k, scores.shape[-1])
    top_scores, idx = top_k_stable(scores, k)
    top_boxes = torch.gather(boxes, -2, idx[..., None].expand(*idx.shape, 4))
    iou = _pairwise_iou(top_boxes)
    above = iou > iou_threshold
    later = torch.triu(torch.ones(k, k, dtype=torch.bool, device=boxes.device), diagonal=1)
    cand = above & later
    keep = _GREEDY(cand) & (top_scores > 0)
    return top_boxes, top_scores, keep


def detect(loc_pred: torch.Tensor, conf_pred: torch.Tensor, priors: torch.Tensor,
           conf_thresh: float = 0.01, nms_thresh: float = 0.45, top_k: int = 200,
           variances=(0.1, 0.2)) -> torch.Tensor:
    """Test-time decode (``nms.py:52-80``): per class, threshold, NMS, into
    a fixed (B, C, top_k, 5) tensor of (score, x1, y1, x2, y2); class 0, the
    background, stays empty. ``conf_pred`` are softmax scores. Spans:
    ``det.decode`` (the boxes and the thresholded scores) and ``det.nms``
    (``nms_fixed``, with the device's CUDA events)."""
    with span("det.decode"):
        boxes = decode(loc_pred, priors, variances)                    # (B, P, 4)
        scores = conf_pred[..., 1:].transpose(1, 2)                    # (B, C-1, P)
        s = torch.where(scores > conf_thresh, scores, torch.zeros_like(scores))
    n_cls = s.shape[1]
    with span("det.nms", boxes.device):
        b, sc, keep = nms_fixed(boxes[:, None].expand(-1, n_cls, -1, -1), s, nms_thresh, top_k)
    sc = torch.where(keep, sc, torch.zeros_like(sc))
    out = torch.cat([sc[..., None], b], dim=-1)                        # (B, C-1, K, 5)
    return torch.cat([torch.zeros_like(out[:, :1]), out], dim=1)
