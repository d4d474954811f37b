"""Box geometry and SSD prior matching (``frostnet_tpu/detection/boxes.py``).

Fixed-shape and batched, on the device: padded ground-truth boxes with a
validity mask, as the JAX package matches them (no per-image host loop).
Point-form boxes are (x1, y1, x2, y2) in [0, 1], priors center-form
(cx, cy, w, h), offsets variance-encoded (0.1, 0.2).

Against the jitted JAX functions on the CPU (``tests/test_torch_det_core.py``):

* every division by a constant is the JAX program's: XLA turns ``x / 2`` and
  ``x / 0.2`` into multiplies by the float32 reciprocal, and so does this
  module (``_half``, ``_inv_var1``); a division by a tensor stays a division;
* the IoU's union: XLA contracts one area product (and, in its loop's
  scalar tail, the intersection too) into fused multiply-adds; the port
  rounds each product, so IoUs agree within ``IOU_ULPS`` float32 ulps;
* ``argmax`` takes the first maximum, as ``jnp.argmax`` does, and so does
  ``torch.argmax`` (documented; the tests hold it on ties);
* ``encode``'s ``log`` and ``decode``'s ``exp`` are each library's own:
  XLA's CPU approximations and torch's differ by at most a few float32 ulps
  (``LOG_EXP_ULPS``), so loc targets and decoded boxes are held within
  that; the integer outputs (the matched truth, ``conf_t``) are equal.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..ops.requant import reciprocal

# the most float32 ulps between the JAX functions and these, held in
# tests/test_torch_det_core.py on seeded boxes and offsets
IOU_ULPS = 4
LOG_EXP_ULPS = 8


def _c(v: float, ref: torch.Tensor) -> torch.Tensor:
    return torch.full((), v, dtype=torch.float32, device=ref.device)


def _half(x: torch.Tensor) -> torch.Tensor:
    """``x / 2`` (exact as ``x * 0.5``)."""
    return x * _c(0.5, x)


def point_form(boxes: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2)."""
    c, half = boxes[..., :2], _half(boxes[..., 2:])
    return torch.cat([c - half, c + half], -1)


def center_form(boxes: torch.Tensor) -> torch.Tensor:
    """(x1, y1, x2, y2) -> (cx, cy, w, h)."""
    return torch.cat([_half(boxes[..., :2] + boxes[..., 2:]),
                      boxes[..., 2:] - boxes[..., :2]], -1)


def intersect(box_a: torch.Tensor, box_b: torch.Tensor) -> torch.Tensor:
    """Pairwise intersection area, (A, 4), (B, 4) -> (A, B); batched over
    leading dims of ``box_a`` when it is (..., A, 4)."""
    max_xy = torch.minimum(box_a[..., :, None, 2:], box_b[..., None, :, 2:])
    min_xy = torch.maximum(box_a[..., :, None, :2], box_b[..., None, :, :2])
    wh = torch.clamp(max_xy - min_xy, min=0.0)
    return wh[..., 0] * wh[..., 1]


def jaccard(box_a: torch.Tensor, box_b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU, (A, 4), (B, 4) -> (A, B)."""
    inter = intersect(box_a, box_b)
    area_a = (box_a[..., 2] - box_a[..., 0]) * (box_a[..., 3] - box_a[..., 1])
    area_b = (box_b[..., 2] - box_b[..., 0]) * (box_b[..., 3] - box_b[..., 1])
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-12)


def encode(matched: torch.Tensor, priors: torch.Tensor, variances=(0.1, 0.2)) -> torch.Tensor:
    """Point-form matched truths -> variance-encoded offsets against the
    center-form priors (``boxes.py:47-54``)."""
    g_cxcy = _half(matched[..., :2] + matched[..., 2:]) - priors[..., :2]
    g_cxcy = g_cxcy / (_c(variances[0], priors) * priors[..., 2:])
    g_wh = (matched[..., 2:] - matched[..., :2]) / priors[..., 2:]
    g_wh = torch.log(torch.clamp(g_wh, min=1e-12)) * _c(reciprocal(variances[1]), g_wh)
    return torch.cat([g_cxcy, g_wh], -1)


def decode(loc: torch.Tensor, priors: torch.Tensor, variances=(0.1, 0.2)) -> torch.Tensor:
    """Offsets -> point-form boxes (``boxes.py:57-61``)."""
    cxcy = priors[..., :2] + loc[..., :2] * _c(variances[0], loc) * priors[..., 2:]
    wh = priors[..., 2:] * torch.exp(loc[..., 2:] * _c(variances[1], loc))
    half = _half(wh)
    return torch.cat([cxcy - half, cxcy + half], -1)


def batched_match_priors(truths: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor,
                         priors: torch.Tensor, threshold: float = 0.5,
                         variances=(0.1, 0.2)) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prior matching over a batch (``boxes.py:64-105``, vmapped).

    ``truths`` (B, G, 4) point-form and zero-padded, ``labels`` (B, G)
    0-based, ``valid`` (B, G) bool, ``priors`` (P, 4). Returns
    (loc_targets (B, P, 4) float32, conf_targets (B, P) int32, 0 the
    background). Each valid truth claims its best prior (overlap set to 2);
    where several claim one prior the later truth wins, as the reference's
    sequential loop overwrites.
    """
    overlaps = jaccard(truths, point_form(priors))                       # (B, G, P)
    overlaps = torch.where(valid[..., None], overlaps, _c(-1.0, overlaps))
    # torch.argmax returns the first maximal index, as jnp.argmax does
    best_prior_idx = torch.argmax(overlaps, dim=2)                        # (B, G)
    best_truth_overlap, _ = torch.max(overlaps, dim=1)                    # (B, P)
    best_truth_idx = torch.argmax(overlaps, dim=1)                        # (B, P)

    g = truths.shape[1]
    prior_ids = torch.arange(priors.shape[0], device=truths.device)
    for_gt = torch.where(valid, best_prior_idx, torch.full_like(best_prior_idx, -1))
    hit = prior_ids[None, :, None] == for_gt[:, None, :]                  # (B, P, G)
    best_truth_overlap = torch.where(hit.any(2), _c(2.0, overlaps), best_truth_overlap)
    gt_order = torch.arange(g, device=truths.device)
    claimed = torch.where(hit, gt_order, torch.full_like(gt_order, -1))
    claim_idx = claimed.max(dim=2).values
    best_truth_idx = torch.where(claim_idx >= 0, claim_idx, best_truth_idx)

    matches = torch.gather(truths, 1, best_truth_idx[..., None].expand(-1, -1, 4))
    conf = torch.gather(labels.to(torch.int64), 1, best_truth_idx) + 1
    conf = torch.where(best_truth_overlap < threshold, torch.zeros_like(conf), conf)
    loc = encode(matches, priors, variances)
    return loc, conf.to(torch.int32)


def match_priors(truths: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor,
                 priors: torch.Tensor, threshold: float = 0.5,
                 variances=(0.1, 0.2)) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-image prior matching: (G, 4), (G,), (G,) -> ((P, 4), (P,))."""
    loc, conf = batched_match_priors(truths[None], labels[None], valid[None], priors,
                                     threshold, variances)
    return loc[0], conf[0]
