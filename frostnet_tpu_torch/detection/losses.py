"""The MultiBox loss, fixed-shape and on the device
(``frostnet_tpu/detection/losses.py:18-52``).

Prior matching is batched (``boxes.batched_match_priors``); the
localization loss is smooth-L1 on the positives; hard negative mining ranks
each image's per-prior softmax losses, positives at 0, and keeps the
``negpos_ratio * num_pos`` highest. The rank is the JAX package's
``argsort(argsort(-neg_cand))``, whose first sort is stable: the positives'
zeros and any equal losses tie, and a stable sort orders them by prior index
(``torch.sort(stable=True)`` on the same negated values; ``-0.0`` and
``0.0`` compare equal in both). The second argsort of a permutation is its
inverse, computed here by a scatter.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..utils.losses import smooth_l1
from .boxes import batched_match_priors


def negative_rank(neg_cand: torch.Tensor) -> torch.Tensor:
    """(B, P) rank of each prior by descending ``neg_cand``, ties by index."""
    order = torch.sort(-neg_cand, dim=1, stable=True).indices
    rank = torch.empty_like(order)
    ar = torch.arange(order.shape[1], device=order.device).expand_as(order)
    return rank.scatter_(1, order, ar)


def multibox_loss(loc_pred: torch.Tensor, conf_pred: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_labels: torch.Tensor, gt_valid: torch.Tensor, priors: torch.Tensor,
                  threshold: float = 0.5, negpos_ratio: int = 3,
                  variances=(0.1, 0.2)) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss_loc, loss_conf), each normalized by the batch's positives.

    ``loc_pred`` (B, P, 4), ``conf_pred`` (B, P, C) logits, ``gt_boxes``
    (B, G, 4) point-form, ``gt_labels`` (B, G) 0-based, ``gt_valid`` (B, G)
    bool, ``priors`` (P, 4) center-form.
    """
    loss_l, loss_c, num_pos = multibox_loss_sums(loc_pred, conf_pred, gt_boxes, gt_labels,
                                                 gt_valid, priors, threshold, negpos_ratio,
                                                 variances)
    n = torch.clamp(num_pos, min=1.0)
    return loss_l / n, loss_c / n


def multibox_loss_sums(loc_pred: torch.Tensor, conf_pred: torch.Tensor, gt_boxes: torch.Tensor,
                       gt_labels: torch.Tensor, gt_valid: torch.Tensor, priors: torch.Tensor,
                       threshold: float = 0.5, negpos_ratio: int = 3, variances=(0.1, 0.2)
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(the localization sum, the confidence sum, the batch's positives as
    float32) of :func:`multibox_loss`, which divides the sums by the
    positives (at least 1). Under data parallelism the positives are the
    global batch's (``parallel.global_normalizer``); the hard negatives are
    mined per image, so they need no collective."""
    with torch.no_grad():
        loc_t, conf_t = batched_match_priors(gt_boxes, gt_labels, gt_valid, priors,
                                             threshold, variances)
    pos = conf_t > 0
    num_pos = pos.sum(dim=1, keepdim=True)

    l1 = smooth_l1(loc_pred, loc_t).sum(dim=-1)
    loss_l = (l1 * pos).sum()

    logp = F.log_softmax(conf_pred, dim=-1)
    ce = -torch.gather(logp, -1, conf_t.to(torch.int64)[..., None])[..., 0]
    with torch.no_grad():
        neg_cand = torch.where(pos, torch.zeros_like(ce), ce)
        rank = negative_rank(neg_cand)
        num_neg = torch.clamp(negpos_ratio * num_pos, max=pos.shape[1] - 1)
        keep = pos | (rank < num_neg)
    loss_c = (ce * keep).sum()
    return loss_l, loss_c, num_pos.sum().to(torch.float32)
