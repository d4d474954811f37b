"""Losses (``frostnet_tpu/utils/losses.py``): the weighted, ignore-aware
cross-entropy, the segmentation trainer's ``bce`` branch and the SSD
localization loss (``smooth_l1``)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  class_weights: Optional[torch.Tensor] = None,
                  ignore_index: Optional[int] = None,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """Weighted CE with an optional ignore label: torch's
    ``nn.CrossEntropyLoss(weight, ignore_index)`` mean reduction (the
    weighted mean), with label smoothing as the JAX package mixes it:
    ``(1 - a) * nll + a * mean_c(-log p)``.

    ``logits`` (..., C), ``labels`` integer (...,). Labels outside [0, C)
    read class 0 (and count unless they are ``ignore_index``).
    """
    num_classes = logits.shape[-1]
    labels = labels.to(torch.int64)
    safe = torch.where((labels < 0) | (labels >= num_classes), torch.zeros_like(labels), labels)
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe.unsqueeze(-1)).squeeze(-1)
    if label_smoothing > 0.0:
        nll = (1 - label_smoothing) * nll + label_smoothing * (-logp.mean(dim=-1))
    w = torch.ones_like(nll) if class_weights is None else class_weights.to(nll.dtype)[safe]
    if ignore_index is not None:
        w = torch.where(labels == ignore_index, torch.zeros_like(w), w)
    return (nll * w).sum() / torch.clamp(w.sum(), min=1e-12)


def binary_cross_entropy_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                                     pos_weight: Optional[torch.Tensor] = None,
                                     weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """BCEWithLogits with mean reduction (the JAX package's, after
    SegmentationLoss's bce branch): ``-(t * log sigmoid(x) + (1 - t) *
    log sigmoid(-x))``, ``pos_weight`` scaling the positive term and
    ``weight`` the elementwise loss (per class when shaped (C,) against
    NHWC logits)."""
    log_p, log_not_p = F.logsigmoid(logits), F.logsigmoid(-logits)
    pos = targets * log_p if pos_weight is None else pos_weight * targets * log_p
    loss = -(pos + (1 - targets) * log_not_p)
    if weight is not None:
        loss = loss * weight
    return loss.mean()


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """Huber / smooth-L1, elementwise (the SSD localization loss;
    ``frostnet_tpu/utils/losses.py:60``): ``0.5 * d * d / beta`` where
    ``d = |pred - target| < beta``, else ``d - 0.5 * beta``."""
    d = torch.abs(pred - target)
    half = torch.full((), 0.5, dtype=d.dtype, device=d.device)
    if beta == 1.0:  # XLA drops the division by the constant 1
        quad = half * d * d
    else:
        quad = half * d * d / beta
    return torch.where(d < beta, quad, d - 0.5 * beta)
