"""Top-k accuracy, the confusion-matrix mIoU and the running average
(``frostnet_tpu/utils/metrics.py``)."""
from __future__ import annotations

from typing import Sequence, Tuple

import torch


def topk_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                  ks: Sequence[int] = (1, 5)) -> Tuple[torch.Tensor, ...]:
    """Fraction correct at each k, as float32 device scalars (no host sync).
    ``logits`` (B, C), ``labels`` (B,)."""
    pred = torch.topk(logits, max(ks), dim=-1).indices
    correct = pred == labels.to(torch.int64).unsqueeze(-1)
    return tuple(correct[:, :k].any(dim=1).to(torch.float32).mean() for k in ks)


def confusion_matrix(pred: torch.Tensor, target: torch.Tensor, num_classes: int,
                     ignore_index: int = 255) -> torch.Tensor:
    """(C, C) int64 confusion matrix on ``pred``'s device, rows the target
    and columns the prediction: the JAX package's counts (it adds int32 per
    step), from one ``bincount`` (no host sync). Targets equal to
    ``ignore_index`` or outside [0, C) are not counted (they land in an
    extra bin, dropped); predictions are clipped into [0, C)."""
    n = num_classes * num_classes
    target = target.reshape(-1).to(torch.int64)
    pred = torch.clamp(pred.reshape(-1).to(torch.int64), 0, num_classes - 1)
    valid = (target != ignore_index) & (target >= 0) & (target < num_classes)
    idx = torch.where(valid, target * num_classes + pred, torch.full_like(target, n))
    return torch.bincount(idx, minlength=n + 1)[:n].reshape(num_classes, num_classes)


def miou_from_confusion(cm) -> Tuple[torch.Tensor, torch.Tensor]:
    """(per-class IoU, mean IoU over the classes present), float32 on the
    CPU, rounded as XLA's CPU program rounds the JAX function: the counts
    converted to float32, the row and column sums and the sum of the IoUs
    taken in index order, one float32 rounding an add."""
    f = torch.as_tensor(cm).cpu().to(torch.float32)
    c = f.shape[0]
    rows, cols = torch.zeros(c), torch.zeros(c)
    for i in range(c):
        cols = cols + f[i]
        rows = rows + f[:, i]
    inter = torch.diagonal(f)
    union = cols + rows - inter
    iou = inter / torch.clamp(union, min=1.0)
    present = union > 0
    total = torch.zeros((), dtype=torch.float32)
    for v in torch.where(present, iou, torch.zeros(())):
        total = total + v
    return iou, total / torch.tensor(float(max(int(present.sum()), 1)))


class AverageMeter:
    """Running average (reference helper_functions.py:8-29)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)
