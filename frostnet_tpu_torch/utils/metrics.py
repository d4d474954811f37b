"""Top-k accuracy and the running average (``frostnet_tpu/utils/metrics.py``)."""
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
