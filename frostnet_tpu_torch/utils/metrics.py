"""Top-k accuracy (``frostnet_tpu/utils/metrics.py::topk_accuracy``)."""
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
