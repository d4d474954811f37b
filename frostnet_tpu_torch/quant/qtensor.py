"""QTensor: an activation of the frozen INT8 graph.

Activations travel as (integer storage, scale, zero_point) triples, as
qnnpack's quantized tensors do. ``scale`` and ``zero_point`` are 0-dim
tensors on the storage's device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class QTensor(NamedTuple):
    q: torch.Tensor           # uint8 storage, NHWC
    scale: torch.Tensor       # f32 scalar
    zero_point: torch.Tensor  # int32 scalar

    def dequantize(self) -> torch.Tensor:
        return (self.q.to(torch.float32) - self.zero_point.to(torch.float32)) * self.scale


class QParams(NamedTuple):
    """A grid known at freeze time: host scale and zero point."""

    scale: float
    zero_point: int

    def tensors(self, device):
        """(scale, zero_point) as 0-dim tensors for a :class:`QTensor`."""
        return (torch.tensor(self.scale, dtype=torch.float32, device=device),
                torch.tensor(self.zero_point, dtype=torch.int32, device=device))
