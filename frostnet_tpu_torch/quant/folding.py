"""BatchNorm folding as a parameter transform (the ``fuse_modules`` fold)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def bn_scale_factor(gamma: torch.Tensor, running_var: torch.Tensor, eps: float) -> torch.Tensor:
    """gamma / sqrt(running_var + eps), the per-output-channel BN scale.

    The square root is taken in float64 and rounded once to float32, which
    gives the correctly rounded float32 root (XLA's); torch's vectorized
    float32 ``sqrt`` on the CPU is off by one ulp on some inputs.
    """
    root = torch.sqrt((running_var + eps).to(torch.float64)).to(torch.float32)
    return gamma / root


def fold_bn(w: torch.Tensor, b: Optional[torch.Tensor], gamma: torch.Tensor,
            beta: torch.Tensor, running_mean: torch.Tensor,
            running_var: torch.Tensor, eps: float = 1e-5
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold inference-time BN into an HWIO conv weight and its bias.

    ``conv(x, w_folded) + b_folded == bn(conv(x, w) + b)`` with running
    stats. Multiply and add round separately, as XLA's constant folding of
    the frozen JAX graph does.
    """
    sf = bn_scale_factor(gamma, running_var, eps)
    w_folded = w * sf.reshape((1,) * (w.ndim - 1) + (-1,))
    if b is None:
        b = torch.zeros_like(running_mean)
    b_folded = (b - running_mean) * sf + beta
    return w_folded.to(w.dtype), b_folded.to(torch.float32)
