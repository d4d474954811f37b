"""Bilinear resize (``align_corners``) with the rounding of the frozen JAX graph.

The JAX package resizes NHWC tensors with two float32 einsums against
host-built interpolation matrices (``frostnet_tpu/ops/resize.py``), the H
pass first. Each output is the dot of one matrix row with the input, and a
row has at most two nonzero taps, ``lo = floor(pos)`` and ``lo + 1``. The
zero taps add exact zeros. How XLA's CPU dot rounds the two taps depends on
the pass's output side (read from its output at the GAN's and the
segmentation models' sizes, for 16 or more channels):

* a multiple of 64 (the GAN's 64 -> 128 and 128 -> 256, the segmentation
  tails' 96 -> 768, 8 -> 64, 48 -> 192): fused multiply-adds in index order,
  the ``lo`` product rounded, then ``fma(w_hi, x_hi, w_lo * x_lo)``;
* any other side (the LR-ASPP heads' 48 -> 96, 6 -> 12, 4 -> 8; the 96
  crop's tail 12 -> 96): each product rounded, then their sum,
  ``w_lo * x_lo + w_hi * x_hi``.

:func:`resize_bilinear` writes these forms as elementwise torch ops, so it
gives the same bits on any device (no cuBLAS, whose order of summation is
not specified). ``tests/test_torch_resize.py`` holds it bit-exact against
the JAX function at each of those sizes.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .requant import fma_f32


def _taps(n_in: int, n_out: int, align_corners: bool):
    """(lo, hi, w_lo, w_hi) of each output row, the float32 weights of the
    reference's interpolation matrix. Where both taps fall on one input
    (``pos == n_in - 1``), ``w_hi`` is 0."""
    if n_out == 1:
        pos = np.zeros((1,), np.float64)
    elif align_corners:
        pos = np.linspace(0.0, n_in - 1.0, n_out)
    else:
        pos = np.clip((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5, 0.0, n_in - 1.0)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    w = (pos - lo).astype(np.float64)
    return lo, hi, (1.0 - w).astype(np.float32), w.astype(np.float32)


def _linear_matrix(n_in: int, n_out: int, align_corners: bool) -> np.ndarray:
    """(n_out, n_in) row-stochastic interpolation matrix (host-computed)."""
    lo, hi, w_lo, w_hi = _taps(n_in, n_out, align_corners)
    m = np.zeros((n_out, n_in), np.float32)
    m[np.arange(n_out), lo] += w_lo
    m[np.arange(n_out), hi] += w_hi
    return m


def _interp(x: torch.Tensor, dim: int, n_out: int, align_corners: bool) -> torch.Tensor:
    lo, hi, w_lo, w_hi = _taps(x.shape[dim], n_out, align_corners)
    dev = x.device
    shape = [1] * x.dim()
    shape[dim] = n_out

    def weight(w):
        return torch.as_tensor(w, device=dev).reshape(shape)

    x_lo = x.index_select(dim, torch.as_tensor(lo, device=dev))
    x_hi = x.index_select(dim, torch.as_tensor(hi, device=dev))
    if n_out % 64 == 0:
        return fma_f32(x_hi, weight(w_hi), x_lo * weight(w_lo))
    return x_lo * weight(w_lo) + x_hi * weight(w_hi)


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int],
                    align_corners: bool = True) -> torch.Tensor:
    """NHWC float32 bilinear resize to ``size`` = (H, W)."""
    h_out, w_out = size
    if tuple(x.shape[1:3]) == (h_out, w_out):
        return x
    y = _interp(x.to(torch.float32), 1, h_out, align_corners)
    return _interp(y, 2, w_out, align_corners).to(x.dtype)
