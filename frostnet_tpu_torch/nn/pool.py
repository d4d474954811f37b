"""Global average pooling of a QTensor.

PyTorch's quantized pooling keeps the input grid and rounds the integer
average (no observer). The mean is the frozen JAX graph's: the float sum of
the codes (exact) times ``f32(1 / count)``, rounded half to even and clipped
at 255 for every qconfig, as ``frostnet_tpu/nn/pool.py`` does.
"""
from __future__ import annotations

import torch

from ..ops.requant import reciprocal
from ..quant.qtensor import QTensor


def global_avg_pool(x, keepdims: bool = True):
    """Mean over the spatial dims (NHWC). QTensor in -> QTensor out."""
    if isinstance(x, QTensor):
        n = x.q.shape[1] * x.q.shape[2]
        s = x.q.to(torch.float32).sum(dim=(1, 2), keepdim=keepdims)
        m = s * torch.full((), reciprocal(float(n)), device=s.device)
        q = torch.clamp(torch.round(m), 0, 255).to(x.q.dtype)
        return QTensor(q, x.scale, x.zero_point)
    return x.mean(dim=(1, 2), keepdim=keepdims)
