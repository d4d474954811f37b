"""Pooling of float tensors and QTensors (``frostnet_tpu/nn/pool.py``).

PyTorch's quantized pooling keeps the input grid (no observer).
:func:`global_avg_pool` and :func:`avg_pool` round the integer average as
the frozen JAX graph does: the float sum of the codes (exact) times
``f32(1 / count)`` (XLA rewrites flax's division by the constant window
area into that multiply; read from the optimized HLO), rounded half to even
and clipped at 255 for every qconfig. :func:`max_pool` takes the max of the
codes on the input's grid, exact in any order.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

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


def avg_pool(x, window: int, strides: Optional[int] = None):
    """'VALID' average pooling over NHWC ``x`` (the LR-ASPP gate's pool).

    A QTensor keeps its grid: each window's code sum (an integer up to
    ``255 * window**2``, exact) times ``f32(1 / window**2)``, rounded half to
    even and clipped. A float tensor takes the same form on its float32
    window sums, each summed exactly in float64 and rounded once (XLA's
    ``reduce_window`` sums in window order: the float sums may differ from
    it in the last bit, on every device alike).
    """
    strides = strides or window
    xt = (x.q if isinstance(x, QTensor) else x).permute(0, 3, 1, 2)
    s = F.avg_pool2d(xt.to(torch.float64), window, strides, divisor_override=1)
    s = s.to(torch.float32).permute(0, 2, 3, 1)
    m = s * torch.full((), reciprocal(float(window * window)), device=s.device)
    if isinstance(x, QTensor):
        q = torch.clamp(torch.round(m), 0, 255).to(x.q.dtype)
        return QTensor(q.contiguous(), x.scale, x.zero_point)
    return m.to(x.dtype)


def max_pool(x, window: int, strides: int, padding: int = 0,
             zero_point: Optional[int] = None):
    """Max pooling over NHWC ``x``, ``padding`` pixels on each side.

    The ResNet stem's pool (``frostnet_tpu/models/resnet.py`` ``_pad1``,
    then ``max_pool(.., "VALID")``): a QTensor is padded with its zero point
    (the code of 0.0) and the max taken over the uint8 codes, as the max of
    the ``window``**2 strided slices (exact, and the same on every device);
    a float tensor is padded with ``-inf`` (``F.max_pool2d``, whose gradient
    goes to the first maximum of each window in row-major order, as XLA's
    ``select_and_scatter`` does). ``zero_point`` is the QTensor's, where the
    caller knows it at freeze time (no read of the device).
    """
    if isinstance(x, QTensor):
        q = x.q
        if padding:
            zp = int(x.zero_point) if zero_point is None else zero_point
            q = F.pad(q, (0, 0, padding, padding, padding, padding), value=zp)
        ho = (q.shape[1] - window) // strides + 1
        wo = (q.shape[2] - window) // strides + 1
        out = None
        for dy in range(window):
            for dx in range(window):
                sl = q[:, dy:dy + (ho - 1) * strides + 1:strides,
                       dx:dx + (wo - 1) * strides + 1:strides, :]
                out = sl if out is None else torch.maximum(out, sl)
        return QTensor(out.contiguous(), x.scale, x.zero_point)
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, strides, padding)
    return y.permute(0, 2, 3, 1)
