"""FLOPs and parameter counts (``frostnet_tpu/utils/flops.py``).

The JAX package reads XLA's cost analysis of the compiled program; the port
counts with ``torch.utils.flop_counter.FlopCounterMode``, which counts the
matrix products and convolutions (a multiply-add is 2 FLOPs, the reference
counters' convention) and not the elementwise ops that XLA's analysis adds.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn


def count_params(params) -> int:
    """Elements of a module's parameters, or of an iterable or dict of
    tensors (the JAX ``params`` collection: BN statistics and observers are
    buffers, not counted)."""
    if isinstance(params, nn.Module):
        params = params.parameters()
    elif isinstance(params, dict):
        params = params.values()
    return sum(int(p.numel()) for p in params)


def compute_flops(fn, *args, **kwargs) -> float:
    """FLOPs of one call ``fn(*args, **kwargs)``, counted as it runs."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


def model_flops_params(model: nn.Module, input_shape=(1, 224, 224, 3),
                       **forward_kwargs) -> Tuple[float, int]:
    """(FLOPs, parameters) of one forward of ``model`` on zeros of
    ``input_shape`` (NHWC), on the device of its parameters."""
    device = next(model.parameters()).device
    x = torch.zeros(input_shape, device=device)
    return compute_flops(model, x, **forward_kwargs), count_params(model)
