"""Serialized serving programs: the deployment artifact as a program
(``frostnet_tpu/quant/serialize.py``).

:func:`export_serving` freezes a model's INT8 forward and exports it with
``torch.export`` on a symbolic batch size (one program serves any batch), or
at ``batch=N`` for a static-batch program, and saves it (``.pt2``). The
frozen operands (int8 weights, epilogue constants) are baked into the
program as constants, and the four INT8 kernels and the bilinear resize
appear as the ``torch.library`` ops ``frostnet::int8_matmul_requant``,
``frostnet::frost_block_int8``, ``frostnet::conv3x3_s1_int8``,
``frostnet::depthwise_int8`` and ``frostnet::resize_bilinear``.

:func:`load_serving` loads a program into a callable from images to logits
on the device asked for (``torch.export``'s device pass moves it; nothing
falls back to the CPU). The JAX package's program needs only a JAX runtime;
this one needs torch and the op library ``frostnet_tpu_torch.ops``, which
registers the kernels' ops (CUDA implementation: the hand kernels; CPU: their
plain versions), but not the model code: ``frostnet_tpu_torch.models`` and
``frostnet_tpu_torch.nn`` are not imported.
"""
from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch


class _Serving(torch.nn.Module):
    """The frozen INT8 forward as a module of no parameters: the model is
    held outside the module tree, so only the frozen tensors the forward
    reads become the program's constants."""

    def __init__(self, model):
        super().__init__()
        object.__setattr__(self, "model", model)

    def forward(self, x):
        from ..nn.mode import INT8

        return self.model(x, mode=INT8)


def export_serving(model, path: str, *, image_size: int = 224, channels: int = 3,
                   batch: Optional[int] = None) -> int:
    """Freeze ``model`` (calibrated: observers populated) for ``image_size``
    on the device of its parameters, export its INT8 forward and write it to
    ``path``. Returns the bytes written."""
    from .freeze import freeze

    device = next(model.parameters()).device
    freeze(model, device, image_size=image_size)
    example = torch.zeros((batch or 2, image_size, image_size, channels), device=device)
    dynamic = None if batch else {"x": {0: torch.export.Dim("batch")}}
    with torch.no_grad():
        program = torch.export.export(_Serving(model), (example,), dynamic_shapes=dynamic)
    torch.export.save(program, path)
    return os.path.getsize(path)


def load_serving(path: str, device="cuda") -> Callable:
    """Load an :func:`export_serving` program onto ``device``: returns
    ``fn(images) -> logits``, images (B, S, S, C) float32 (numpy or torch),
    logits a tensor on ``device``."""
    from torch.export.passes import move_to_device_pass

    from .. import ops  # noqa: F401 - registers the kernels' ops
    from .freeze import resolve_device

    device = resolve_device(device)
    program = move_to_device_pass(torch.export.load(path), device)
    module = program.module()

    def fn(images):
        x = torch.as_tensor(np.asarray(images, np.float32) if isinstance(images, np.ndarray)
                            else images)
        with torch.no_grad():
            return module(x.to(device=device, dtype=torch.float32))

    return fn
