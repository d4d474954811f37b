"""freeze: the torch.quantization.convert equivalent.

``freeze(model, device=...)`` moves the model to the device and freezes it
once: every conv's BN fold, int8 weight, column sums and epilogue
constants, and every fused block's packed operands, are computed there and
kept. The returned function runs the frozen INT8 graph: only the kernels and
the small torch ops between them.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..utils.profiling import span


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; CUDA must be present when asked for."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is available "
                           "(pass device='cpu' to run the plain versions)")
    return device


def freeze(model, device="cuda", image_size: int = 224) -> Callable:
    """Return ``fn(images, post=None) -> output`` running ``model``'s frozen
    INT8 graph.

    ``images`` are (B, S, S, 3) float NHWC (numpy or torch); the model's
    float32 output (a classifier's logits, a generator's images, a
    detector's ``(loc, conf)``) comes back as a tensor on ``device``.
    ``post`` runs on that output inside the same ``request`` span, and
    ``fn`` returns what it returns (``serve.DetPredictor.detect``).
    ``image_size`` fixes the fused blocks' launch plans.
    """
    from ..nn.mode import INT8

    device = resolve_device(device)
    model.to(device).eval()
    model.prepare_int8(device, image_size)

    @torch.inference_mode()
    def fn(images, post: Optional[Callable] = None):
        with span("request"):
            with span("request.input"):
                x = torch.as_tensor(np.asarray(images, np.float32)
                                    if isinstance(images, np.ndarray) else images)
                x = x.to(device=device, dtype=torch.float32)
            with span("request.forward"):
                out = model(x, mode=INT8)
            return out if post is None else post(out)

    return fn
