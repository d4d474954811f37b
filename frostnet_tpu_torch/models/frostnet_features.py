"""FrostNet as a multi-scale feature backbone, and the reference's torch checkpoints.

The port of ``frostnet_tpu/models/frostnet_features.py``:
:class:`FrostNetFeatures` returns the ``[x1, x2, x3, x5]`` stage features
(strides 4/8/16/32, or dilated with ``output_stride`` 16 or 8), and
:func:`load_torch_frostnet_checkpoint` loads a checkpoint of the reference
torch FrostNet (NCHW, OIHW kernels) into a port model. The JAX package's
``flax_to_mutable`` has no counterpart: the port's parameters are module
state, filled in place.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..nn import FP32, QuantMode
from ..quant import QConfig, QNNPACK
from .frostnet import FrostNet


class FrostNetFeatures(nn.Module):
    """Backbone wrapper: ``forward`` returns ``[x1, x2, x3, x5]``.

    The trunk is a head-less :class:`FrostNet` named ``trunk``, so the
    variables are the JAX module's (``params/trunk/...``). ``frozen_stages``
    = N detaches the first N returned features, as JAX's ``stop_gradient``
    on those outputs: no gradient flows back through them, while the later
    stages' features still send gradients into the frozen stages'
    parameters (nothing is made ``requires_grad=False``).
    """

    def __init__(self, mode: str = "large", width_mult: float = 1.0, quantized: bool = False,
                 frozen_stages: int = -1, output_stride: int = 32,
                 qconfig: QConfig = QNNPACK, fuse_int8: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.frozen_stages = frozen_stages
        self.trunk = FrostNet(mode=mode, width_mult=width_mult, quantized=quantized,
                              output_stride=output_stride, qconfig=qconfig,
                              fuse_int8=fuse_int8, dtype=dtype, head=False)

    def prepare_int8(self, device, image_size: int) -> None:
        self.trunk.prepare_int8(device, image_size)

    def forward(self, x: torch.Tensor, mode: QuantMode = FP32,
                train: bool = False) -> List[torch.Tensor]:
        feats = self.trunk(x, mode, train, features_only=True)
        return [f.detach() if i < self.frozen_stages else f for i, f in enumerate(feats)]


def _module_name(key: str) -> Optional[Tuple[List[str], int, str]]:
    """``layer3.2.conv2.conv.0.weight`` -> (["layer3_2", "conv2"], 0, "weight")."""
    m = re.match(r"layer(\d)\.(\d+)\.(\w+)\.conv\.(\d)\.(.*)", key)
    if m:
        return [f"layer{m.group(1)}_{m.group(2)}", m.group(3)], int(m.group(4)), m.group(5)
    m = re.match(r"(conv1|last_layer)\.conv\.(\d)\.(.*)", key)
    if m:
        return [m.group(1)], int(m.group(2)), m.group(3)
    return None


def _state_dict(path_or_state) -> Dict[str, np.ndarray]:
    """The checkpoint's state dict as numpy, ``module.`` stripped: the
    ``state_dict_ema`` entry if there is one, else ``state_dict``, else the
    checkpoint itself (the reference's loading convention)."""
    if isinstance(path_or_state, str):
        # weights_only: a checkpoint from elsewhere may not run code when read
        ckpt = torch.load(path_or_state, map_location="cpu", weights_only=True)
    else:
        ckpt = path_or_state
    if isinstance(ckpt, dict) and "state_dict_ema" in ckpt:
        state = ckpt["state_dict_ema"]
    elif isinstance(ckpt, dict) and "state_dict" in ckpt:
        state = ckpt["state_dict"]
    else:
        state = ckpt
    return {re.sub(r"^module\.", "", k): np.asarray(v.detach().cpu().numpy()
                                                     if isinstance(v, torch.Tensor) else v)
            for k, v in state.items()}


def load_torch_frostnet_checkpoint(path_or_state, model: nn.Module) -> nn.Module:
    """Load a reference FrostNet torch checkpoint into ``model`` in place.

    ``model`` is a port :class:`FrostNet`, or a :class:`FrostNetFeatures`:
    its trunk is filled and the head's keys (``last_layer``, ``classifier``)
    are skipped, as the trunk has no head (the JAX loader writes the top
    level of the tree, which fits only the classifier). ``path_or_state`` is a file that
    ``torch.load`` reads or a state dict. It maps, as the JAX loader does::

      <block>.conv.0.weight        -> <block>.kernel  (OIHW -> HWIO)
      <block>.conv.1.{weight,bias} -> <block>.{scale,bias_bn}
      <block>.conv.1.running_*     -> <block>.{mean,var}
      classifier.2.{weight,bias}   -> classifier.{kernel,bias}

    and skips every other key. A mapped key the model lacks, or a shape that
    differs, raises; so does a checkpoint of which nothing matched. Returns
    ``model``.
    """
    net = model.trunk if isinstance(model, FrostNetFeatures) else model
    state = _state_dict(path_or_state)
    targets = []
    for key, val in state.items():
        if key.startswith("classifier."):
            if key.endswith("2.weight"):
                targets.append((["classifier", "kernel"], val.transpose(2, 3, 1, 0)))
            elif key.endswith("2.bias"):
                targets.append((["classifier", "bias"], val))
            continue
        parsed = _module_name(key)
        if parsed is None:
            continue
        path, seq_idx, leaf = parsed
        if seq_idx == 0 and leaf == "weight":
            targets.append((path + ["kernel"], val.transpose(2, 3, 1, 0)))
        elif seq_idx == 1 and leaf in ("weight", "bias"):
            targets.append((path + ["scale" if leaf == "weight" else "bias_bn"], val))
        elif leaf in ("running_mean", "running_var"):
            targets.append((path + [leaf[len("running_"):]], val))
    if not targets:
        raise ValueError("no weights matched — is this a FrostNet checkpoint?")
    if not net.head:
        targets = [(p, v) for p, v in targets if p[0] not in ("last_layer", "classifier")]
    with torch.no_grad():
        for path, val in targets:
            mod = net
            for name in path[:-1]:
                mod = getattr(mod, name, None)
                if mod is None:
                    raise KeyError(f"{'.'.join(path)}: the model has no module {name!r}")
            dst = getattr(mod, path[-1], None)
            if not isinstance(dst, torch.Tensor):
                raise KeyError(f"{'.'.join(path)}: the model has no such variable")
            src = torch.from_numpy(np.array(val, np.float32))
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{'.'.join(path)}: shape {tuple(src.shape)} != "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src)
    return model
