"""SSDLite-MobileNetV2: the quantized feature net and the float head
(``frostnet_tpu/detection/models.py:41-133``).

The feature net is QuantStub -> the MobileNetV2 trunk (its last two stages
dilated, stride 1) -> ``final_conv`` (1280) -> the grouped extras -> six
dequantized sources: 38x38x32 (after the third stage), 19x19x1280,
10x10x128, 5x5x128, 3x3x128 and 1x1x128 at 300x300. The extras alternate a
1x1 conv (to 32) and a 3x3 depthwise conv with a channel multiplier of 4
(32 -> 128, stride 2), each followed by a ReLU on the codes (``_relu_q``),
and end in a 3x3 average pool. The head is float in every phase, as the
reference leaves it (``quantized=False``): one 3x3 ConvBN pair per source,
loc (4 a prior) and conf (``num_classes`` a prior), its convs in float32
with TF32 off on the card.

Module and variable names are the JAX package's (``quant``, ``stem``,
``block{i}``, ``final_conv``, ``extra{k}``; ``loc{i}``, ``conf{i}``), so
``from_jax_variables``, ``export_int8`` and ``load_int8`` work over each
net's tree. ``forward(x, mode, train)`` runs one phase; INT8 runs frozen
(``prepare_int8``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..models.frostnet import make_divisible
from ..nn import FP32, InvertedResidual, QConvBNAct, QuantMode, QuantStub, avg_pool, dequant
from ..nn.blocks import _relu as _relu_q  # max(q, zp) on a QTensor's codes (models.py:91)
from ..quant import QConfig, QNNPACK
from ..quant.qtensor import QParams

# (t, c, n, s, dilation): the last two stages dilated (ssd_qmv2.py:129-137)
SSD_MBV2_SETTINGS = [
    (1, 16, 1, 1, 1),
    (6, 24, 2, 2, 1),
    (6, 32, 3, 2, 1),
    (6, 64, 4, 2, 1),
    (6, 96, 3, 1, 1),
    (6, 160, 3, 1, 2),
    (6, 320, 1, 1, 2),
]
# the extras: 1x1 and grouped 3x3 alternating, then the average pool; the
# head taps extras 1, 3, 5 and 6
EXTRAS_CFG = [32, 128, 32, 128, 32, 128, "P"]
EXTRAS_STRIDES = [1, 2, 1, 2, 1, 2, 1]
EXTRAS_HEAD_POS = (1, 3, 5, 6)
ANCHOR_COUNTS = (4, 6, 6, 6, 4, 4)
SSD_SOURCE_CHANNELS = (32, 1280, 128, 128, 128, 128)


class SSDMobileNetV2Feat(nn.Module):
    """The quantized feature extractor (SSD_MobileNetV2_Feat)."""

    _frozen = False

    def __init__(self, quantized: bool = True, qconfig: QConfig = QNNPACK,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.quantized = quantized
        kw = dict(quantized=quantized, qconfig=qconfig, dtype=dtype)
        if quantized:
            self.quant = QuantStub(qconfig)
        c = make_divisible(32)
        self.stem = QConvBNAct(3, c, 3, strides=2, padding=1, act="relu", **kw)
        self.blocks: List[InvertedResidual] = []
        for si, (t, ch, n, s, d) in enumerate(SSD_MBV2_SETTINGS):
            out_c = make_divisible(ch)
            for i in range(n):
                blk = InvertedResidual(c, out_c, strides=s if i == 0 else 1, expand_ratio=t,
                                       dilation=d, **kw)
                self.add_module(f"block{len(self.blocks)}", blk)
                self.blocks.append(blk)
                c = out_c
            if si == 2:  # the first source: after features[6] (ssd_qmv2.py:229-234)
                self.first_source = len(self.blocks)
        self.final_conv = QConvBNAct(c, 1280, 1, act="relu", **kw)
        self.extras: List[Optional[QConvBNAct]] = []
        in_c, flag = 1280, False
        for k, v in enumerate(EXTRAS_CFG):
            conv = None
            if v != "P":
                stride = EXTRAS_STRIDES[k]
                conv = QConvBNAct(in_c, v, (1, 3)[flag], strides=stride,
                                  padding=(0, 1)[stride == 2], groups=(1, in_c)[flag],
                                  act=None, **kw)
                self.add_module(f"extra{k}", conv)
                in_c = v
            self.extras.append(conv)
            flag = not flag

    def prepare_int8(self, device, image_size: Optional[int] = None) -> None:
        """Freeze every quantized module for INT8 inputs on ``device``."""
        if not self.quantized:
            return
        g: QParams = self.stem.prepare_int8(self.quant.prepare_int8(device), device)
        for blk in self.blocks:
            g = blk.prepare_int8(g, device)
        g = self.final_conv.prepare_int8(g, device)
        for conv in self.extras:
            if conv is not None:  # the ReLU and the pool keep the grid
                g = conv.prepare_int8(g, device)
        self._frozen = True

    def forward(self, x, mode: QuantMode = FP32, train: bool = False) -> List[torch.Tensor]:
        """(B, 300, 300, 3) float images -> the six dequantized sources."""
        if mode.int8 and self.quantized and not self._frozen:
            raise RuntimeError("INT8 runs frozen only: call prepare_int8 first")
        if self.quantized:
            x = self.quant(x, mode)
        x = self.stem(x, mode, train)
        sources = []
        for i, blk in enumerate(self.blocks):
            x = blk(x, mode, train)
            if i + 1 == self.first_source:
                sources.append(x)
        x = self.final_conv(x, mode, train)
        sources.append(x)
        for k, conv in enumerate(self.extras):
            x = avg_pool(x, 3, 3) if conv is None else conv(x, mode, train)
            x = _relu_q(x)  # the feat forward's ReLU on every extra (ssd_qmv2.py:246-249)
            if k in EXTRAS_HEAD_POS:
                sources.append(x)
        return [dequant(s) for s in sources]


class SSDHead(nn.Module):
    """The float loc/conf head (SSD_MobileNetV2_HEAD): a 3x3 ConvBN pair per
    source; returns (loc (B, P, 4), conf (B, P, num_classes))."""

    def __init__(self, in_channels: Sequence[int] = SSD_SOURCE_CHANNELS, num_classes: int = 21,
                 anchor_counts: Sequence[int] = ANCHOR_COUNTS,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.n_sources = len(anchor_counts)
        for i, (c, a) in enumerate(zip(in_channels, anchor_counts)):
            self.add_module(f"loc{i}", QConvBNAct(c, a * 4, 3, padding=1, act=None,
                                                  quantized=False, dtype=dtype))
            self.add_module(f"conf{i}", QConvBNAct(c, a * num_classes, 3, padding=1, act=None,
                                                   quantized=False, dtype=dtype))

    def forward(self, sources, mode: QuantMode = FP32, train: bool = False):
        locs, confs = [], []
        for i, src in enumerate(sources):
            loc = getattr(self, f"loc{i}")(src, mode, train)
            conf = getattr(self, f"conf{i}")(src, mode, train)
            locs.append(loc.reshape(loc.shape[0], -1))
            confs.append(conf.reshape(conf.shape[0], -1))
        b = locs[0].shape[0]
        return (torch.cat(locs, 1).reshape(b, -1, 4),
                torch.cat(confs, 1).reshape(b, -1, self.num_classes))


class Detector(nn.Module):
    """A (feat, head) pair as one module, the trainer's model: parameters,
    buffers and checkpoints under ``feat/...`` and ``head/...``;
    :func:`split_variables` and :func:`join_variables` map between that tree
    and the JAX package's two."""

    def __init__(self, feat: nn.Module, head: nn.Module):
        super().__init__()
        self.feat, self.head = feat, head

    def prepare_int8(self, device, image_size: Optional[int] = None) -> None:
        self.feat.prepare_int8(device)

    def forward(self, x, mode: QuantMode = FP32, train: bool = False):
        """Images -> (loc, conf); the head runs in float in every phase."""
        return self.head(self.feat(x, mode, train), train=train)


def join_variables(feat_vars: dict, head_vars: dict) -> dict:
    """JAX ``(feat_vars, head_vars)`` -> the :class:`Detector`'s tree."""
    cols = set(feat_vars) | set(head_vars)
    return {c: {"feat": feat_vars.get(c, {}), "head": head_vars.get(c, {})} for c in cols}


def split_variables(tree: dict):
    """The :class:`Detector`'s tree -> JAX ``(feat_vars, head_vars)``."""
    return tuple({c: v[part] for c, v in tree.items() if v.get(part)}
                 for part in ("feat", "head"))


def build_ssd(num_classes: int = 21, quantized: bool = True, qconfig: QConfig = QNNPACK,
              dtype: torch.dtype = torch.float32):
    """(feat, head) pair (``models.py:124-129``)."""
    return (SSDMobileNetV2Feat(quantized=quantized, qconfig=qconfig, dtype=dtype),
            SSDHead(SSD_SOURCE_CHANNELS, num_classes=num_classes, dtype=dtype))


def load_torch_mobilenet_v2_checkpoint(path_or_state, variables: dict) -> dict:
    """Load a torchvision-format float MobileNetV2 state dict (or a path to
    one) into the :class:`SSDMobileNetV2Feat` variables tree (the trunk and
    ``final_conv``; the extras keep theirs): ``models.py:140-210``.

    Keys ``features.0.{0,1}`` (the stem), ``features.{1..17}.conv.*`` (the
    blocks), ``features.18.{0,1}`` (``final_conv``), an optional ``module.``
    prefix and a ``state_dict`` wrapper; ``classifier.*`` is ignored. Returns
    a new tree with ``params`` and ``batch_stats`` updated; raises if
    nothing matched.
    """
    if isinstance(path_or_state, str):
        ckpt = torch.load(path_or_state, map_location="cpu", weights_only=True)
    else:
        ckpt = path_or_state
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    state = {}
    for k, v in ckpt.items():
        k = k[len("module."):] if k.startswith("module.") else k
        state[k] = np.array(v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v)

    def copy(tree):
        return {k: copy(v) if isinstance(v, dict) else v for k, v in tree.items()}

    params = copy(variables["params"])
    batch_stats = copy(variables.get("batch_stats", {}))

    def node(tree, dst: str):
        for part in dst.split("/"):
            tree = tree.setdefault(part, {})
        return tree

    def put_convbn(dst: str, conv_key: str, bn_key: str) -> int:
        w = state.get(conv_key + ".weight")
        if w is None:
            return 0
        p = node(params, dst)
        p["kernel"] = np.ascontiguousarray(w.transpose(2, 3, 1, 0)).astype(np.float32)
        p["scale"] = state[bn_key + ".weight"].astype(np.float32)
        p["bias_bn"] = state[bn_key + ".bias"].astype(np.float32)
        b = node(batch_stats, dst)
        b["mean"] = state[bn_key + ".running_mean"].astype(np.float32)
        b["var"] = state[bn_key + ".running_var"].astype(np.float32)
        return 5

    loaded = put_convbn("stem", "features.0.0", "features.0.1")
    bidx = 0
    for (t, _, n_blocks, _, _) in SSD_MBV2_SETTINGS:
        for _ in range(n_blocks):
            f, blk = f"features.{bidx + 1}", f"block{bidx}"
            if t == 1:
                loaded += put_convbn(blk + "/dw", f + ".conv.0.0", f + ".conv.0.1")
                loaded += put_convbn(blk + "/project", f + ".conv.1", f + ".conv.2")
            else:
                loaded += put_convbn(blk + "/expand", f + ".conv.0.0", f + ".conv.0.1")
                loaded += put_convbn(blk + "/dw", f + ".conv.1.0", f + ".conv.1.1")
                loaded += put_convbn(blk + "/project", f + ".conv.2", f + ".conv.3")
            bidx += 1
    loaded += put_convbn("final_conv", "features.18.0", "features.18.1")
    if loaded == 0:
        raise ValueError("no weights matched: is this a MobileNetV2 checkpoint?")
    return {**variables, "params": params, "batch_stats": batch_stats}
