"""Tiny-DSOD: the quantized feature net and the float head
(``frostnet_tpu/detection/tdsod.py``).

The depthwise stem, four dense stages of ``_DwdBlock`` (1x1 ConvBN + 3x3
depthwise ConvBN) joined by observed cats, the downsampling path (a ceil-mode
max pool and 1x1 conv beside a 1x1 and strided depthwise conv, joined by a
cat) and the upsampling path: each source dequantized, resized bilinearly
(``align_corners=False``), quantized again on its own grid (the QuantStub
``requant_up{i}``), a depthwise conv, and an observed add with the map it
joins (``qadd{i}``). Six dequantized sources of 128 channels at 38, 19, 10,
5, 3 and 2 pixels (300x300). The head is ``SSDHead`` under the name
``head``.

In INT8 what the frozen JAX graph computes at each hazard:

* ``_maxpool_ceil`` pads the codes (or floats) by repeating the last row and
  column, then takes the 2x2 max: exact;
* the crop of a QTensor keeps its grid;
* the resize is ``ops.resize.resize_bilinear`` on the dequantized codes (no
  output side is a multiple of 64: each tap's product rounds, then their
  sum), then ``requant_up{i}`` rounds ``y * f32(1/s)``;
* each ``qadd{i}`` rounds as its XLA fusion does: both operands' codes are
  made in the fusion where ``QADD_LOADED`` names no operand (``qadd1`` to
  ``qadd4``), else the loaded operand's product is contracted into the sum
  (``qadd5``: its second operand, ``infeat_1``; ``ops.requant.qadd_codes``;
  ``tests/test_torch_det_layers.py`` reads it from the frozen graph's HLO).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from ..nn import FP32, QAdd, QCat, QConvBNAct, QuantMode, QuantStub, dequant, max_pool
from ..ops import resize
from ..quant import QConfig, QNNPACK
from ..quant.qtensor import QParams, QTensor
from .models import ANCHOR_COUNTS, SSDHead

# (blocks, growth) of the four dense stages
DENSE_STAGES = ((4, 32), (6, 48), (6, 64), (6, 80))
TDSOD_SOURCE_CHANNELS = (128,) * 6
# which operand of each qadd{i} its fusion loads from memory, read from the
# frozen graph's optimized HLO at 96x96 and 300x300: only qadd5's second,
# infeat_1 (the ceil-mode max pool's output); the other joins make both
QADD_LOADED = {5: 1}


def _shape(x):
    return (x.q if isinstance(x, QTensor) else x).shape


def _edge_pad(t: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Pad NHWC ``t`` at the bottom and right by repeating its last row and
    column (``jnp.pad(mode="edge")``), any dtype."""
    if ph:
        t = torch.cat([t, t[:, -1:].expand(-1, ph, -1, -1)], dim=1)
    if pw:
        t = torch.cat([t, t[:, :, -1:].expand(-1, -1, pw, -1)], dim=2)
    return t


def _maxpool_ceil(x, k: int = 2, s: int = 2):
    """MaxPool2d(ceil_mode=True) (``tdsod.py:28``): edge-pad the bottom and
    right so that the last window covers the trailing row and column."""
    h, w = _shape(x)[1], _shape(x)[2]
    ph = (-h) % s if h % s else 0
    pw = (-w) % s if w % s else 0
    if ph or pw:
        if isinstance(x, QTensor):
            x = QTensor(_edge_pad(x.q, ph, pw), x.scale, x.zero_point)
        else:
            x = _edge_pad(x, ph, pw)
    return max_pool(x, k, s)


def _crop(t, h: int, w: int):
    if isinstance(t, QTensor):
        return QTensor(t.q[:, :h, :w], t.scale, t.zero_point)
    return t[:, :h, :w]


class _DwdBlock(nn.Module):
    """1x1 ConvBN + depthwise 3x3 ConvBN, both ReLU (qtdsod.py:77-93)."""

    def __init__(self, inp: int, oup: int, **kw):
        super().__init__()
        self.dwd1 = QConvBNAct(inp, oup, 1, padding=0, act="relu", **kw)
        self.dwd2 = QConvBNAct(oup, oup, 3, padding=1, groups=oup, act="relu", **kw)

    def prepare_int8(self, g: QParams, device) -> QParams:
        return self.dwd2.prepare_int8(self.dwd1.prepare_int8(g, device), device)

    def forward(self, x, mode: QuantMode, train: bool):
        return self.dwd2(self.dwd1(x, mode, train), mode, train)


class TDSODFeat(nn.Module):
    """QSSD_TDSOD_Feat (qtdsod.py:204-447)."""

    _frozen = False

    def __init__(self, quantized: bool = True, qconfig: QConfig = QNNPACK,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.quantized = quantized
        kw = dict(quantized=quantized, qconfig=qconfig, dtype=dtype)

        def conv(name, i, o, k, s, p, g, act):
            self.add_module(name, QConvBNAct(i, o, k, strides=s, padding=p, groups=g, act=act,
                                             **kw))

        def observed(name, cls):
            if quantized:
                self.add_module(name, cls(qconfig))

        if quantized:
            self.quant = QuantStub(qconfig)
        conv("base1", 3, 64, 3, 2, 1, 1, "relu")
        conv("base2", 64, 64, 1, 1, 0, 1, "relu")
        conv("base3", 64, 64, 3, 1, 1, 64, "relu")
        conv("base4", 64, 128, 1, 1, 0, 1, "relu")
        conv("base5", 128, 128, 3, 1, 1, 128, "relu")
        c = 128
        for si, (n, g) in enumerate(DENSE_STAGES):
            for it in range(n):
                self.add_module(f"ddb{si}_{it}", _DwdBlock(c, g, **kw))
                observed(f"qcat_ddb{si}_{it}", QCat)
                c += g
            trans = (("trans0_conv", 128), ("trans1_conv", 128), ("trans2", 256),
                     ("trans3", 64))[si]
            conv(trans[0], c, trans[1], 1, 1, 0, 1, "relu")
            c = trans[1]
        # the down path: of infeat_1 (128 channels) into qcat0, of s0 (192)
        # into qcat2, of s1-s3 (128) into qcat3-qcat5; qcat1 joins the crops
        for i, cin in enumerate((128, 192, 128, 128, 128)):
            conv(f"downfeat0_{i}", cin, 64, 1, 1, 0, 1, "relu")
            self.add_module(f"downfeat1_{i}a", QConvBNAct(cin, 64, 1, padding=0, act=None, **kw))
            conv(f"downfeat1_{i}b", 64, 64, 3, 2, 1, 64, "relu")
            observed(f"qcat{i + 1 if i else 0}", QCat)
            if i == 0:
                observed("qcat1", QCat)
        for i in range(5):
            observed(f"requant_up{i}", QuantStub)
            conv(f"upfeat{i}", 128, 128, 3, 1, 1, 128, "relu")
            observed(f"qadd{i + 1}", QAdd)

    # the graph, written once for the forward and once for the freeze
    def _down(self, x, i: int, mode, train):
        y0 = getattr(self, f"downfeat0_{i}")(_maxpool_ceil(x), mode, train)
        y1 = getattr(self, f"downfeat1_{i}a")(x, mode, train)
        return [y0, getattr(self, f"downfeat1_{i}b")(y1, mode, train)]

    def _cat(self, xs, name: str, mode):
        return getattr(self, name)(xs, mode) if self.quantized else torch.cat(xs, dim=-1)

    def prepare_int8(self, device, image_size: Optional[int] = None) -> None:
        """Freeze every quantized module for INT8 inputs on ``device``."""
        if not self.quantized:
            return

        def p(name, g):
            return getattr(self, name).prepare_int8(g, device)

        g = self.quant.prepare_int8(device)
        for name in ("base1", "base2", "base3", "base4", "base5"):
            g = p(name, g)
        for si, (n, _) in enumerate(DENSE_STAGES):
            for it in range(n):
                g = getattr(self, f"qcat_ddb{si}_{it}").prepare_int8(
                    [g, p(f"ddb{si}_{it}", g)], device)
            g = p(("trans0_conv", "trans1_conv", "trans2", "trans3")[si], g)
            if si == 0:
                infeat_1 = g
        infeat_2 = g

        def down(g, i, cat):
            parts = [p(f"downfeat0_{i}", g), p(f"downfeat1_{i}b", p(f"downfeat1_{i}a", g))]
            return getattr(self, cat).prepare_int8(parts, device)

        infeat_3 = down(infeat_1, 0, "qcat0")
        s = [self.qcat1.prepare_int8([infeat_3, infeat_2], device)]
        for i in range(1, 5):
            s.append(down(s[-1], i, f"qcat{i + 1}"))
        u = s[4]
        for i, tgt in enumerate([s[3], s[2], s[1], infeat_3, infeat_1]):
            up = p(f"upfeat{i}", getattr(self, f"requant_up{i}").prepare_int8(device))
            add = getattr(self, f"qadd{i + 1}")
            u = add.prepare_int8([up, tgt], device, loaded=_loaded(QADD_LOADED.get(i + 1)))
        self._frozen = True

    def forward(self, x, mode: QuantMode = FP32, train: bool = False) -> List[torch.Tensor]:
        """(B, 300, 300, 3) float images -> the six dequantized sources."""
        if mode.int8 and self.quantized and not self._frozen:
            raise RuntimeError("INT8 runs frozen only: call prepare_int8 first")
        if self.quantized:
            x = self.quant(x, mode)
        for name in ("base1", "base2", "base3", "base4", "base5"):
            x = getattr(self, name)(x, mode, train)
        x = max_pool(x, 2, 2)
        for si, (n, _) in enumerate(DENSE_STAGES):
            for it in range(n):
                blk = getattr(self, f"ddb{si}_{it}")(x, mode, train)
                x = self._cat([x, blk], f"qcat_ddb{si}_{it}", mode)
            x = getattr(self, ("trans0_conv", "trans1_conv", "trans2", "trans3")[si])(
                x, mode, train)
            if si < 2:
                x = _maxpool_ceil(x)
            if si == 0:
                infeat_1 = x
        infeat_2 = x
        infeat_3 = self._cat(self._down(infeat_1, 0, mode, train), "qcat0", mode)
        h, w = _shape(infeat_3)[1], _shape(infeat_3)[2]
        s = [self._cat([_crop(infeat_3, h, w), _crop(infeat_2, h, w)], "qcat1", mode)]
        for i in range(1, 5):
            s.append(self._cat(self._down(s[-1], i, mode, train), f"qcat{i + 1}", mode))
        sources = [s[4]]
        u = s[4]
        for i, tgt in enumerate([s[3], s[2], s[1], infeat_3, infeat_1]):
            y = resize.resize_bilinear(dequant(u), tuple(_shape(tgt)[1:3]), align_corners=False)
            if self.quantized:
                y = getattr(self, f"requant_up{i}")(y, mode)
            y = getattr(self, f"upfeat{i}")(y, mode, train)
            u = getattr(self, f"qadd{i + 1}")(y, tgt, mode) if self.quantized else y + tgt
            sources.append(u)
        return [dequant(t) for t in sources[::-1]]


def _loaded(which: Optional[int]):
    return tuple(i == which for i in range(2))


class TDSODHead(nn.Module):
    """QSSD_TDSOD_HEAD (qtdsod.py:449-514): ``SSDHead`` under ``head``."""

    def __init__(self, num_classes: int = 21, anchor_counts: Sequence[int] = ANCHOR_COUNTS,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.head = SSDHead(TDSOD_SOURCE_CHANNELS, num_classes, anchor_counts, dtype)

    def forward(self, sources, mode: QuantMode = FP32, train: bool = False):
        return self.head(sources, mode, train)


def build_tdsod(num_classes: int = 21, quantized: bool = True, qconfig: QConfig = QNNPACK,
                dtype: torch.dtype = torch.float32):
    """(feat, head) pair (qtdsod.py:516+)."""
    return (TDSODFeat(quantized=quantized, qconfig=qconfig, dtype=dtype),
            TDSODHead(num_classes=num_classes, dtype=dtype))
