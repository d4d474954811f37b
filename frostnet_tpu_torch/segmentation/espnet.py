"""ESPNetv2 and ESPNet (``frostnet_tpu/segmentation/espnet.py``).

Module and variable names are the JAX package's, so its variable trees and
INT8 artifacts fill these models:

* :class:`EESP`: a grouped 1x1 reduce (``proj_1x1``, ``groups=k``), ``k``
  depthwise 3x3 branches ``spp_dw{i}`` (dilations from the receptive-field
  limit ``r_lim``, strided in a down-sampler, no BN), joined
  hierarchically by observed adds ``quant_add{i}``, an observed
  ``quant_cat``, ``br_after_cat`` (1x1, ReLU) and the grouped 1x1 expand
  ``conv_1x1_exp``; then an observed ``skip_add`` of the input where the
  shapes allow, and a ReLU (none in a down-sampler).
* :class:`DownSampler`: the strided EESP beside a 3x3/2 average pool of the
  input, concatenated; with the input reinforcement ``inp_reinf0`` (3x3,
  3 -> 3) and ``inp_reinf1`` (1x1) on the raw image, average-pooled down to
  the output's size, added by ``skip_add``; then a ReLU.
* :class:`EESPNet`: the ESPNetv2 trunk and, as a classifier, its head
  (``level5_*``, a float mean, dropout, ``classifier_kernel``).
* :class:`PSPModule`, :class:`ESPNetv2Seg`: the pyramid pooling and the
  ESPNetv2 segmentation model (a float 1x1 ``classifier`` and a 2x resize
  after the quant region).
* :class:`ESPBlock`, :class:`ESPNetSeg`: ESPNet (v1).

Numerics of the frozen graph, as the JAX program computes them:

* :func:`avg_pool_3x3_s2` on codes pads with code 0 (not the zero point) and
  divides by 9 (``count_include_pad``): the float sum times ``f32(1/9)``,
  rounded half to even, clipped to 0..255.
* Each observed add rounds as the frozen graph's fusion does
  (``ops.requant.qadd_codes``): ``QADD_LOADED`` names the adds whose
  operand codes that fusion loads from memory (read from XLA's optimized
  HLO, ``tests/test_torch_espnet.py``).
* In INT8 the ``proj_1x1`` and ``conv_1x1_exp`` grouped 1x1s take the
  ``grouped`` route, the depthwise branches the depthwise route, ESPBlock's
  dilated 3x3s the im2col matmul (dilation 1: the dense conv kernel), the
  reinforcement's 3x3 the dense conv kernel at 3 -> 3.

The ESPNetv2 classifier (``seg=False``) has no INT8 forward, as the JAX
model has none: ``level5_0`` gets no raw image, so it runs its
reinforcement convs on a float (1, 1, 1, 3) zeros tensor (``espnet.py:138``)
to make their variables, and INT8 needs a QTensor there
(``frostnet_tpu/nn/conv.py:374``). That call still moves the BN statistics
in train mode and the observers in QAT, and the port repeats it.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..models.frostnet import dropout
from ..nn import (FP32, QAdd, QCat, QConvBNAct, QuantMode, QuantStub, dequant)
from ..nn.blocks import spatial_mean
from ..ops.requant import reciprocal
from ..ops import resize
from ..quant import QConfig, QNNPACK
from ..quant.qtensor import QParams, QTensor

CLASSIFIER_INT8 = (
    "the ESPNetv2 classifier (espnetv2_s_*) has no INT8 forward: level5_0 runs its "
    "reinforcement convs on a float zeros tensor (frostnet_tpu/segmentation/espnet.py:138) "
    "and INT8 needs a QTensor there (frostnet_tpu/nn/conv.py:374, 'INT8 mode needs a QTensor "
    "input'); the JAX model fails the same way (ROADMAP.md, Queue C)")

# receptive field -> dilation of a 3x3 branch (espnetv2.py:48)
DILATION = {3: 1, 5: 2, 7: 3, 9: 4, 11: 5, 13: 6, 15: 7, 17: 8}

# The observed adds whose frozen-graph fusion loads an operand's codes from
# memory, by module path: {path: (first loaded, second loaded)}; every other
# add makes both in its fusion (read from XLA's optimized HLO).
QADD_LOADED = {}


def _shape(x):
    return tuple((x.q if isinstance(x, QTensor) else x).shape)


def relu(x):
    """ReLU of a float, or of a QTensor's codes (clamped at its zero point)."""
    if isinstance(x, QTensor):
        return QTensor(torch.maximum(x.q, x.zero_point.to(torch.uint8)), x.scale, x.zero_point)
    return torch.relu(x)


def avg_pool_3x3_s2(x):
    """``F.avg_pool2d(3, 2, padding=1, count_include_pad=True)`` over NHWC.

    A QTensor keeps its grid: the window sums of its codes with code 0 in
    the padding (exact), times ``f32(1/9)``, rounded half to even and
    clipped to 0..255. A float tensor: the float32 window sums (each exact
    in float64, rounded once) times ``f32(1/9)``.
    """
    xt = (x.q if isinstance(x, QTensor) else x).permute(0, 3, 1, 2)
    s = F.avg_pool2d(xt.to(torch.float64), 3, 2, 1, divisor_override=1)
    m = s.to(torch.float32).permute(0, 2, 3, 1) * torch.full((), reciprocal(9.0),
                                                             device=s.device)
    if isinstance(x, QTensor):
        q = torch.clamp(torch.round(m), 0, 255).to(x.q.dtype)
        return QTensor(q.contiguous(), x.scale, x.zero_point)
    return m.to(x.dtype)


def _add(mod: Optional[QAdd], a, b, mode: QuantMode):
    return mod(a, b, mode) if mod is not None else a + b


def _cat(mod: Optional[QCat], xs: Sequence, mode: QuantMode):
    if mod is not None:
        return mod(xs, mode)
    return torch.cat([dequant(x) for x in xs], dim=-1)


def _prepare_add(mod: QAdd, path: str, grids, device) -> QParams:
    return mod.prepare_int8(grids, device, loaded=QADD_LOADED.get(path, (False, False)))


class EESP(nn.Module):
    """REDUCE (grouped 1x1) -> SPLIT -> TRANSFORM (k dilated depthwise
    branches, joined by observed adds) -> MERGE (concat, 1x1, grouped 1x1)."""

    def __init__(self, in_channels: int, out_channels: int, strides: int = 1, k: int = 4,
                 r_lim: int = 7, down_method: str = "esp", quantized: bool = True,
                 qconfig: QConfig = QNNPACK, dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(quantized=quantized, qconfig=qconfig, dtype=dtype)
        n = out_channels // k
        if n * k != out_channels:
            raise ValueError("nOut must divide k")
        self.strides, self.down_method, self.quantized = strides, down_method, quantized
        ksizes = sorted(min(3 + 2 * i, r_lim) if (3 + 2 * i) <= r_lim else 3 for i in range(k))
        self.proj_1x1 = QConvBNAct(in_channels, n, 1, groups=k, act="relu", **kw)
        self.branches: List[QConvBNAct] = []
        self.adds: List[Optional[QAdd]] = []
        for i, ks in enumerate(ksizes):
            d = DILATION[ks]
            conv = QConvBNAct(n, n, 3, strides=strides, padding=d, dilation=d, groups=n,
                              act=None, use_bn=False, **kw)
            self.add_module(f"spp_dw{i}", conv)
            self.branches.append(conv)
            if i > 0 and quantized:
                self.add_module(f"quant_add{i}", QAdd(qconfig))
            self.adds.append(getattr(self, f"quant_add{i}", None))
        self.quant_cat = QCat(qconfig) if quantized else None
        self.br_after_cat = QConvBNAct(out_channels, out_channels, 1, act="relu", **kw)
        self.conv_1x1_exp = QConvBNAct(out_channels, out_channels, 1, groups=k, act=None, **kw)
        self.avg_out = strides == 2 and down_method == "avg"
        self.has_skip = not self.avg_out and strides == 1 and in_channels == out_channels
        self.skip_add = QAdd(qconfig) if quantized and self.has_skip else None

    def prepare_int8(self, x: QParams, device, path: str = "") -> QParams:
        proj = self.proj_1x1.prepare_int8(x, device)
        outs, prev = [], None
        for i, (conv, add) in enumerate(zip(self.branches, self.adds)):
            b = conv.prepare_int8(proj, device)
            if i > 0:
                b = _prepare_add(add, f"{path}quant_add{i}", [b, prev], device)
            outs.append(b)
            prev = b
        g = self.quant_cat.prepare_int8(outs, device)
        g = self.conv_1x1_exp.prepare_int8(self.br_after_cat.prepare_int8(g, device), device)
        if self.has_skip:
            g = _prepare_add(self.skip_add, f"{path}skip_add", [g, x], device)
        return g

    def forward(self, x, mode: QuantMode = FP32, train: bool = False):
        proj = self.proj_1x1(x, mode, train)
        outputs, prev = [], None
        for i, (conv, add) in enumerate(zip(self.branches, self.adds)):
            b = conv(proj, mode, train)
            if i > 0:
                b = _add(add, b, prev, mode)
            outputs.append(b)
            prev = b
        merged = self.br_after_cat(_cat(self.quant_cat, outputs, mode), mode, train)
        expanded = self.conv_1x1_exp(merged, mode, train)
        if self.avg_out:
            return expanded
        if self.has_skip:
            expanded = _add(self.skip_add, expanded, x, mode)
        return relu(expanded)


class DownSampler(nn.Module):
    """A 3x3/2 average pool beside the strided EESP, concatenated, with the
    raw-image reinforcement (when ``reinf``; ``raw_input=False`` for the
    classifier's ``level5_0``, which gets no raw image), then a ReLU."""

    def __init__(self, in_channels: int, out_channels: int, k: int = 4, r_lim: int = 9,
                 reinf: bool = True, raw_input: bool = True, quantized: bool = True,
                 qconfig: QConfig = QNNPACK, dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(quantized=quantized, qconfig=qconfig, dtype=dtype)
        self.reinf, self.quantized = reinf, quantized
        self.eesp = EESP(in_channels, out_channels - in_channels, strides=2, k=k, r_lim=r_lim,
                         down_method="avg", **kw)
        self.quant_cat = QCat(qconfig) if quantized else None
        if reinf:
            self.inp_reinf0 = QConvBNAct(3, 3, 3, padding=1, act="relu", **kw)
            self.inp_reinf1 = QConvBNAct(3, out_channels, 1, act=None, **kw)
            # the classifier's level5_0 gets no raw image (``raw_input``
            # False): JAX then makes no skip_add
            self.skip_add = QAdd(qconfig) if quantized and raw_input else None

    def prepare_int8(self, x: QParams, raw: Optional[QParams], device, path: str = "") -> QParams:
        g = self.quant_cat.prepare_int8([x, self.eesp.prepare_int8(x, device, f"{path}eesp/")],
                                        device)
        if self.reinf:
            if raw is None:
                raise NotImplementedError(CLASSIFIER_INT8)
            r = self.inp_reinf1.prepare_int8(self.inp_reinf0.prepare_int8(raw, device), device)
            g = _prepare_add(self.skip_add, f"{path}skip_add", [g, r], device)
        return g

    def forward(self, x, input2=None, mode: QuantMode = FP32, train: bool = False):
        eesp_out = self.eesp(x, mode, train)
        out = _cat(self.quant_cat, [avg_pool_3x3_s2(x), eesp_out], mode)
        if self.reinf:
            if input2 is not None:
                while _shape(input2)[1] > _shape(out)[1]:
                    input2 = avg_pool_3x3_s2(input2)
                r = self.inp_reinf1(self.inp_reinf0(input2, mode, train), mode, train)
                out = _add(self.skip_add, out, r, mode)
            else:
                # JAX runs the reinforcement on zeros here to make its
                # variables (espnet.py:138): BN statistics and observers move
                zeros = torch.zeros((1, 1, 1, 3), device=self.inp_reinf0.kernel.device)
                self.inp_reinf1(self.inp_reinf0(zeros, mode, train), mode, train)
        return relu(out)


def eespnet_config(s: float = 1.0) -> List[int]:
    """Channel config per scale factor (espnetv2.py:192-207)."""
    base, k0 = 32, 4
    config = [base] * 5
    base_s = int(math.ceil(int(base * s) / k0) * k0)
    config[0] = base if base_s > base else base_s
    for i in range(1, 5):
        config[i] = base_s * (2 ** i)
    config.append(1280 if s in (1.5, 2) else 1024)
    return config


R_LIM = (13, 11, 9, 7, 5)
REPS = (0, 3, 7, 3)


class EESPNet(nn.Module):
    """The ESPNetv2 trunk. ``seg=True`` builds the segmentation trunk
    (``level1`` to ``level4_*``; ``forward`` returns the four levels);
    otherwise the classifier, whose head is ``level5_0`` (no reinforcement
    input), ``level5_blk*``, ``level5_dw``, the grouped ``level5_exp``, a
    float mean, dropout and the dense ``classifier_kernel``."""

    def __init__(self, num_classes: int = 1000, s: float = 1.0, drop_rate: float = 0.2,
                 quantized: bool = True, input_stub: bool = True, seg: bool = False,
                 qconfig: QConfig = QNNPACK, fuse_int8: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if fuse_int8:
            raise ValueError("fuse_int8 is FrostNet-only: ESPNetv2 has no fused INT8 block")
        kw = dict(quantized=quantized, qconfig=qconfig, dtype=dtype)
        self.num_classes, self.drop_rate, self.quantized, self.seg = (num_classes, drop_rate,
                                                                      quantized, seg)
        self.input_stub = input_stub
        config = self.config = eespnet_config(s)
        if quantized and input_stub:
            self.quant = QuantStub(qconfig)
        self.level1 = QConvBNAct(3, config[0], 3, strides=2, padding=1, act="relu", **kw)
        self.level2_0 = DownSampler(config[0], config[1], r_lim=R_LIM[0], **kw)
        self.level3_0 = DownSampler(config[1], config[2], r_lim=R_LIM[1], **kw)
        self.level3 = self._blocks("level3_blk", REPS[1], config[2], R_LIM[2], kw)
        self.level4_0 = DownSampler(config[2], config[3], r_lim=R_LIM[2], **kw)
        self.level4 = self._blocks("level4_blk", REPS[2], config[3], R_LIM[3], kw)
        if seg:
            return
        self.level5_0 = DownSampler(config[3], config[4], r_lim=R_LIM[3], raw_input=False, **kw)
        self.level5 = self._blocks("level5_blk", REPS[3], config[4], R_LIM[4], kw)
        self.level5_dw = QConvBNAct(config[4], config[4], 3, padding=1, groups=config[4],
                                    act="relu", **kw)
        self.level5_exp = QConvBNAct(config[4], config[5], 1, groups=4, act="relu", **kw)
        self.classifier_kernel = nn.Parameter(torch.zeros(config[5], num_classes))
        self.classifier_bias = nn.Parameter(torch.zeros(num_classes))

    def _blocks(self, prefix: str, n: int, c: int, r_lim: int, kw) -> List[EESP]:
        blocks = []
        for i in range(n):
            blk = EESP(c, c, r_lim=r_lim, **kw)
            self.add_module(f"{prefix}{i}", blk)
            blocks.append(blk)
        return blocks

    def prepare_trunk(self, x: QParams, device, path: str = "") -> List[QParams]:
        """Freeze ``level1`` to ``level4_*`` for the raw image's grid ``x``;
        returns the grids of the four levels."""
        l1 = self.level1.prepare_int8(x, device)
        l2 = self.level2_0.prepare_int8(l1, x, device, f"{path}level2_0/")
        g = self.level3_0.prepare_int8(l2, x, device, f"{path}level3_0/")
        for i, blk in enumerate(self.level3):
            g = blk.prepare_int8(g, device, f"{path}level3_blk{i}/")
        l3 = g
        g = self.level4_0.prepare_int8(l3, x, device, f"{path}level4_0/")
        for i, blk in enumerate(self.level4):
            g = blk.prepare_int8(g, device, f"{path}level4_blk{i}/")
        return [l1, l2, l3, g]

    def prepare_int8(self, device, image_size: int = 224) -> None:
        if self.quantized:
            raise NotImplementedError(CLASSIFIER_INT8)

    def trunk(self, x, mode: QuantMode, train: bool):
        raw = x
        l1 = self.level1(x, mode, train)
        l2 = self.level2_0(l1, raw, mode, train)
        l3 = self.level3_0(l2, raw, mode, train)
        for blk in self.level3:
            l3 = blk(l3, mode, train)
        l4 = self.level4_0(l3, raw, mode, train)
        for blk in self.level4:
            l4 = blk(l4, mode, train)
        return l1, l2, l3, l4

    def forward(self, x, mode: QuantMode = FP32, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """The classifier: (B, S, S, 3) images -> (B, num_classes) float
        logits; the segmentation trunk: the four levels."""
        if mode.int8 and self.quantized and not self.seg:
            raise NotImplementedError(CLASSIFIER_INT8)
        if self.quantized and self.input_stub:
            x = self.quant(x, mode)
        levels = self.trunk(x, mode, train)
        if self.seg:
            return levels
        l5 = self.level5_0(levels[3], None, mode, train)
        for blk in self.level5:
            l5 = blk(l5, mode, train)
        l5 = self.level5_exp(self.level5_dw(l5, mode, train), mode, train)
        pooled = spatial_mean(dequant(l5))
        if train and self.drop_rate > 0:
            pooled = dropout(pooled, self.drop_rate, generator)
        return pooled @ self.classifier_kernel + self.classifier_bias


class PSPModule(nn.Module):
    """Pyramid pooling: ``n_stages`` progressive 3x3/2 average pools, each
    followed by a depthwise 3x3 (``stage{i}``, no BN), dequantized and
    resized (align_corners) to the input's size; the input and the four
    maps (floats) concatenated by an observed ``quant_cat``; a 1x1
    ``project`` (ReLU)."""

    def __init__(self, in_channels: int, out_features: int, n_stages: int = 4,
                 quantized: bool = True, qconfig: QConfig = QNNPACK,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(quantized=quantized, qconfig=qconfig, dtype=dtype)
        self.stages = []
        for i in range(n_stages):
            conv = QConvBNAct(in_channels, in_channels, 3, padding=1, groups=in_channels,
                              act=None, use_bn=False, **kw)
            self.add_module(f"stage{i}", conv)
            self.stages.append(conv)
        self.quant_cat = QCat(qconfig) if quantized else None
        self.project = QConvBNAct(in_channels * (n_stages + 1), out_features, 1, act="relu", **kw)

    def prepare_int8(self, x: QParams, device) -> QParams:
        for conv in self.stages:
            conv.prepare_int8(x, device)  # the pools keep the input's grid
        g = self.quant_cat.prepare_int8([None] * (len(self.stages) + 1), device)
        return self.project.prepare_int8(g, device)

    def forward(self, x, mode: QuantMode = FP32, train: bool = False):
        h, w = _shape(x)[1:3]
        feats, outs = x, [dequant(x)]
        for conv in self.stages:
            feats = avg_pool_3x3_s2(feats)
            outs.append(resize.resize_bilinear(dequant(conv(feats, mode, train)), (h, w)))
        return self.project(_cat(self.quant_cat, outs, mode), mode, train)


class _QuantRegionTail(nn.Module):
    """What the two ESPNet segmentation models share."""

    def _up(self, x, size, stub: Optional[QuantStub], mode: QuantMode):
        """Dequantize, resize (align_corners), requantize on ``stub``'s grid."""
        y = resize.resize_bilinear(dequant(x), size)
        return stub(y, mode) if stub is not None else y

    def _stub(self, qconfig: QConfig) -> Optional[QuantStub]:
        return QuantStub(qconfig) if self.quantized else None


class ESPNetv2Seg(_QuantRegionTail):
    """ESPNetv2 segmentation (the quant region: the trunk, ``proj_L4_C``,
    the PSP cascade ``pspMod_eesp``/``pspMod_psp``, ``project_l3``,
    ``act_l3``, ``project_l2`` with their resizes and requant stubs and the
    concats ``quant_cat1``-``quant_cat3``; then the float 1x1 ``classifier``
    and a 2x resize)."""

    def __init__(self, num_classes: int = 20, s: float = 1.0, quantized: bool = True,
                 qconfig: QConfig = QNNPACK, dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(quantized=quantized, qconfig=qconfig, dtype=dtype)
        self.num_classes, self.quantized = num_classes, quantized
        nc = num_classes
        if quantized:
            self.quant = QuantStub(qconfig)
        self.net = EESPNet(s=s, input_stub=False, seg=True, **kw)
        c = self.net.config
        l3_c = c[2]
        self.proj_L4_C = QConvBNAct(c[3], l3_c, 1, act="relu", **kw)
        self.requant_l4 = self._stub(qconfig)
        self.quant_cat1 = QCat(qconfig) if quantized else None
        self.pspMod_eesp = EESP(2 * l3_c, l3_c, k=4, r_lim=7, **kw)
        self.pspMod_psp = PSPModule(l3_c, l3_c, **kw)
        self.project_l3 = QConvBNAct(l3_c, nc, 1, act="relu", **kw)
        self.act_l3 = QConvBNAct(nc, nc, 1, act="relu", **kw)
        self.requant_l3 = self._stub(qconfig)
        self.quant_cat2 = QCat(qconfig) if quantized else None
        self.project_l2 = QConvBNAct(c[1] + nc, nc, 1, act="relu", **kw)
        self.requant_l2 = self._stub(qconfig)
        self.quant_cat3 = QCat(qconfig) if quantized else None
        self.classifier = QConvBNAct(c[0] + nc, nc, 1, use_bn=False, use_bias=False, act=None,
                                     quantized=False)

    def prepare_int8(self, device, image_size: Optional[int] = None) -> None:
        """Freeze the quant region for INT8 on ``device``."""
        if not self.quantized:
            return
        l1, l2, l3, l4 = self.net.prepare_trunk(self.quant.prepare_int8(device), device, "net/")
        self.proj_L4_C.prepare_int8(l4, device)
        g = self.quant_cat1.prepare_int8([l3, self.requant_l4.prepare_int8(device)], device)
        g = self.pspMod_psp.prepare_int8(self.pspMod_eesp.prepare_int8(g, device, "pspMod_eesp/"),
                                         device)
        self.act_l3.prepare_int8(self.project_l3.prepare_int8(g, device), device)
        g = self.quant_cat2.prepare_int8([l2, self.requant_l3.prepare_int8(device)], device)
        self.project_l2.prepare_int8(g, device)
        self.quant_cat3.prepare_int8([l1, self.requant_l2.prepare_int8(device)], device)

    def forward(self, x: torch.Tensor, mode: QuantMode = FP32, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, H, W, 3) float images -> (B, H, W, num_classes) float logits."""
        if self.quantized:
            x = self.quant(x, mode)
        l1, l2, l3, l4 = self.net(x, mode, train)
        l4u = self._up(self.proj_L4_C(l4, mode, train), _shape(l3)[1:3], self.requant_l4, mode)
        merged = self.pspMod_eesp(_cat(self.quant_cat1, [l3, l4u], mode), mode, train)
        merged = self.pspMod_psp(merged, mode, train)
        p3 = self.act_l3(self.project_l3(merged, mode, train), mode, train)
        p3u = self._up(p3, _shape(l2)[1:3], self.requant_l3, mode)
        m2 = self.project_l2(_cat(self.quant_cat2, [l2, p3u], mode), mode, train)
        m2u = self._up(m2, _shape(l1)[1:3], self.requant_l2, mode)
        out = self.classifier(dequant(_cat(self.quant_cat3, [l1, m2u], mode)), mode, train)
        h, w = out.shape[1:3]
        return resize.resize_bilinear(out, (h * 2, w * 2))


class ESPBlock(nn.Module):
    """ESPNet's DilatedParllelResidualBlockB: a reduce ``c1`` (1x1, or 3x3/2
    in a down-sampler; no BN), five dilated 3x3s ``d1``..``d16`` (no BN),
    observed adds ``quant_add2``-``quant_add4`` joining d2..d16
    hierarchically, an observed ``quant_cat``, an observed ``skip_add`` of
    the input (``residual`` and stride 1), the 1x1 ``cbr`` (ReLU)."""

    def __init__(self, in_channels: int, out_channels: int, reduce_kernel: int = 1,
                 reduce_stride: int = 1, residual: bool = True, quantized: bool = True,
                 qconfig: QConfig = QNNPACK, dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(quantized=quantized, qconfig=qconfig, dtype=dtype)
        n = out_channels // 5
        n1 = out_channels - 4 * n
        self.quantized = quantized
        self.c1 = QConvBNAct(in_channels, n, reduce_kernel, strides=reduce_stride,
                             padding=(reduce_kernel - 1) // 2, act=None, use_bn=False, **kw)
        self.branches = []
        for i, d in enumerate((1, 2, 4, 8, 16)):
            conv = QConvBNAct(n, n1 if i == 0 else n, 3, padding=d, dilation=d, act=None,
                              use_bn=False, **kw)
            self.add_module(f"d{d}", conv)
            self.branches.append(conv)
        self.adds = []
        for i in range(2, 5):
            if quantized:
                self.add_module(f"quant_add{i}", QAdd(qconfig))
            self.adds.append(getattr(self, f"quant_add{i}", None))
        self.quant_cat = QCat(qconfig) if quantized else None
        self.has_skip = residual and reduce_stride == 1
        self.skip_add = QAdd(qconfig) if quantized and self.has_skip else None
        self.cbr = QConvBNAct(out_channels, out_channels, 1, act="relu", **kw)

    def prepare_int8(self, x: QParams, device, path: str = "") -> QParams:
        r = self.c1.prepare_int8(x, device)
        b = [conv.prepare_int8(r, device) for conv in self.branches]
        adds = [b[1]]
        for i, add in enumerate(self.adds):
            adds.append(_prepare_add(add, f"{path}quant_add{i + 2}", [adds[-1], b[i + 2]],
                                     device))
        g = self.quant_cat.prepare_int8([b[0]] + adds, device)
        if self.has_skip:
            g = _prepare_add(self.skip_add, f"{path}skip_add", [x, g], device)
        return self.cbr.prepare_int8(g, device)

    def forward(self, x, mode: QuantMode = FP32, train: bool = False):
        r = self.c1(x, mode, train)
        b = [conv(r, mode, train) for conv in self.branches]
        adds = [b[1]]
        for i, add in enumerate(self.adds):
            adds.append(_add(add, adds[-1], b[i + 2], mode))
        out = _cat(self.quant_cat, [b[0]] + adds, mode)
        if self.has_skip:
            out = _add(self.skip_add, x, out, mode)
        return self.cbr(out, mode, train)


class ESPNetSeg(_QuantRegionTail):
    """ESPNet (v1) segmentation: the ESPNet-C encoder with input
    reinforcement (``level1``, ``b1``-``b3``, ``level2_*``, ``level3*``,
    the concats ``quant_cat_e1``-``quant_cat_e3``) and the light decoder
    (``enc_classifier``, ``b``, ``up_l3``, ``level3_C``, ``combine_l2_l3``,
    ``up_l2``, ``conv``; the 2x resizes requantized by ``requant_l3`` and
    ``requant_l2``); after the quant region a 2x resize and the float 1x1
    ``classifier``."""

    def __init__(self, num_classes: int = 20, p: int = 2, q: int = 8, quantized: bool = True,
                 qconfig: QConfig = QNNPACK, dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(quantized=quantized, qconfig=qconfig, dtype=dtype)
        self.num_classes, self.quantized = num_classes, quantized
        nc = num_classes

        def cat():
            return QCat(qconfig) if quantized else None

        if quantized:
            self.quant = QuantStub(qconfig)
        self.level1 = QConvBNAct(3, 16, 3, strides=2, padding=1, act="relu", **kw)
        self.quant_cat_e1 = cat()
        self.b1 = QConvBNAct(19, 19, 1, act="relu", **kw)
        self.level2_0 = ESPBlock(19, 64, reduce_kernel=3, reduce_stride=2, residual=False, **kw)
        self.level2 = [self._block(f"level2_blk{i}", ESPBlock(64, 64, **kw)) for i in range(p)]
        self.quant_cat_e2 = cat()
        self.b2 = QConvBNAct(131, 131, 1, act="relu", **kw)
        self.level3_0 = ESPBlock(131, 128, reduce_kernel=3, reduce_stride=2, residual=False,
                                 **kw)
        self.level3 = [self._block(f"level3v1_blk{i}", ESPBlock(128, 128, **kw))
                       for i in range(q)]
        self.quant_cat_e3 = cat()
        self.b3 = QConvBNAct(256, 256, 1, act="relu", **kw)
        self.enc_classifier = QConvBNAct(256, nc, 1, act=None, use_bn=False, **kw)
        self.b = QConvBNAct(nc, nc, 1, act=None, **kw)
        self.requant_l3 = self._stub(qconfig)
        self.up_l3 = QConvBNAct(nc, nc, 1, act="relu", **kw)
        self.level3_C = QConvBNAct(131, nc, 1, act=None, use_bn=False, **kw)
        self.quant_cat_d1 = cat()
        self.combine_l2_l3 = ESPBlock(2 * nc, nc, residual=False, **kw)
        self.requant_l2 = self._stub(qconfig)
        self.up_l2 = QConvBNAct(nc, nc, 1, act="relu", **kw)
        self.quant_cat_d2 = cat()
        self.conv = QConvBNAct(nc + 19, nc, 3, padding=1, act="relu", **kw)
        self.classifier = QConvBNAct(nc, nc, 1, use_bn=False, use_bias=False, act=None,
                                     quantized=False)

    def _block(self, name: str, blk: ESPBlock) -> ESPBlock:
        self.add_module(name, blk)
        return blk

    def prepare_int8(self, device, image_size: Optional[int] = None) -> None:
        """Freeze the quant region for INT8 on ``device``."""
        if not self.quantized:
            return
        x = self.quant.prepare_int8(device)
        out0 = self.level1.prepare_int8(x, device)
        out0_cat = self.b1.prepare_int8(self.quant_cat_e1.prepare_int8([out0, x], device), device)
        out1_0 = h = self.level2_0.prepare_int8(out0_cat, device, "level2_0/")
        for i, blk in enumerate(self.level2):
            h = blk.prepare_int8(h, device, f"level2_blk{i}/")
        out1_cat = self.b2.prepare_int8(self.quant_cat_e2.prepare_int8([h, out1_0, x], device),
                                        device)
        out2_0 = h = self.level3_0.prepare_int8(out1_cat, device, "level3_0/")
        for i, blk in enumerate(self.level3):
            h = blk.prepare_int8(h, device, f"level3v1_blk{i}/")
        g = self.b3.prepare_int8(self.quant_cat_e3.prepare_int8([out2_0, h], device), device)
        self.b.prepare_int8(self.enc_classifier.prepare_int8(g, device), device)
        out2_c = self.up_l3.prepare_int8(self.requant_l3.prepare_int8(device), device)
        out1_c = self.level3_C.prepare_int8(out1_cat, device)
        g = self.quant_cat_d1.prepare_int8([out1_c, out2_c], device)
        self.combine_l2_l3.prepare_int8(g, device, "combine_l2_l3/")
        comb = self.up_l2.prepare_int8(self.requant_l2.prepare_int8(device), device)
        self.conv.prepare_int8(self.quant_cat_d2.prepare_int8([comb, out0_cat], device), device)

    def forward(self, x: torch.Tensor, mode: QuantMode = FP32, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, H, W, 3) float images -> (B, H, W, num_classes) float logits."""
        if self.quantized:
            x = self.quant(x, mode)
        out0 = self.level1(x, mode, train)
        inp1 = avg_pool_3x3_s2(x)
        inp2 = avg_pool_3x3_s2(inp1)
        out0_cat = self.b1(_cat(self.quant_cat_e1, [out0, inp1], mode), mode, train)
        out1_0 = h = self.level2_0(out0_cat, mode, train)
        for blk in self.level2:
            h = blk(h, mode, train)
        out1_cat = self.b2(_cat(self.quant_cat_e2, [h, out1_0, inp2], mode), mode, train)
        out2_0 = h = self.level3_0(out1_cat, mode, train)
        for blk in self.level3:
            h = blk(h, mode, train)
        out2_cat = self.b3(_cat(self.quant_cat_e3, [out2_0, h], mode), mode, train)
        enc = self.b(self.enc_classifier(out2_cat, mode, train), mode, train)
        l3 = self._up(enc, _twice(enc), self.requant_l3, mode)
        out2_c = self.up_l3(l3, mode, train)
        out1_c = self.level3_C(out1_cat, mode, train)
        comb = self.combine_l2_l3(_cat(self.quant_cat_d1, [out1_c, out2_c], mode), mode, train)
        l2 = self._up(comb, _twice(comb), self.requant_l2, mode)
        comb = self.up_l2(l2, mode, train)
        feat = self.conv(_cat(self.quant_cat_d2, [comb, out0_cat], mode), mode, train)
        feat = resize.resize_bilinear(dequant(feat), _twice(feat))
        return self.classifier(feat, mode, train)


def _twice(x):
    h, w = _shape(x)[1:3]
    return 2 * h, 2 * w
