"""Plain PyTorch reference of SSDLite-MobileNetV2 on PASCAL VOC at 300x300:
its INT8 serving and the published test-time ``Detect``, independent of the
program under test (nothing here imports ``frostnet_tpu_torch`` or JAX).

The model follows clovaai/frostnet ``Object_Detection/ssd_qmv2.py``
(``SSD_MobileNetV2_Feat``, ``SSD_MobileNetV2_HEAD``, ``build_ssd``) and
``data/config.py``'s ``voc``; SSDLite is arXiv:1801.04381, SSD
arXiv:1512.02325. It is built from the configuration's table:

* the quantized feature net: the input quantized, a 3x3/2 ConvBNReLU stem,
  MobileNetV2 inverted residuals (``[t, c, n, s, dilation]`` rows; a 1x1
  expand ConvBNReLU where ``t > 1``, a 3x3 depthwise ConvBNReLU, a linear
  1x1 project, an observed add where the shapes allow), the last two stages
  at stride 1 and dilation 2; ``final_conv`` (1x1 to 1280, ReLU); the
  extras, a 1x1 conv and a 3x3/2 depthwise conv with a channel multiplier
  of 4 in turn, each followed by a ReLU, then a 3x3 average pool; six
  dequantized sources (after the third stage, ``final_conv`` and extras 1,
  3, 5 and the pool);
* the float head, quantized in no phase: a 3x3 ConvBN for the loc (4 a
  prior) and one for the conf (21 a prior) of each source, concatenated
  over the sources as ``(B, 8732, 4)`` and ``(B, 8732, 21)``.

Names are those of the port's ``detection.models.Detector`` (``feat.*``,
``head.*``), so one set of seeded weights serves both.

The arithmetic of the convs, observers and integer convs is the seg
reference's (``SegReference``'s methods, inherited; ``quant.py`` beneath
them): calibration runs QAT forwards in train mode (observers and BN
statistics step, the head's BN statistics too); freezing folds BN, puts the
weights on the weight observer's grid and works out the epilogue
constants; the integer forward takes exact float64 sums of ``q - zp``, the
epilogue ``fma(acc, scale, bias)``, ReLU, ``* f32(1 / s)``, round and clamp.
The add requantizes ``(qa - za) * sa + (qb - zb) * sb``, the pool sums codes
exactly (``* f32(1 / 9)``, rounded), a ReLU on codes clamps at the zero
point, and the head runs its convs and eval-mode BN in float32.

``detect`` is the published test-time ``Detect`` (``layers/functions/
detection.py``) with ``layers/box_utils.py``'s ``decode`` and ``nms``:
the softmax, the variance decode (0.1, 0.2) of the priors (``PriorBox``,
clipped to [0, 1]), then for each image and class the scores above
``conf_thresh``, the ``top_k`` highest, and the original's per-row greedy
loop (keep the best left, drop the rest whose IoU with it is above
``nms_thresh``). Its departures from the published code, each so that the
same logits give the same detections as any sound implementation that
rounds as the program does:

* ties of equal scores take the lower prior first (a stable sort; the
  original's ``sort`` leaves their order unspecified). Random logits tie
  often: some 14 pairs among a row's 8,732 float32 scores;
* a box's far corner is ``center + size / 2``, where the original takes
  ``(center - size / 2) + size``: the two differ in the last bit;
* the IoU's union is ``(area_i + area_j) - inter``, where the original sums
  ``(area_j - inter) + area_i``; an area clamps its sides at 0 (decoded
  sides are positive, so that changes nothing) and the union at 1e-12;
  a last bit apart, a suppression at the threshold's edge would flip now
  and then over the 10^7 to 10^8 comparisons a request makes;
* the softmax, the decode and the threshold run in torch on the logits'
  device (the program's kernels give the same bits there); the loop runs
  in NumPy float32 on the host, for the sampled requests only: 18.7 s for
  a request of 256 images (5,120 rows, 176 kept a row) on an H100
  machine's host, 3.7 ms a row;
* the output is each row's kept ``(score, x1, y1, x2, y2)`` in score order,
  not the original's ``(B, C, top_k, 5)`` zero-padded tensor.

``act``/``weight`` grids of 4 bits give the control of the INT8 trunk;
``head_tf32`` gives the control of the float head: its convs' operands
rounded to TF32 (``quant.tf32_round``) in the frozen forward, the trunk,
the calibration and the BN statistics unchanged.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.quant import (  # noqa: F401
    ACT4, ACT8, BN_EPS, WEIGHT4, WEIGHT8, Grid, f32, no_tf32, recip, tf32_round)
from portbench.reference.seg_mobilenetv3 import Conv, SegReference, avg_pool


@dataclasses.dataclass(frozen=True)
class Block:
    name: str
    expand: Optional[Conv]
    depthwise: Conv
    project: Conv
    residual: bool


def build_layers(arch: dict):
    """(stem, blocks, index of the first source's block + 1, final_conv,
    extras (a Conv or None for the pool), head [(loc, conf)] by source)."""
    f, h = "feat.", "head."
    c = arch["stem_channels"]  # the widths are multiples of 8 already
    stem = Conv(f + "stem", 3, c, 3, stride=2, relu=True)
    blocks, first = [], 0
    for si, (t, out, n, s, d) in enumerate(arch["settings"]):
        for i in range(n):
            name, stride = f"{f}block{len(blocks)}", s if i == 0 else 1
            hidden = int(round(c * t))
            blocks.append(Block(
                name, Conv(f"{name}.expand", c, hidden, 1, relu=True) if t != 1 else None,
                Conv(f"{name}.dw", hidden, hidden, 3, stride=stride, dilation=d, groups=hidden,
                     relu=True),
                Conv(f"{name}.project", hidden, out, 1), stride == 1 and c == out))
            c = out
        if si == arch["first_source_stage"]:
            first = len(blocks)
    final = Conv(f + "final_conv", c, arch["final_channels"], 1, relu=True)
    extras, c, grouped = [], final.cout, False
    for k, (v, s) in enumerate(zip(arch["extras"], arch["extras_strides"])):
        if v == "P":
            extras.append(None)
        else:
            extras.append(Conv(f"{f}extra{k}", c, v, 3 if grouped else 1, stride=s,
                               groups=c if grouped else 1))
            c = v
        grouped = not grouped
    n = arch["num_classes"]
    head = [(Conv(f"{h}loc{i}", ch, a * 4, 3, quantized=False),
             Conv(f"{h}conf{i}", ch, a * n, 3, quantized=False))
            for i, (ch, a) in enumerate(zip(arch["source_channels"], arch["anchor_counts"]))]
    return stem, blocks, first, final, extras, head


def _obs(site: str):
    return [(f"{site}.min_val", (), "min"), (f"{site}.max_val", (), "max")]


def param_specs(arch: dict) -> List[Tuple[str, tuple, str]]:
    """Every parameter and buffer as (name, shape, kind), parameters in the
    port's registration order first."""
    stem, blocks, _, final, extras, head = build_layers(arch)
    params, buffers = [], _obs("feat.quant.act")

    def add(c: Conv):
        params.extend([(f"{c.name}.kernel", (c.k, c.k, c.cin // c.groups, c.cout), "kernel"),
                       (f"{c.name}.scale", (c.cout,), "ones"),
                       (f"{c.name}.bias_bn", (c.cout,), "zeros")])
        buffers.extend([(f"{c.name}.mean", (c.cout,), "zeros"), (f"{c.name}.var", (c.cout,), "ones")])
        if c.quantized:
            buffers.extend(_obs(f"{c.name}.w_obs") + _obs(f"{c.name}.act_obs"))

    add(stem)
    for b in blocks:
        for c in (b.expand, b.depthwise, b.project):
            if c is not None:
                add(c)
        if b.residual:
            buffers.extend(_obs(f"{b.name}.skip_add.act"))
    add(final)
    for c in extras:
        if c is not None:
            add(c)
    for loc, conf in head:
        add(loc)
        add(conf)
    return params + buffers


def make_priors(cfg: dict) -> np.ndarray:
    """(P, 4) center-form priors: ``PriorBox.forward`` of the published code,
    float32, clipped to [0, 1]."""
    mean = []
    for k, fm in enumerate(cfg["feature_maps"]):
        for i in range(fm):
            for j in range(fm):
                f_k = cfg["min_dim"] / cfg["steps"][k]
                cx, cy = (j + 0.5) / f_k, (i + 0.5) / f_k
                s_k = cfg["min_sizes"][k] / cfg["min_dim"]
                mean += [cx, cy, s_k, s_k]
                s_k_prime = math.sqrt(s_k * (cfg["max_sizes"][k] / cfg["min_dim"]))
                mean += [cx, cy, s_k_prime, s_k_prime]
                for ar in cfg["aspect_ratios"][k]:
                    mean += [cx, cy, s_k * math.sqrt(ar), s_k / math.sqrt(ar)]
                    mean += [cx, cy, s_k / math.sqrt(ar), s_k * math.sqrt(ar)]
    out = np.asarray(mean, np.float32).reshape(-1, 4)
    return np.clip(out, 0.0, 1.0) if cfg["clip"] else out


def decode(loc: torch.Tensor, priors: torch.Tensor, variances: Sequence[float]) -> torch.Tensor:
    """Variance-encoded offsets -> point-form boxes (the far corner as
    ``center + size / 2``, module docstring)."""
    dev = loc.device
    cxcy = priors[:, :2] + loc[..., :2] * f32(variances[0], dev) * priors[:, 2:]
    half = priors[:, 2:] * torch.exp(loc[..., 2:] * f32(variances[1], dev)) * f32(0.5, dev)
    return torch.cat([cxcy - half, cxcy + half], -1)


def nms(boxes: np.ndarray, scores: np.ndarray, overlap: float, top_k: int) -> np.ndarray:
    """The indices kept, best first: ``box_utils.nms``'s greedy loop over the
    ``top_k`` highest of ``scores`` (float32, ties by lower index)."""
    order = np.argsort(-scores, kind="stable")[:top_k]
    x1, y1, x2, y2 = (boxes[order, j] for j in range(4))
    zero, tiny, thresh = np.float32(0), np.float32(1e-12), np.float32(overlap)
    area = np.maximum(x2 - x1, zero) * np.maximum(y2 - y1, zero)
    idx, keep = np.arange(order.size), []
    while idx.size:
        i, rest = idx[0], idx[1:]
        keep.append(i)
        w = np.maximum(np.minimum(x2[i], x2[rest]) - np.maximum(x1[i], x1[rest]), zero)
        h = np.maximum(np.minimum(y2[i], y2[rest]) - np.maximum(y1[i], y1[rest]), zero)
        inter = w * h
        iou = inter / np.maximum((area[i] + area[rest]) - inter, tiny)
        idx = rest[iou <= thresh]
    return order[np.asarray(keep, np.int64)]


class SSDReference(SegReference):
    """The reference detector; ``state`` holds every parameter and buffer by
    name. The conv, observer and integer-conv arithmetic is
    ``SegReference``'s (its ``_conv``, ``_fq``, ``_grid``, ``_freeze_conv``,
    ``_int8_conv``, ``_requant``, ``_dequant``); the layers are this
    model's."""

    def __init__(self, arch: dict, weights: Dict[str, torch.Tensor], act: Grid = ACT8,
                 weight: Grid = WEIGHT8, tf32: bool = False, head_tf32: bool = False):
        self.arch, self.act, self.weight, self.tf32 = arch, act, weight, tf32
        self.head_tf32 = head_tf32
        (self.stem, self.blocks, self.first, self.final, self.extras,
         self.head) = build_layers(arch)
        self.state = {n: weights[n].detach().clone() for n, _, _ in param_specs(arch)}
        self.priors = torch.as_tensor(make_priors(arch["priors"]))

    # -- float phases ----------------------------------------------------

    def _trunk(self, x: torch.Tensor, qat: bool) -> List[torch.Tensor]:
        x = self._conv(self._fq(x, "feat.quant.act", qat), self.stem, qat)
        sources = []
        for i, b in enumerate(self.blocks):
            out = x if b.expand is None else self._conv(x, b.expand, qat)
            out = self._conv(self._conv(out, b.depthwise, qat), b.project, qat)
            x = self._fq(x + out, f"{b.name}.skip_add.act", qat) if b.residual else out
            if i + 1 == self.first:
                sources.append(x)
        x = self._conv(x, self.final, qat)
        sources.append(x)
        for k, c in enumerate(self.extras):
            x = torch.relu(avg_pool(x, 3, 3) if c is None else self._conv(x, c, qat))
            if k in self.arch["extras_head_pos"]:
                sources.append(x)
        return sources

    @staticmethod
    def _gather(outs: List[Tuple[torch.Tensor, torch.Tensor]], n: int):
        b = outs[0][0].shape[0]
        return (torch.cat([loc.reshape(b, -1) for loc, _ in outs], 1).reshape(b, -1, 4),
                torch.cat([conf.reshape(b, -1) for _, conf in outs], 1).reshape(b, -1, n))

    def forward_train(self, x: torch.Tensor, qat: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, 300, 300, 3) float images -> (loc, conf) in train mode: the
        observers and every BN's statistics step once."""
        outs = [(self._conv(s, loc, qat), self._conv(s, conf, qat))
                for s, (loc, conf) in zip(self._trunk(x, qat), self.head)]
        return self._gather(outs, self.arch["num_classes"])

    @torch.no_grad()
    def calibrate(self, batches: Sequence[torch.Tensor], seed: int = 0) -> None:
        for x in batches:
            self.forward_train(x, True)

    # -- INT8 --------------------------------------------------------------

    def freeze(self) -> None:
        self.frozen = {}
        with torch.no_grad():
            g = self.frozen["quant"] = self._grid("feat.quant.act")
            g = self._freeze_conv(self.stem, g)
            for b in self.blocks:
                x = g
                if b.expand is not None:
                    g = self._freeze_conv(b.expand, g)
                g = self._freeze_conv(b.project, self._freeze_conv(b.depthwise, g))
                if b.residual:
                    out = self._grid(f"{b.name}.skip_add.act")
                    self.frozen[f"{b.name}.skip_add"] = ((x, g), out)
                    g = out
            g = self._freeze_conv(self.final, g)
            for c in self.extras:
                if c is not None:  # the ReLU and the pool keep the grid
                    g = self._freeze_conv(c, g)

    def _int8(self, q: torch.Tensor, c: Conv):
        return self._int8_conv(q, c), self.frozen[c.name][5]

    def _head_eval(self, src: torch.Tensor, c: Conv) -> torch.Tensor:
        st = self.state
        k = st[f"{c.name}.kernel"].detach()
        if self.head_tf32:
            src, k = tf32_round(src), tf32_round(k)
        y = self._conv2d(src, k, c).permute(0, 3, 1, 2)
        y = F.batch_norm(y, st[f"{c.name}.mean"], st[f"{c.name}.var"], st[f"{c.name}.scale"].detach(),
                         st[f"{c.name}.bias_bn"].detach(), training=False, eps=BN_EPS)
        return y.permute(0, 2, 3, 1)

    @torch.no_grad()
    def sources_int8(self, x: torch.Tensor) -> List[Tuple[torch.Tensor, Tuple[float, int]]]:
        """(B, 300, 300, 3) float images -> the six sources of the frozen
        feature net: (codes held as float32 integers, their grid)."""
        q, g = self._int8(self._requant(x, self.frozen["quant"]), self.stem)
        sources = []
        for i, b in enumerate(self.blocks):
            xq, out = q, q
            if b.expand is not None:
                out, _ = self._int8(out, b.expand)
            out, g = self._int8(self._int8(out, b.depthwise)[0], b.project)
            if b.residual:
                ((sa, za), (sb, zb)), g = self.frozen[f"{b.name}.skip_add"]
                dev = out.device
                out = self._requant((xq - za) * f32(sa, dev) + (out - zb) * f32(sb, dev), g)
            q = out
            if i + 1 == self.first:
                sources.append((q, g))
        q, g = self._int8(q, self.final)
        sources.append((q, g))
        for k, c in enumerate(self.extras):
            if c is None:
                s = F.avg_pool2d(q.permute(0, 3, 1, 2).to(torch.float64), 3, 3,
                                 divisor_override=1).to(torch.float32).permute(0, 2, 3, 1)
                q = torch.clamp(torch.round(s * f32(recip(9.0), q.device)), 0, 255)
            else:
                q, g = self._int8(q, c)
            q = torch.maximum(q, torch.full((), float(g[1]), device=q.device))
            if k in self.arch["extras_head_pos"]:
                sources.append((q, g))
        return sources

    @torch.no_grad()
    def forward_int8(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, 300, 300, 3) float images -> float32 (loc (B, P, 4), conf (B,
        P, C)): the frozen feature net's dequantized sources through the
        float head."""
        outs = [(self._head_eval(f, loc), self._head_eval(f, conf)) for f, (loc, conf)
                in zip((self._dequant(q, g) for q, g in self.sources_int8(x)), self.head)]
        return self._gather(outs, self.arch["num_classes"])

    # -- the published test-time Detect ------------------------------------

    @torch.no_grad()
    def detect(self, loc: torch.Tensor, conf: torch.Tensor, conf_thresh: float,
               nms_thresh: float, top_k: int) -> List[np.ndarray]:
        """(B, P, 4) loc and (B, P, C) conf logits -> each image's classes
        1..C-1 in turn (B * (C - 1) rows): the kept ``(score, x1, y1, x2,
        y2)`` of the row, float32, best first."""
        scores = torch.softmax(conf, dim=-1)
        boxes = decode(loc, self.priors.to(loc.device), self.arch["priors"]["variance"])
        above = (scores > conf_thresh).cpu().numpy()
        scores, boxes = scores.cpu().numpy(), boxes.cpu().numpy()
        rows = []
        for b in range(scores.shape[0]):
            for c in range(1, scores.shape[2]):
                ids = np.flatnonzero(above[b, :, c])
                kept = ids[nms(boxes[b, ids], scores[b, ids, c], nms_thresh, top_k)]
                rows.append(np.concatenate([scores[b, kept, c][:, None], boxes[b, kept]], 1))
        return rows


Reference = SSDReference


def shape_tables(arch: dict, image_size: int) -> dict:
    """The shape tables at one image of ``image_size``: ``convs`` ``[name,
    ho, wo, cin, cout, k, groups]`` (the float head's included) and the INT8
    forward's ``matmuls`` ``[name, M an image, K, N]`` (every dense conv of
    the feature net: the 1x1s and the stem by im2col at its own K)."""
    stem, blocks, first, final, extras, head = build_layers(arch)
    convs, matmuls, sources = [], [], []

    def conv(c: Conv, hw):
        ho, wo = ((n + 2 * c.pad - c.dilation * (c.k - 1) - 1) // c.stride + 1 for n in hw)
        convs.append([c.name, ho, wo, c.cin, c.cout, c.k, c.groups])
        if c.quantized and c.groups == 1:
            matmuls.append([c.name, ho * wo, c.k * c.k * c.cin, c.cout])
        return ho, wo

    hw = conv(stem, (image_size, image_size))
    for i, b in enumerate(blocks):
        if b.expand is not None:
            hw = conv(b.expand, hw)
        hw = conv(b.project, conv(b.depthwise, hw))
        if i + 1 == first:
            sources.append(hw)
    hw = conv(final, hw)
    sources.append(hw)
    for k, c in enumerate(extras):
        hw = tuple((n - 3) // 3 + 1 for n in hw) if c is None else conv(c, hw)
        if k in arch["extras_head_pos"]:
            sources.append(hw)
    for hw, (loc, conf) in zip(sources, head):
        conv(loc, hw)
        conv(conf, hw)
    return {"convs": convs, "matmuls": matmuls}
