"""Plain PyTorch reference of the MobileNetV3 + LR-ASPP segmenter: its QAT
training step and its INT8 serving, independent of the program under test.

The model (as in "Searching for MobileNetV3", arXiv:1905.02244, and
clovaai/frostnet's ``Semantic_Segmentation``) is built from the
configuration's table: a dilated MobileNetV3 trunk (the last stage at
stride 1, dilation 2, its last block and ``layer5`` halved), the LR-ASPP
head on the /16 map (a 1x1 ConvBNReLU branch times a hard-sigmoid gate on
an average pool), and a float tail (1x1 convs with a bias on both streams,
their sum, a bilinear resize to the input). Names are those of the port's
``segmentation/models.py``, so one set of seeded weights serves both.

The arithmetic follows ``frostnet.py`` of this directory (QAT's ConvBN
recipe, moving-average observers, the STE, QSGD) and adds the MobileNetV3
pieces: hard-swish as observed ops (``x + 3``, clamp to [0, 6], observed;
the product observed; ``* f32(1/6)``), squeeze-excite (a spatial mean summed
in float64, two float ``QDense`` layers whose products are summed in float64
and whose weights and outputs are fake-quantized, a hard-sigmoid, an
observed product), and the bilinear resize (align_corners) with the
program's rounding: a fused multiply-add where an output side is a multiple
of 64. In INT8 a hard-swish clamps the codes on the grid shifted by
``round(3 / s)`` and requantizes the product of the two dequantized
operands; the squeeze-excite runs in float on fake-quantized weights and
outputs; the pool sums codes exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.quant import (  # noqa: F401
    ACT4, ACT8, BN_EPS, WEIGHT4, WEIGHT8, Grid, QSGDReference, batch_norm_train, f32, fma_f32,
    no_tf32, observe_fake_quant, prep_image, qparams, recip, tf32_round)

SIXTH = 1.0 / 6.0


@dataclasses.dataclass(frozen=True)
class Conv:
    name: str
    cin: int
    cout: int
    k: int
    stride: int = 1
    dilation: int = 1
    groups: int = 1
    bn: bool = True
    bias: bool = False
    relu: bool = False
    quantized: bool = True

    @property
    def pad(self) -> int:
        return (self.k - 1) // 2 * self.dilation


@dataclasses.dataclass(frozen=True)
class Block:
    name: str
    expand: Conv
    depthwise: Conv
    se: Optional[Tuple[int, int]]     # (channels, reduced)
    project: Conv
    hs: bool
    residual: bool


def build_layers(arch: dict):
    """(stem, blocks, layer5, b0, b1_conv, project, auxlayer, c1 index) from
    the table's ``stages`` of ``[kernel, expand, out, se, nl, stride]``
    rows."""
    p = "backbone."
    stem = Conv(p + "conv1", 3, 16, 3, stride=2)
    blocks, stage_ends, c = [], [], 16
    last = len(arch["stages"]) - 1
    for si, stage in enumerate(arch["stages"]):
        dil = 2 if si == last else 1
        for bi, (k, exp, ch, se, nl, s) in enumerate(stage):
            if si == last and bi == len(stage) - 1:
                exp, ch = exp // 2, ch // 2
            hs, stride = nl == "HS", s if dil == 1 else 1
            name = f"{p}layer{si + 1}_{bi}"
            blocks.append(Block(
                name, Conv(f"{name}.expand", c, exp, 1, relu=not hs),
                Conv(f"{name}.dw", exp, exp, k, stride=stride, dilation=dil, groups=exp),
                (exp, exp // 4) if se else None, Conv(f"{name}.project", exp, ch, 1),
                hs, stride == 1 and c == ch))
            c = ch
        stage_ends.append(len(blocks) - 1)
    layer5 = Conv(p + "layer5", c, arch["last_channels"] // 2, 1)
    h = "head.lr_aspp."
    b0 = Conv(h + "b0", layer5.cout, 128, 1, relu=True)
    b1 = Conv(h + "b1_conv", layer5.cout, 128, 1)
    n = arch["num_classes"]
    c1 = blocks[stage_ends[1]].project.cout
    proj = Conv("project", 128, n, 1, bn=False, bias=True, quantized=False)
    aux = Conv("auxlayer", c1, n, 1, bn=False, bias=True, quantized=False)
    return stem, blocks, stage_ends, layer5, b0, b1, proj, aux


def _conv_specs(c: Conv):
    params = [(f"{c.name}.kernel", (c.k, c.k, c.cin // c.groups, c.cout), "kernel")]
    if c.bias:
        params.append((f"{c.name}.bias", (c.cout,), "zeros"))
    buffers = []
    if c.bn:
        params += [(f"{c.name}.scale", (c.cout,), "ones"), (f"{c.name}.bias_bn", (c.cout,), "zeros")]
        buffers += [(f"{c.name}.mean", (c.cout,), "zeros"), (f"{c.name}.var", (c.cout,), "ones")]
    if c.quantized:
        buffers += _obs(f"{c.name}.w_obs") + _obs(f"{c.name}.act_obs")
    return params, buffers


def _obs(site: str):
    return [(f"{site}.min_val", (), "min"), (f"{site}.max_val", (), "max")]


def param_specs(arch: dict) -> List[Tuple[str, tuple, str]]:
    """Every parameter and buffer as (name, shape, kind), parameters in the
    port's registration order first."""
    stem, blocks, _, layer5, b0, b1, proj, aux = build_layers(arch)
    params, buffers = [], _obs("quant.act")

    def add(c):
        p, b = _conv_specs(c)
        params.extend(p)
        buffers.extend(b)

    def hswish(name):
        buffers.extend(_obs(f"{name}.relu6_obs") + _obs(f"{name}.quant_mul.act"))

    add(stem)
    hswish("backbone.conv1_hs")
    for b in blocks:
        add(b.expand)
        if b.hs:
            hswish(f"{b.name}.expand_hs")
        add(b.depthwise)
        if b.se:
            ch, red = b.se
            for fc, shape in (("fc1", (ch, red, 1, 1)), ("fc2", (red, ch, 1, 1))):
                params.append((f"{b.name}.se.{fc}.kernel", shape, "kernel"))
                buffers.extend(_obs(f"{b.name}.se.{fc}.w_obs") + _obs(f"{b.name}.se.{fc}.act_obs"))
            buffers.extend(_obs(f"{b.name}.se.hsig.relu6_obs") + _obs(f"{b.name}.se.quant_mul.act"))
        if b.hs:
            hswish(f"{b.name}.dw_hs")
        add(b.project)
        if b.residual:
            buffers.extend(_obs(f"{b.name}.skip_add.act"))
    add(layer5)
    hswish("backbone.layer5_hs")
    add(b0)
    add(b1)
    buffers.extend(_obs("head.lr_aspp.b1_hsig.relu6_obs") + _obs("head.lr_aspp.quant_mul.act"))
    add(proj)
    add(aux)
    return params + buffers


# -- the float pieces, rounded as the program rounds them ---------------------

def spatial_mean(x: torch.Tensor) -> torch.Tensor:
    s = x.to(torch.float64).sum(dim=(1, 2)).to(torch.float32)
    return s * f32(recip(float(x.shape[1] * x.shape[2])), s.device)


def exact_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return (x.to(torch.float64) @ w.to(torch.float64)).to(torch.float32)


def avg_pool(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """'VALID' window sums (exact in float64, rounded once) times
    ``f32(1 / window**2)``."""
    s = F.avg_pool2d(x.permute(0, 3, 1, 2).to(torch.float64), window, stride,
                     divisor_override=1).to(torch.float32).permute(0, 2, 3, 1)
    return s * f32(recip(float(window * window)), s.device)


def _taps(n_in: int, n_out: int):
    pos = np.zeros((1,), np.float64) if n_out == 1 else np.linspace(0.0, n_in - 1.0, n_out)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    w = pos - lo
    return lo, hi, (1.0 - w).astype(np.float32), w.astype(np.float32)


def _interp(x: torch.Tensor, dim: int, n_out: int) -> torch.Tensor:
    lo, hi, w_lo, w_hi = _taps(x.shape[dim], n_out)
    dev, shape = x.device, [1] * x.dim()
    shape[dim] = n_out
    wl = torch.as_tensor(w_lo, device=dev).reshape(shape)
    wh = torch.as_tensor(w_hi, device=dev).reshape(shape)
    x_lo = x.index_select(dim, torch.as_tensor(lo, device=dev))
    x_hi = x.index_select(dim, torch.as_tensor(hi, device=dev))
    if n_out % 64 == 0:
        return fma_f32(x_hi, wh, x_lo * wl)
    return x_lo * wl + x_hi * wh


def resize(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """NHWC bilinear resize, align_corners, the H pass first."""
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    return _interp(_interp(x.to(torch.float32), 1, size[0]), 2, size[1])


class SegReference:
    """The reference segmenter; ``state`` holds every parameter and buffer by
    name, ``params`` the trainable ones in the optimizer's order."""

    def __init__(self, arch: dict, weights: Dict[str, torch.Tensor], act: Grid = ACT8,
                 weight: Grid = WEIGHT8, tf32: bool = False):
        self.arch, self.act, self.weight, self.tf32 = arch, act, weight, tf32
        (self.stem, self.blocks, self.stage_ends, self.layer5, self.b0, self.b1, self.proj,
         self.aux) = build_layers(arch)
        specs = param_specs(arch)
        self.state = {n: weights[n].detach().clone() for n, _, _ in specs}
        self.param_names = [n for n, _, kind in specs if kind in ("kernel", "ones", "zeros")
                            and not n.endswith((".mean", ".var"))]
        for n in self.param_names:
            self.state[n].requires_grad_(True)
        self.pool = arch["pool"]

    @property
    def params(self) -> List[torch.Tensor]:
        return [self.state[n] for n in self.param_names]

    # -- float phases ----------------------------------------------------

    def _fq(self, x, site: str, qat: bool, g: Optional[Grid] = None):
        if not qat:
            return x
        return observe_fake_quant(x, self.state[f"{site}.min_val"], self.state[f"{site}.max_val"],
                                  g or self.act)

    def _conv2d(self, x, w, c: Conv):
        xt = x.permute(0, 3, 1, 2)
        wt = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        if self.tf32 and c.quantized:
            xt, wt = tf32_round(xt), tf32_round(wt)
        return F.conv2d(xt, wt, None, c.stride, c.pad, c.dilation, c.groups).permute(0, 2, 3, 1)

    def _conv(self, x, c: Conv, qat: bool):
        st = self.state
        k = st[f"{c.name}.kernel"]
        q = qat and c.quantized
        if q and c.bn:
            sf = st[f"{c.name}.scale"] / torch.sqrt(
                (st[f"{c.name}.var"] + BN_EPS).to(torch.float64)).to(torch.float32)
            y = self._conv2d(x, self._fq(k * sf, f"{c.name}.w_obs", True, self.weight), c) / sf
        else:
            y = self._conv2d(x, self._fq(k, f"{c.name}.w_obs", q, self.weight), c)
        if c.bias:
            y = y + st[f"{c.name}.bias"]
        if c.bn:
            y = batch_norm_train(y, st[f"{c.name}.scale"], st[f"{c.name}.bias_bn"],
                                 st[f"{c.name}.mean"], st[f"{c.name}.var"])
        if c.relu:
            y = F.relu(y)
        return self._fq(y, f"{c.name}.act_obs", q)

    def _hswish(self, x, name: str, qat: bool):
        gate = self._fq(torch.clamp(x + 3.0, 0.0, 6.0), f"{name}.relu6_obs", qat)
        return self._fq(x * gate, f"{name}.quant_mul.act", qat) * f32(SIXTH, x.device)

    def _dense(self, x, name: str, qat: bool, relu: bool):
        w = self._fq(self.state[f"{name}.kernel"][..., 0, 0], f"{name}.w_obs", qat, self.weight)
        y = exact_matmul(x, w)
        if relu:
            y = torch.relu(y)
        return self._fq(y, f"{name}.act_obs", qat)

    def _se(self, x, name: str, qat: bool):
        s = self._dense(self._dense(spatial_mean(x), f"{name}.fc1", qat, True), f"{name}.fc2", qat,
                        False)
        s = self._fq(torch.clamp(s + 3.0, 0.0, 6.0), f"{name}.hsig.relu6_obs", qat)
        s = (s * f32(SIXTH, s.device))[:, None, None, :]
        return self._fq(x * s, f"{name}.quant_mul.act", qat)

    def forward_train(self, x: torch.Tensor, qat: bool, generator=None) -> torch.Tensor:
        """(B, H, W, 3) float images -> (B, H, W, classes) logits in train
        mode; observers and BN statistics step once."""
        size = tuple(x.shape[1:3])
        x = self._fq(x, "quant.act", qat)
        x = self._hswish(self._conv(x, self.stem, qat), "backbone.conv1_hs", qat)
        c1 = None
        for i, b in enumerate(self.blocks):
            out = self._conv(x, b.expand, qat)
            if b.hs:
                out = self._hswish(out, f"{b.name}.expand_hs", qat)
            out = self._conv(out, b.depthwise, qat)
            if b.se:
                out = self._se(out, f"{b.name}.se", qat)
            out = self._hswish(out, f"{b.name}.dw_hs", qat) if b.hs else torch.relu(out)
            out = self._conv(out, b.project, qat)
            if b.residual:
                out = self._fq(x + out, f"{b.name}.skip_add.act", qat)
            x = out
            if i == self.stage_ends[1]:
                c1 = x
        c4 = self._hswish(self._conv(x, self.layer5, qat), "backbone.layer5_hs", qat)
        hw = tuple(c4.shape[1:3])
        feat1 = self._conv(c4, self.b0, qat)
        win = min(self.pool[0], *hw)
        feat2 = self._conv(avg_pool(c4, win, min(self.pool[1], win)), self.b1, qat)
        feat2 = self._fq(torch.clamp(feat2 + 3.0, 0.0, 6.0), "head.lr_aspp.b1_hsig.relu6_obs", qat)
        feat2 = resize(feat2 * f32(SIXTH, feat2.device), hw)
        c4 = self._fq(feat1 * feat2, "head.lr_aspp.quant_mul.act", qat)
        c4 = resize(c4, tuple(c1.shape[1:3]))
        return resize(self._conv(c1, self.aux, qat) + self._conv(c4, self.proj, qat), size)

    @torch.no_grad()
    def calibrate(self, batches: Sequence[torch.Tensor], seed: int = 0) -> None:
        for x in batches:
            self.forward_train(x, True)

    # -- INT8 --------------------------------------------------------------

    def _grid(self, site: str) -> Tuple[float, int]:
        s, z = qparams(self.state[f"{site}.min_val"].detach(),
                       self.state[f"{site}.max_val"].detach(), self.act, traced=False)
        return float(s), int(z)

    def _freeze_conv(self, c: Conv, x: Tuple[float, int]) -> Tuple[float, int]:
        st = self.state
        dev = st[f"{c.name}.kernel"].device
        w = st[f"{c.name}.kernel"].detach()
        sf = st[f"{c.name}.scale"].detach() / torch.sqrt(
            (st[f"{c.name}.var"] + BN_EPS).to(torch.float64)).to(torch.float32)
        bias = (0 - st[f"{c.name}.mean"]) * sf + st[f"{c.name}.bias_bn"].detach()
        ws, _ = qparams(st[f"{c.name}.w_obs.min_val"], st[f"{c.name}.w_obs.max_val"],
                        self.weight, traced=False)
        qw = torch.clamp(torch.round((w * sf) / ws), self.weight.qmin, self.weight.qmax)
        out = self._grid(f"{c.name}.act_obs")
        comb = torch.tensor(x[0], dtype=torch.float32, device=dev) * ws
        inv = recip(out[0])
        if not c.relu and bool(torch.all(bias == 0)):
            scale, bias, mult = (comb * f32(inv, dev)).expand(c.cout).clone(), torch.zeros_like(bias), 1.0
        else:
            scale, mult = comb.expand(c.cout).clone(), inv
        self.frozen[c.name] = (qw.to(torch.float64).permute(3, 2, 0, 1).contiguous(), x[1],
                               scale, bias.to(torch.float32), mult, out)
        return out

    def _freeze_hswish(self, name: str, x: Tuple[float, int]) -> Tuple[float, int]:
        s, z = x
        zs = z - int(torch.round(torch.tensor(3.0) / torch.tensor(s, dtype=torch.float32)))
        q6 = torch.round(torch.tensor(6.0) / torch.tensor(s, dtype=torch.float32)) + float(zs)
        hi = int(torch.clamp(q6, 0, 255))
        m = self._grid(f"{name}.quant_mul.act")
        out = (float(torch.tensor(m[0], dtype=torch.float32) * torch.tensor(SIXTH, dtype=torch.float32)),
               m[1])
        self.frozen[name] = ((s, z), (zs, hi), m, out)
        return out

    def _freeze_dense(self, name: str) -> None:
        w = self.state[f"{name}.kernel"].detach()[..., 0, 0]
        ws, wz = qparams(self.state[f"{name}.w_obs.min_val"], self.state[f"{name}.w_obs.max_val"],
                         self.weight, traced=False)
        inv = torch.ones((), dtype=torch.float32, device=w.device) / ws
        wq = (torch.clamp(torch.round(w * inv) + wz, self.weight.qmin, self.weight.qmax) - wz) * ws
        self.frozen[name] = (wq, self._grid(f"{name}.act_obs"))

    def freeze(self) -> None:
        self.frozen = {}
        with torch.no_grad():
            g = self._grid("quant.act")
            self.frozen["quant"] = g
            g = self._freeze_hswish("backbone.conv1_hs", self._freeze_conv(self.stem, g))
            for i, b in enumerate(self.blocks):
                x = g
                g = self._freeze_conv(b.expand, g)
                if b.hs:
                    g = self._freeze_hswish(f"{b.name}.expand_hs", g)
                g = self._freeze_conv(b.depthwise, g)
                if b.se:
                    self._freeze_dense(f"{b.name}.se.fc1")
                    self._freeze_dense(f"{b.name}.se.fc2")
                    g = self._grid(f"{b.name}.se.quant_mul.act")
                if b.hs:
                    g = self._freeze_hswish(f"{b.name}.dw_hs", g)
                g = self._freeze_conv(b.project, g)
                if b.residual:
                    out = self._grid(f"{b.name}.skip_add.act")
                    self.frozen[f"{b.name}.skip_add"] = ([x, g], out)
                    g = out
                if i == self.stage_ends[1]:
                    self.frozen["c1"] = g
            g = self._freeze_hswish("backbone.layer5_hs", self._freeze_conv(self.layer5, g))
            self._freeze_conv(self.b0, g)
            s, z = self._freeze_conv(self.b1, g)
            zs = z - int(torch.round(torch.tensor(3.0) / torch.tensor(s, dtype=torch.float32)))
            q6 = torch.round(torch.tensor(6.0) / torch.tensor(s, dtype=torch.float32)) + float(zs)
            self.frozen["b1_hsig"] = (zs, int(torch.clamp(q6, 0, 255)), float(
                torch.tensor(s, dtype=torch.float32) * torch.tensor(SIXTH, dtype=torch.float32)))
            self.frozen["head_mul"] = self._grid("head.lr_aspp.quant_mul.act")

    def _requant(self, y: torch.Tensor, grid: Tuple[float, int]) -> torch.Tensor:
        a = self.act
        return torch.clamp(torch.round(y * f32(recip(grid[0]), y.device)) + grid[1], a.qmin, a.qmax)

    def _int8_conv(self, q: torch.Tensor, c: Conv) -> torch.Tensor:
        w64, zp_in, scale, bias, mult, (_, zp) = self.frozen[c.name]
        xs = (q.to(torch.float64) - zp_in).permute(0, 3, 1, 2)
        acc = torch.round(F.conv2d(xs, w64, None, c.stride, c.pad, c.dilation, c.groups))
        y = fma_f32(acc.permute(0, 2, 3, 1).to(torch.float32), scale, bias)
        if c.relu:
            y = torch.clamp(y, min=0.0)
        y = y * f32(mult, y.device)
        return torch.clamp(torch.round(y) + zp, self.act.qmin, self.act.qmax)

    def _int8_hswish(self, q: torch.Tensor, name: str) -> torch.Tensor:
        (s, z), (zs, hi), m, _ = self.frozen[name]
        dev = q.device
        gate = torch.clamp(q, zs, hi)
        y = ((q - z) * f32(s, dev)) * ((gate - zs) * f32(s, dev))
        return self._requant(y, m)

    def _dequant(self, q, grid):
        return (q - grid[1]) * f32(grid[0], q.device)

    def _int8_se(self, q: torch.Tensor, x_grid, name: str, out_grid) -> torch.Tensor:
        xf = self._dequant(q, x_grid)
        s = spatial_mean(xf)
        for fc, relu in (("fc1", True), ("fc2", False)):
            wq, (gs, gz) = self.frozen[f"{name}.{fc}"]
            s = exact_matmul(s, wq)
            if relu:
                s = torch.relu(s)
            st = f32(gs, s.device)
            inv = torch.ones((), dtype=torch.float32, device=s.device) / st
            s = (torch.clamp(torch.round(s * inv) + gz, self.act.qmin, self.act.qmax) - gz) * st
        s = torch.clamp(s + 3.0, 0.0, 6.0) * f32(SIXTH, s.device)
        return self._requant(xf * s[:, None, None, :], out_grid)

    @torch.no_grad()
    def forward_int8(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) float images -> (B, H, W, classes) float32 logits of
        the frozen graph (codes held as float32 integers)."""
        size = tuple(x.shape[1:3])
        s, z = self.frozen["quant"]
        q = self._requant(x, (s, z))
        g = self.frozen["backbone.conv1_hs"][3]
        q = self._int8_hswish(self._int8_conv(q, self.stem), "backbone.conv1_hs")
        c1 = None
        for i, b in enumerate(self.blocks):
            xq, xg = q, g
            out = self._int8_conv(q, b.expand)
            g = self.frozen[b.expand.name][5]
            if b.hs:
                out = self._int8_hswish(out, f"{b.name}.expand_hs")
                g = self.frozen[f"{b.name}.expand_hs"][3]
            out = self._int8_conv(out, b.depthwise)
            g = self.frozen[b.depthwise.name][5]
            if b.se:
                sg = self._grid(f"{b.name}.se.quant_mul.act")
                out, g = self._int8_se(out, g, f"{b.name}.se", sg), sg
            if b.hs:
                out = self._int8_hswish(out, f"{b.name}.dw_hs")
            else:
                out = torch.maximum(out, torch.full((), float(g[1]), device=out.device))
            out = self._int8_conv(out, b.project)
            g = self.frozen[b.project.name][5]
            if b.residual:
                ((sa, za), (sb, zb)), og = self.frozen[f"{b.name}.skip_add"]
                dev = out.device
                y = (xq - za) * f32(sa, dev) + (out - zb) * f32(sb, dev)
                out, g = self._requant(y, og), og
            q = out
            if i == self.stage_ends[1]:
                c1, c1g = q, g
        q = self._int8_hswish(self._int8_conv(q, self.layer5), "backbone.layer5_hs")
        g = self.frozen["backbone.layer5_hs"][3]
        hw = tuple(q.shape[1:3])
        f1 = self._int8_conv(q, self.b0)
        f1g = self.frozen[self.b0.name][5]
        win = min(self.pool[0], *hw)
        pooled = F.avg_pool2d(q.permute(0, 3, 1, 2).to(torch.float64), win, min(self.pool[1], win),
                              divisor_override=1).to(torch.float32).permute(0, 2, 3, 1)
        pooled = torch.clamp(torch.round(pooled * f32(recip(float(win * win)), q.device)), 0, 255)
        f2 = self._int8_conv(pooled, self.b1)
        zs, hi, s6 = self.frozen["b1_hsig"]
        f2 = resize((torch.clamp(f2, zs, hi) - zs) * f32(s6, f2.device), hw)
        c4 = self._requant(self._dequant(f1, f1g) * f2, self.frozen["head_mul"])
        c4 = resize(self._dequant(c4, self.frozen["head_mul"]), tuple(c1.shape[1:3]))
        st = self.state
        tail = []
        for conv, feat in ((self.aux, self._dequant(c1, c1g)), (self.proj, c4)):
            y = self._conv2d(feat, st[f"{conv.name}.kernel"].detach(), conv)
            tail.append(y + st[f"{conv.name}.bias"].detach())
        return resize(tail[0] + tail[1], size)


Reference = SegReference


def shape_tables(arch: dict, image_size) -> dict:
    """The shape tables at one image of ``image_size`` ((H, W)): ``convs``
    ``[name, ho, wo, cin, cout, k, groups]`` (the float tail's and the
    squeeze-excite's dense layers, as 1x1 maps, included),
    the QAT step's per-tensor fake-quant ``sites`` ``[name, elements an
    image, elements fixed]`` in forward order, and the INT8 forward's
    ``matmuls`` ``[name, M an image, K, N]`` (the 1x1s and the stem by
    im2col at its own K)."""
    stem, blocks, stage_ends, layer5, b0, b1, proj, aux = build_layers(arch)
    h, w = image_size
    convs, sites, matmuls = [], [["quant.act", h * w * 3, 0]], []

    def out_hw(c, hw):
        return tuple((n + 2 * c.pad - c.dilation * (c.k - 1) - 1) // c.stride + 1 for n in hw)

    def conv(c, hw):
        ho, wo = out_hw(c, hw)
        convs.append([c.name, ho, wo, c.cin, c.cout, c.k, c.groups])
        if c.quantized:
            sites.append([f"{c.name}.w_obs", 0, c.k * c.k * (c.cin // c.groups) * c.cout])
            sites.append([f"{c.name}.act_obs", ho * wo * c.cout, 0])
            if c.groups == 1:
                matmuls.append([c.name, ho * wo, c.k * c.k * c.cin, c.cout])
        return ho, wo

    def hswish(name, hw, ch):
        n = hw[0] * hw[1] * ch
        sites.extend([[f"{name}.relu6_obs", n, 0], [f"{name}.quant_mul.act", n, 0]])

    hw = conv(stem, (h, w))
    hswish("backbone.conv1_hs", hw, stem.cout)
    c1_hw = None
    for i, b in enumerate(blocks):
        hw = conv(b.expand, hw)
        if b.hs:
            hswish(f"{b.name}.expand_hs", hw, b.expand.cout)
        hw = conv(b.depthwise, hw)
        if b.se:
            ch, red = b.se
            convs.extend([[f"{b.name}.se.fc1", 1, 1, ch, red, 1, 1],
                          [f"{b.name}.se.fc2", 1, 1, red, ch, 1, 1]])
            sites.extend([[f"{b.name}.se.fc1.w_obs", 0, ch * red], [f"{b.name}.se.fc1.act_obs", red, 0],
                          [f"{b.name}.se.fc2.w_obs", 0, red * ch], [f"{b.name}.se.fc2.act_obs", ch, 0],
                          [f"{b.name}.se.hsig.relu6_obs", ch, 0],
                          [f"{b.name}.se.quant_mul.act", hw[0] * hw[1] * ch, 0]])
        if b.hs:
            hswish(f"{b.name}.dw_hs", hw, b.depthwise.cout)
        hw = conv(b.project, hw)
        if b.residual:
            sites.append([f"{b.name}.skip_add.act", hw[0] * hw[1] * b.project.cout, 0])
        if i == stage_ends[1]:
            c1_hw = hw
    hw = conv(layer5, hw)
    hswish("backbone.layer5_hs", hw, layer5.cout)
    conv(b0, hw)
    win = min(arch["pool"][0], *hw)
    stride = min(arch["pool"][1], win)
    pooled = tuple((n - win) // stride + 1 for n in hw)
    conv(b1, pooled)
    sites.append(["head.lr_aspp.b1_hsig.relu6_obs", pooled[0] * pooled[1] * b1.cout, 0])
    sites.append(["head.lr_aspp.quant_mul.act", hw[0] * hw[1] * b0.cout, 0])
    conv(aux, c1_hw)
    conv(proj, c1_hw)
    return {"convs": convs, "sites": sites, "matmuls": matmuls}
