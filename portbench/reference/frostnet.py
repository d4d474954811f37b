"""Plain PyTorch reference of FrostNet's QAT training step and INT8 serving.

Independent of the program under test: nothing here imports
``frostnet_tpu_torch`` or JAX. The model is built from the configuration's
own stage table; its parameter and buffer names are those of the port's
``models/frostnet.py`` (``conv1.kernel``, ``layer3_1.conv2.w_obs.min_val``),
so the benchmark hands one set of seeded weights to both sides.

What it computes, NHWC throughout, float32:

* FP32 (the StatAssist warm-up): conv, BN on batch statistics, ReLU.
* QAT: the ``ConvBn2d`` QAT recipe: ``sf = gamma / sqrt(var + eps)``, the
  weight ``w * sf`` observed and fake-quantized, conv, ``/ sf``, BN on batch
  statistics, ReLU, the activation observed and fake-quantized; the
  classifier's weight fake-quantized as it is. Observers are moving-average
  min/max (constant 0.01, the first batch snaps), per tensor; the traced
  qparams multiply the range by ``f32(1 / span)``; the fake-quant's
  gradient is the straight-through estimator masked to the grid.
* QSGD with GradBoost: per-element EMAs of min/max ``|g|``, after the
  warm-up the sign-aligned, coin-masked ``Exponential(1)`` noise clipped to
  ``clip_by``, then L2 decay by shape group, heavy-ball momentum, ``p -=
  lr * buf``. The noise is drawn from a ``torch.Generator`` seeded as the
  benchmark seeds the program's, in the same order.
* INT8: calibration (QAT forwards in train mode), the BN fold, weight codes
  on the weight observer's grid, and the integer forward: exact int
  accumulators (float64 convs of ``q - zp``), the epilogue
  ``fma(acc, comb, bias)``, ReLU, ``* f32(1 / s_out)``, round, clamp.

``act``/``weight`` specs choose the grid (8 or 4 bits) and ``tf32`` rounds
the conv operands to TF32: the lower precisions of the control.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.quant import (  # noqa: F401
    ACT4, ACT8, BN_EPS, WEIGHT4, WEIGHT8, Grid, QSGDReference, batch_norm_train, f32, fma_f32,
    no_tf32, observe_fake_quant, prep_image, qparams, recip, tf32_round)


@dataclasses.dataclass(frozen=True)
class Conv:
    name: str
    cin: int
    cout: int
    k: int
    stride: int = 1
    groups: int = 1
    bn: bool = True
    bias: bool = False
    relu: bool = True

    @property
    def pad(self) -> int:
        return (self.k - 1) // 2


@dataclasses.dataclass(frozen=True)
class Block:
    name: str
    cin: int
    cout: int
    squeeze: Optional[Conv]
    expand: Optional[Conv]
    depthwise: Conv
    reduce: Conv
    residual: bool


def make_divisible(v, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    return new_v + divisor if new_v < 0.9 * v else new_v


def build_layers(arch: dict) -> Tuple[Conv, List[Block], Conv, Conv]:
    """(stem, blocks, last_layer, classifier) from the configuration's table:
    ``stages`` of ``[kernel, channels, expand, reduce, stride]`` rows."""
    width = arch.get("width_mult", 1.0)
    stem_c = make_divisible(int(32 * min(1.0, width)))
    stem = Conv("conv1", 3, stem_c, 3, stride=2)
    blocks, c = [], stem_c
    for si, stage in enumerate(arch["stages"]):
        for i, (k, ch, e, r, s) in enumerate(stage):
            out_c = make_divisible(int(ch * width))
            name = f"layer{si + 1}_{i}"
            r_c = make_divisible(c // r)
            has_expand = e != 1
            has_squeeze = has_expand and c // r >= 8
            n_c = c + (r_c if has_squeeze else 0)
            ec = n_c * e if has_expand else c
            blocks.append(Block(
                name, c, out_c,
                Conv(f"{name}.squeeze_conv", c, r_c, 1) if has_squeeze else None,
                Conv(f"{name}.conv1", n_c, ec, 1) if has_expand else None,
                Conv(f"{name}.conv2", ec, ec, k, stride=s, groups=ec),
                Conv(f"{name}.reduce_conv", ec, out_c, 1, relu=False),
                s == 1 and c == out_c))
            c = out_c
    last = Conv("last_layer", c, arch["last_channels"], 1)
    head = Conv("classifier", arch["last_channels"], arch["num_classes"], 1, bn=False,
                bias=True, relu=False)
    return stem, blocks, last, head


def param_specs(arch: dict) -> List[Tuple[str, tuple, str]]:
    """Every parameter and buffer as (name, shape, kind), parameters in the
    port's registration order (the optimizer's flat order) first."""
    stem, blocks, last, head = build_layers(arch)
    convs = [stem] + [c for b in blocks for c in (b.squeeze, b.expand, b.depthwise, b.reduce)
                      if c is not None] + [last, head]
    params, buffers = [], [("quant.act.min_val", (), "min"), ("quant.act.max_val", (), "max")]
    for c in convs:
        params.append((f"{c.name}.kernel", (c.k, c.k, c.cin // c.groups, c.cout), "kernel"))
        if c.bias:
            params.append((f"{c.name}.bias", (c.cout,), "zeros"))
        if c.bn:
            params += [(f"{c.name}.scale", (c.cout,), "ones"),
                       (f"{c.name}.bias_bn", (c.cout,), "zeros")]
            buffers += [(f"{c.name}.mean", (c.cout,), "zeros"), (f"{c.name}.var", (c.cout,), "ones")]
        for obs in ("w_obs", "act_obs"):
            buffers += [(f"{c.name}.{obs}.min_val", (), "min"),
                        (f"{c.name}.{obs}.max_val", (), "max")]
    for b in blocks:
        for site, on in (("quant_cat", b.squeeze is not None), ("skip_add", b.residual)):
            if on:
                buffers += [(f"{b.name}.{site}.act.min_val", (), "min"),
                            (f"{b.name}.{site}.act.max_val", (), "max")]
    return params + buffers


class FrostNetReference:
    """The reference model: ``state`` holds every parameter and buffer by
    name (the benchmark's seeded values, copied), ``params`` the trainable
    ones in the optimizer's order."""

    def __init__(self, arch: dict, weights: Dict[str, torch.Tensor], act: Grid = ACT8,
                 weight: Grid = WEIGHT8, tf32: bool = False):
        self.arch, self.act, self.weight, self.tf32 = arch, act, weight, tf32
        self.stem, self.blocks, self.last, self.head = build_layers(arch)
        specs = param_specs(arch)
        self.state = {n: weights[n].detach().clone() for n, _, _ in specs}
        self.param_names = [n for n, _, kind in specs
                            if not n.endswith(("min_val", "max_val", ".mean", ".var"))]
        for n in self.param_names:
            self.state[n].requires_grad_(True)
        self.drop_rate = arch["drop_rate"]

    @property
    def params(self) -> List[torch.Tensor]:
        return [self.state[n] for n in self.param_names]

    # -- float phases --------------------------------------------------------

    def _fq(self, x: torch.Tensor, site: str, g: Grid, qat: bool) -> torch.Tensor:
        if not qat:
            return x
        return observe_fake_quant(x, self.state[f"{site}.min_val"], self.state[f"{site}.max_val"], g)

    def _conv2d(self, x: torch.Tensor, w: torch.Tensor, c: Conv) -> torch.Tensor:
        xt = x.permute(0, 3, 1, 2)
        wt = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        if self.tf32:
            xt, wt = tf32_round(xt), tf32_round(wt)
        return F.conv2d(xt, wt, None, c.stride, c.pad, 1, c.groups).permute(0, 2, 3, 1)

    def _conv_bn_act(self, x: torch.Tensor, c: Conv, qat: bool) -> torch.Tensor:
        st = self.state
        k = st[f"{c.name}.kernel"]
        if qat and c.bn:
            sf = st[f"{c.name}.scale"] / torch.sqrt(
                (st[f"{c.name}.var"] + BN_EPS).to(torch.float64)).to(torch.float32)
            w = self._fq(k * sf, f"{c.name}.w_obs", self.weight, True)
            y = self._conv2d(x, w, c) / sf
        else:
            w = self._fq(k, f"{c.name}.w_obs", self.weight, qat)
            y = self._conv2d(x, w, c)
        if c.bias:
            y = y + st[f"{c.name}.bias"]
        if c.bn:
            y = batch_norm_train(y, st[f"{c.name}.scale"], st[f"{c.name}.bias_bn"],
                                 st[f"{c.name}.mean"], st[f"{c.name}.var"])
        if c.relu:
            y = F.relu(y)
        return self._fq(y, f"{c.name}.act_obs", self.act, qat)

    def forward_train(self, x: torch.Tensor, qat: bool,
                      generator: Optional[torch.Generator]) -> torch.Tensor:
        """(B, S, S, 3) float images -> (B, classes) logits in train mode;
        observers and BN statistics step once."""
        x = self._fq(x, "quant.act", self.act, qat)
        x = self._conv_bn_act(x, self.stem, qat)
        for b in self.blocks:
            out = x
            if b.squeeze is not None:
                sq = self._conv_bn_act(x, b.squeeze, qat)
                out = self._fq(torch.cat([sq, x], dim=-1), f"{b.name}.quant_cat.act",
                               self.act, qat)
            if b.expand is not None:
                out = self._conv_bn_act(out, b.expand, qat)
            out = self._conv_bn_act(self._conv_bn_act(out, b.depthwise, qat), b.reduce, qat)
            if b.residual:
                out = self._fq(x + out, f"{b.name}.skip_add.act", self.act, qat)
            x = out
        x = self._conv_bn_act(x, self.last, qat).mean(dim=(1, 2), keepdim=True)
        if self.drop_rate > 0:
            keep = 1.0 - self.drop_rate
            mask = torch.empty(x.shape, device=x.device).bernoulli_(keep, generator=generator)
            x = torch.where(mask.bool(), x / torch.full((), keep, device=x.device),
                            torch.zeros((), device=x.device))
        x = self._conv_bn_act(x, self.head, qat)
        return x.reshape(x.shape[0], x.shape[-1])

    # -- INT8 ----------------------------------------------------------------

    def _grid(self, site: str, g: Grid) -> Tuple[float, int]:
        s, z = qparams(self.state[f"{site}.min_val"].detach(),
                       self.state[f"{site}.max_val"].detach(), g, traced=False)
        return float(s), int(z)

    def freeze(self) -> None:
        """The frozen graph's constants from the calibrated state."""
        self.frozen = {}
        with torch.no_grad():
            g = self._grid("quant.act", self.act)
            self.frozen["quant"] = g
            g = self._freeze_conv(self.stem, g)
            for b in self.blocks:
                x = g
                if b.squeeze is not None:
                    sq = self._freeze_conv(b.squeeze, x)
                    g = self._grid(f"{b.name}.quant_cat.act", self.act)
                    self.frozen[f"{b.name}.quant_cat"] = ([sq, x], g)
                if b.expand is not None:
                    g = self._freeze_conv(b.expand, g)
                g = self._freeze_conv(b.reduce, self._freeze_conv(b.depthwise, g))
                if b.residual:
                    out = self._grid(f"{b.name}.skip_add.act", self.act)
                    self.frozen[f"{b.name}.skip_add"] = ([x, g], out)
                    g = out
            g = self._freeze_conv(self.last, g)
            self._freeze_conv(self.head, g)

    def _freeze_conv(self, c: Conv, x: Tuple[float, int]) -> Tuple[float, int]:
        st = self.state
        dev = st[f"{c.name}.kernel"].device
        w = st[f"{c.name}.kernel"].detach()
        if c.bn:
            sf = st[f"{c.name}.scale"].detach() / torch.sqrt(
                (st[f"{c.name}.var"] + BN_EPS).to(torch.float64)).to(torch.float32)
            wf = w * sf
            b = torch.zeros_like(sf) if not c.bias else st[f"{c.name}.bias"].detach()
            bias = (b - st[f"{c.name}.mean"]) * sf + st[f"{c.name}.bias_bn"].detach()
        else:
            wf, bias = w, st[f"{c.name}.bias"].detach().to(torch.float32)
        ws, _ = qparams(st[f"{c.name}.w_obs.min_val"], st[f"{c.name}.w_obs.max_val"],
                        self.weight, traced=False)
        qw = torch.clamp(torch.round(wf / ws), self.weight.qmin, self.weight.qmax)
        out = self._grid(f"{c.name}.act_obs", self.act)
        comb = torch.tensor(x[0], dtype=torch.float32, device=dev) * ws
        inv = recip(out[0])
        if not c.relu and bool(torch.all(bias == 0)):
            scale, bias, mult = (comb * f32(inv, dev)).expand(c.cout).clone(), torch.zeros_like(bias), 1.0
        else:
            scale, mult = comb.expand(c.cout).clone(), inv
        self.frozen[c.name] = (qw.to(torch.float64).permute(3, 2, 0, 1).contiguous(), x[1],
                               scale, bias.to(torch.float32), mult, out)
        return out

    def _int8_conv(self, q: torch.Tensor, c: Conv) -> torch.Tensor:
        w64, zp_in, scale, bias, mult, (_, zp) = self.frozen[c.name]
        xs = (q.to(torch.float64) - zp_in).permute(0, 3, 1, 2)
        acc = torch.round(F.conv2d(xs, w64, None, c.stride, c.pad, 1, c.groups))
        y = fma_f32(acc.permute(0, 2, 3, 1).to(torch.float32), scale, bias)
        if c.relu:
            y = torch.clamp(y, min=0.0)
        y = y * f32(mult, y.device)
        return torch.clamp(torch.round(y) + zp, self.act.qmin, self.act.qmax)

    @torch.no_grad()
    def forward_int8(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, S, 3) float images -> (B, classes) logits of the frozen
        integer graph (codes held as float32 integers)."""
        a = self.act
        s, z = self.frozen["quant"]
        q = torch.clamp(torch.round(x * f32(recip(s), x.device)) + z, a.qmin, a.qmax)
        q = self._int8_conv(q, self.stem)
        for b in self.blocks:
            xq, out = q, q
            if b.squeeze is not None:
                sq = self._int8_conv(q, b.squeeze)
                grids, (so, zo) = self.frozen[f"{b.name}.quant_cat"]
                parts = [torch.clamp(torch.round((t - zi) * f32(si, t.device)
                                                 * f32(recip(so), t.device)) + zo, a.qmin, a.qmax)
                         for t, (si, zi) in zip((sq, q), grids)]
                out = torch.cat(parts, dim=-1)
            if b.expand is not None:
                out = self._int8_conv(out, b.expand)
            out = self._int8_conv(self._int8_conv(out, b.depthwise), b.reduce)
            if b.residual:
                ((sa, za), (sb, zb)), (so, zo) = self.frozen[f"{b.name}.skip_add"]
                dev = out.device
                y = (xq - za) * f32(sa, dev) + (out - zb) * f32(sb, dev)
                out = torch.clamp(torch.round(y * f32(recip(so), dev)) + zo, a.qmin, a.qmax)
            q = out
        q = self._int8_conv(q, self.last)
        n = q.shape[1] * q.shape[2]
        q = torch.clamp(torch.round(q.sum(dim=(1, 2), keepdim=True)
                                    * f32(recip(float(n)), q.device)), 0, 255)
        q = self._int8_conv(q, self.head)
        s, z = self.frozen[self.head.name][5]
        logits = (q - z) * f32(s, q.device)
        return logits.reshape(logits.shape[0], logits.shape[-1])

    @torch.no_grad()
    def calibrate(self, batches: Sequence[torch.Tensor], seed: int) -> None:
        """QAT forwards in train mode (observers and BN statistics step),
        the dropout mask from a generator seeded with ``seed``."""
        gen = torch.Generator(device=batches[0].device)
        gen.manual_seed(seed)
        for x in batches:
            self.forward_train(x, True, gen)


Reference = FrostNetReference


def shape_tables(arch: dict, image_size: int) -> dict:
    """The shape tables behind the benchmark's operation and byte counts, a
    forward at one image of ``image_size``: ``convs`` ``[name, ho, wo, cin,
    cout, k, groups]``, the QAT step's per-tensor fake-quant ``sites``
    ``[name, elements an image, elements fixed]`` in forward order, the
    INT8 Frost ``blocks`` ``[name, h, w, cin, cout, k, stride, c_sq, c_e,
    has_expand, residual]`` and the fused forward's ``matmuls`` ``[name, M
    an image, K, N]``."""
    stem, blocks, last, head = build_layers(arch)
    convs, sites, fblocks, matmuls = [], [["quant.act", image_size * image_size * 3, 0]], [], []

    def conv(c: Conv, h: int) -> int:
        ho = (h + 2 * c.pad - c.k) // c.stride + 1
        convs.append([c.name, ho, ho, c.cin, c.cout, c.k, c.groups])
        sites.append([f"{c.name}.w_obs", 0, c.k * c.k * (c.cin // c.groups) * c.cout])
        sites.append([f"{c.name}.act_obs", ho * ho * c.cout, 0])
        return ho

    h = conv(stem, image_size)
    matmuls.append(["conv1", h * h, stem.k * stem.k * stem.cin, stem.cout])
    for b in blocks:
        hin = h
        if b.squeeze is not None:
            conv(b.squeeze, h)
            sites.append([f"{b.name}.quant_cat.act", h * h * (b.squeeze.cout + b.cin), 0])
        if b.expand is not None:
            conv(b.expand, h)
        h = conv(b.reduce, conv(b.depthwise, h))
        if b.residual:
            sites.append([f"{b.name}.skip_add.act", h * h * b.cout, 0])
        fblocks.append([b.name, hin, hin, b.cin, b.cout, b.depthwise.k, b.depthwise.stride,
                        b.squeeze.cout if b.squeeze is not None else 0, b.depthwise.cout,
                        b.expand is not None, b.residual])
    conv(last, h)
    matmuls.append(["last_layer", h * h, last.cin, last.cout])
    conv(head, 1)
    matmuls.append(["classifier", 1, head.cin, head.cout])
    return {"convs": convs, "sites": sites, "blocks": fblocks, "matmuls": matmuls}
