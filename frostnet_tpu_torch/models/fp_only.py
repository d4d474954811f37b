"""The float-only baselines: DenseNet, SqueezeNet, MNASNet and Inception-v3
(``frostnet_tpu/models/fp_only.py``).

Module and variable names are the JAX package's (the convs are float
``QConvBNAct`` blocks; DenseNet's pre-activation norms are flax
``BatchNorm``s, :class:`BatchNorm` here; the dense classifiers are the
top-level parameters ``classifier_kernel``/``classifier_bias`` or, on
Inception-v3, ``fc_kernel``/``fc_bias``). They hold no observers.

``forward(x, mode, train, generator)`` runs FP32, with dropout drawn from
``generator`` in train mode. The JAX models take no quantized mode at all
(their ``__call__(x, train)`` has no ``mode`` argument, so the JAX trainer
and evaluator refuse them with a ``TypeError``); the port runs them through
its trainer's FP32 steps and raises ``TypeError`` for QAT, QAT_FROZEN and
INT8, and for ``prepare_int8``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..nn import FP32, QConvBNAct, QuantMode, max_pool
from .frostnet import dropout

FLOAT_ONLY = ("{} is a float-only baseline: the JAX model takes no quantized mode "
              "(frostnet_tpu/models/fp_only.py, __call__(x, train)); it runs FP32 only")


class BatchNorm(nn.Module):
    """flax ``BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channels of
    NHWC ``x``: in train mode the batch mean and biased variance normalize
    and move the running statistics (``0.9 * running + 0.1 * batch``)."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            mean = x.mean(dim=(0, 1, 2))
            var = (x * x).mean(dim=(0, 1, 2)) - mean * mean
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_((1 - self.momentum) * mean)
                self.var.mul_(self.momentum).add_((1 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        return (x - mean) * torch.rsqrt(var + self.eps) * self.scale + self.bias


def _avg_pool_same(x: torch.Tensor) -> torch.Tensor:
    """flax ``avg_pool`` 3x3, stride 1, padding 1: the window sum over 9."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), 3, 1, 1, count_include_pad=True)
    return y.permute(0, 2, 3, 1)


def _conv(cin, cout, k, s=1, p=0, groups=1, act="relu", use_bn=True, bias=False, bn_eps=1e-5):
    return QConvBNAct(cin, cout, k, strides=s, padding=p, groups=groups, act=act, use_bn=use_bn,
                      use_bias=bias, quantized=False, bn_eps=bn_eps)


class _FloatOnly(nn.Module):
    """The mode guard and dropout of the float-only baselines."""

    drop_rate = 0.0

    def _check(self, mode: QuantMode) -> None:
        if mode.fake_quant or mode.observe or mode.int8:
            raise TypeError(FLOAT_ONLY.format(type(self).__name__))

    def prepare_int8(self, device, image_size: int = 224) -> None:
        raise TypeError(FLOAT_ONLY.format(type(self).__name__))

    def _dropout(self, x, train: bool, generator):
        return dropout(x, self.drop_rate, generator) if train and self.drop_rate > 0 else x

    def _dense(self, x, prefix: str):
        return x @ getattr(self, f"{prefix}_kernel") + getattr(self, f"{prefix}_bias")


class DenseLayer(nn.Module):
    def __init__(self, in_channels: int, growth_rate: int, bn_size: int = 4):
        super().__init__()
        self.norm1 = BatchNorm(in_channels)
        self.conv1 = _conv(in_channels, bn_size * growth_rate, 1, act=None, use_bn=False)
        self.norm2 = BatchNorm(bn_size * growth_rate)
        self.conv2 = _conv(bn_size * growth_rate, growth_rate, 3, p=1, act=None, use_bn=False)

    def forward(self, x, train: bool = False):
        y = self.conv1(torch.relu(self.norm1(x, train)), FP32, train)
        y = self.conv2(torch.relu(self.norm2(y, train)), FP32, train)
        return torch.cat([x, y], dim=-1)


class DenseNet(_FloatOnly):
    """DenseNet-BC (121/169/201 by ``block_config``)."""

    def __init__(self, growth_rate: int = 32, block_config: Sequence[int] = (6, 12, 24, 16),
                 num_init_features: int = 64, num_classes: int = 1000):
        super().__init__()
        self.num_classes = num_classes
        self.stem = _conv(3, num_init_features, 7, 2, 3)
        self.stages, c = [], num_init_features
        for bi, n in enumerate(block_config):
            layers = []
            for li in range(n):
                layer = DenseLayer(c, growth_rate)
                self.add_module(f"block{bi}_layer{li}", layer)
                layers.append(layer)
                c += growth_rate
            trans = None
            if bi != len(block_config) - 1:
                norm, conv = BatchNorm(c), _conv(c, c // 2, 1, act=None, use_bn=False)
                self.add_module(f"trans{bi}_norm", norm)
                self.add_module(f"trans{bi}_conv", conv)
                trans, c = (norm, conv), c // 2
            self.stages.append((layers, trans))
        self.norm_final = BatchNorm(c)
        self.classifier_kernel = nn.Parameter(torch.zeros(c, num_classes))
        self.classifier_bias = nn.Parameter(torch.zeros(num_classes))

    def forward(self, x, mode: QuantMode = FP32, train: bool = False,
                generator: Optional[torch.Generator] = None):
        self._check(mode)
        x = max_pool(self.stem(x, FP32, train), 3, 2, padding=1)
        for layers, trans in self.stages:
            for layer in layers:
                x = layer(x, train)
            if trans is not None:
                x = trans[1](torch.relu(trans[0](x, train)), FP32, train)
                x = F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        x = torch.relu(self.norm_final(x, train)).mean(dim=(1, 2))
        return self._dense(x, "classifier")


class Fire(nn.Module):
    def __init__(self, in_channels: int, squeeze: int, expand1: int, expand3: int):
        super().__init__()
        self.squeeze = _conv(in_channels, squeeze, 1, use_bn=False, bias=True)
        self.expand1x1 = _conv(squeeze, expand1, 1, use_bn=False, bias=True)
        self.expand3x3 = _conv(squeeze, expand3, 3, p=1, use_bn=False, bias=True)

    def forward(self, x, train: bool = False):
        s = self.squeeze(x, FP32, train)
        return torch.cat([self.expand1x1(s, FP32, train), self.expand3x3(s, FP32, train)], -1)


SQUEEZENET_CFGS = {
    "1_0": (96, 7, [(16, 64, 64), (16, 64, 64), (32, 128, 128), "M", (32, 128, 128),
                    (48, 192, 192), (48, 192, 192), (64, 256, 256), "M", (64, 256, 256)]),
    "1_1": (64, 3, [(16, 64, 64), (16, 64, 64), "M", (32, 128, 128), (32, 128, 128), "M",
                    (48, 192, 192), (48, 192, 192), (64, 256, 256), (64, 256, 256)]),
}


class SqueezeNet(_FloatOnly):
    def __init__(self, version: str = "1_1", num_classes: int = 1000, drop_rate: float = 0.5):
        super().__init__()
        self.num_classes, self.drop_rate = num_classes, drop_rate
        stem_c, stem_k, cfg = SQUEEZENET_CFGS[version]
        self.stem = _conv(3, stem_c, stem_k, 2, use_bn=False, bias=True)
        self.layers, c = [], stem_c
        for v in cfg:
            if v == "M":
                self.layers.append("M")
                continue
            fire = Fire(c, *v)
            self.add_module(f"fire{sum(l != 'M' for l in self.layers)}", fire)
            self.layers.append(fire)
            c = v[1] + v[2]
        self.final_conv = _conv(c, num_classes, 1, use_bn=False, bias=True)

    def forward(self, x, mode: QuantMode = FP32, train: bool = False,
                generator: Optional[torch.Generator] = None):
        self._check(mode)
        x = max_pool(self.stem(x, FP32, train), 3, 2)
        for layer in self.layers:
            x = max_pool(x, 3, 2) if layer == "M" else layer(x, train)
        x = self.final_conv(self._dropout(x, train, generator), FP32, train)
        return x.mean(dim=(1, 2))


# MNASNet-B1 blocks: (expansion, channels, repeats, stride, kernel)
MNASNET_BLOCKS = [(3, 24, 3, 2, 3), (3, 40, 3, 2, 5), (6, 80, 3, 2, 5), (6, 96, 2, 1, 3),
                  (6, 192, 4, 2, 5), (6, 320, 1, 1, 3)]


class MNASNet(_FloatOnly):
    """MNASNet-B1 (torchvision's ``mnasnet1_0`` spec, ``alpha`` scales it)."""

    def __init__(self, alpha: float = 1.0, num_classes: int = 1000, drop_rate: float = 0.2):
        super().__init__()
        self.num_classes, self.drop_rate = num_classes, drop_rate

        def depths(d):
            return max(32 // 8, int(d * alpha + 4) // 8 * 8)

        d32, d16 = depths(32), depths(16)
        self.stem = _conv(3, d32, 3, 2, 1)
        self.sep_dw = _conv(d32, d32, 3, 1, 1, groups=d32)
        self.sep_pw = _conv(d32, d16, 1, act=None)
        self.blocks, c = [], d16
        for bi, (t, ch, n, s, k) in enumerate(MNASNET_BLOCKS):
            out_c = depths(ch)
            for i in range(n):
                stride, hidden = s if i == 0 else 1, c * t
                convs = (_conv(c, hidden, 1), _conv(hidden, hidden, k, stride, k // 2, groups=hidden),
                         _conv(hidden, out_c, 1, act=None))
                for suffix, conv in zip(("pw", "dw", "lin"), convs):
                    self.add_module(f"b{bi}_{i}_{suffix}", conv)
                self.blocks.append((convs, stride == 1 and c == out_c))
                c = out_c
        self.head = _conv(c, 1280, 1)
        self.classifier_kernel = nn.Parameter(torch.zeros(1280, num_classes))
        self.classifier_bias = nn.Parameter(torch.zeros(num_classes))

    def forward(self, x, mode: QuantMode = FP32, train: bool = False,
                generator: Optional[torch.Generator] = None):
        self._check(mode)
        for conv in (self.stem, self.sep_dw, self.sep_pw):
            x = conv(x, FP32, train)
        for convs, residual in self.blocks:
            y = x
            for conv in convs:
                y = conv(y, FP32, train)
            x = x + y if residual else y
        x = self.head(x, FP32, train).mean(dim=(1, 2))
        return self._dense(self._dropout(x, train, generator), "classifier")


def _inception_a(cin: int, pool_f: int):
    return [("b1", cin, 64, 1, 1, 0, None), ("b2a", cin, 48, 1, 1, 0, None),
            ("b2b", 48, 64, 5, 1, 2, "b2a"), ("b3a", cin, 64, 1, 1, 0, None),
            ("b3b", 64, 96, 3, 1, 1, "b3a"), ("b3c", 96, 96, 3, 1, 1, "b3b"),
            ("b4", cin, pool_f, 1, 1, 0, "pool")], ("b1", "b2b", "b3c", "b4")


def _inception_b(ch7: int):
    return [("b1", 768, 192, 1, 1, 0, None), ("b2a", 768, ch7, 1, 1, 0, None),
            ("b2b", ch7, ch7, (1, 7), 1, (0, 3), "b2a"),
            ("b2c", ch7, 192, (7, 1), 1, (3, 0), "b2b"), ("b3a", 768, ch7, 1, 1, 0, None),
            ("b3b", ch7, ch7, (7, 1), 1, (3, 0), "b3a"),
            ("b3c", ch7, ch7, (1, 7), 1, (0, 3), "b3b"),
            ("b3d", ch7, ch7, (7, 1), 1, (3, 0), "b3c"),
            ("b3e", ch7, 192, (1, 7), 1, (0, 3), "b3d"),
            ("b4", 768, 192, 1, 1, 0, "pool")], ("b1", "b2c", "b3e", "b4")


def _inception_c(cin: int):
    return [("b1", cin, 320, 1, 1, 0, None), ("b2a", cin, 384, 1, 1, 0, None),
            ("b2b", 384, 384, (1, 3), 1, (0, 1), "b2a"),
            ("b2c", 384, 384, (3, 1), 1, (1, 0), "b2a"), ("b3a", cin, 448, 1, 1, 0, None),
            ("b3b", 448, 384, 3, 1, 1, "b3a"), ("b3c", 384, 384, (1, 3), 1, (0, 1), "b3b"),
            ("b3d", 384, 384, (3, 1), 1, (1, 0), "b3b"),
            ("b4", cin, 192, 1, 1, 0, "pool")], ("b1", "b2b", "b2c", "b3c", "b3d", "b4")


# (name, branches, outputs) of the mixed blocks after the stem, in order; a
# branch is (name, in, out, kernel, stride, padding, its input: None the
# block's, "pool" the block's 3x3 average pool, else another branch's);
# a reduction's max pool of the block input is the last output ("max")
INCEPTION_BLOCKS = [
    ("mixed0", *_inception_a(192, 32)), ("mixed1", *_inception_a(256, 64)),
    ("mixed2", *_inception_a(288, 64)),
    ("redA", [("b1", 288, 384, 3, 2, 0, None), ("b2a", 288, 64, 1, 1, 0, None),
              ("b2b", 64, 96, 3, 1, 1, "b2a"), ("b2c", 96, 96, 3, 2, 0, "b2b")],
     ("b1", "b2c", "max")),
    ("mixed4", *_inception_b(128)), ("mixed5", *_inception_b(160)),
    ("mixed6", *_inception_b(160)), ("mixed7", *_inception_b(192)),
    ("redB", [("b1a", 768, 192, 1, 1, 0, None), ("b1b", 192, 320, 3, 2, 0, "b1a"),
              ("b2a", 768, 192, 1, 1, 0, None), ("b2b", 192, 192, (1, 7), 1, (0, 3), "b2a"),
              ("b2c", 192, 192, (7, 1), 1, (3, 0), "b2b"), ("b2d", 192, 192, 3, 2, 0, "b2c")],
     ("b1b", "b2d", "max")),
    ("mixed9", *_inception_c(1280)), ("mixed10", *_inception_c(2048)),
]


class InceptionV3(_FloatOnly):
    """Inception-v3 without the auxiliary classifier (299x299 inputs); every
    conv has BN with ``eps=1e-3``."""

    def __init__(self, num_classes: int = 1000, drop_rate: float = 0.5):
        super().__init__()
        self.num_classes, self.drop_rate = num_classes, drop_rate

        def c(cin, cout, k, s=1, p=0):
            return _conv(cin, cout, k, s, p, bn_eps=1e-3)

        self.c1, self.c2, self.c3 = c(3, 32, 3, 2), c(32, 32, 3), c(32, 64, 3, 1, 1)
        self.c4, self.c5 = c(64, 80, 1), c(80, 192, 3)
        self.mixed = []
        for name, branches, outputs in INCEPTION_BLOCKS:
            convs = {}
            for bname, cin, cout, k, s, p, src in branches:
                convs[bname] = (c(cin, cout, k, s, p), src)
                self.add_module(f"{name}_{bname}", convs[bname][0])
            self.mixed.append((convs, outputs))
        self.fc_kernel = nn.Parameter(torch.zeros(2048, num_classes))
        self.fc_bias = nn.Parameter(torch.zeros(num_classes))

    def forward(self, x, mode: QuantMode = FP32, train: bool = False,
                generator: Optional[torch.Generator] = None):
        self._check(mode)
        for conv in (self.c1, self.c2, self.c3):
            x = conv(x, FP32, train)
        x = max_pool(x, 3, 2)
        x = max_pool(self.c5(self.c4(x, FP32, train), FP32, train), 3, 2)
        for convs, outputs in self.mixed:
            got = {}
            for bname, (conv, src) in convs.items():
                inp = x if src is None else _avg_pool_same(x) if src == "pool" else got[src]
                got[bname] = conv(inp, FP32, train)
            got["max"] = max_pool(x, 3, 2) if "max" in outputs else None
            x = torch.cat([got[o] for o in outputs], dim=-1)
        x = self._dropout(x.mean(dim=(1, 2)), train, generator)
        return self._dense(x, "fc")


def fp_only_factories():
    """The JAX registry's float-only names (1000 classes by default)."""
    def make(cls, **fixed):
        return lambda **kw: cls(**fixed, **{"num_classes": 1000, **kw})

    return {"densenet121": make(DenseNet, block_config=(6, 12, 24, 16)),
            "densenet169": make(DenseNet, block_config=(6, 12, 32, 32)),
            "densenet201": make(DenseNet, block_config=(6, 12, 48, 32)),
            "squeezenet1_0": make(SqueezeNet, version="1_0"),
            "squeezenet1_1": make(SqueezeNet, version="1_1"),
            "mnasnet0_5": make(MNASNet, alpha=0.5), "mnasnet1_0": make(MNASNet, alpha=1.0),
            "inception_v3": make(InceptionV3)}
