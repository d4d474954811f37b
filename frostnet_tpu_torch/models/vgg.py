"""Quantizable VGG and AlexNet (``frostnet_tpu/models/vgg.py``).

Module names are the JAX package's: ``quant``, the convs ``conv{i}`` (VGG,
3x3 'same', BN or a bias, ReLU; AlexNet ``conv1``-``conv5``: 11x11/4,
5x5, three 3x3, with a bias), max pools (no padding), the map flattened in
NHWC order, then ``fc0`` and ``fc1`` (``QDense`` 4096 wide, ReLU) and
``fc2``, each a float output in every phase, with dropout on float
values in train mode (VGG after ``fc0`` and ``fc1``, AlexNet before them).

The JAX model sizes ``fc0`` from the map it meets (it keeps no adaptive
pool: 7x7 at 224x224); the port needs that width when it builds, so the
constructors take ``image_size`` (224 by default) and compute it.

INT8 routes (``nn/conv.py``): VGG's convs are all dense 3x3 stride 1 and
run the dense conv kernel (the first at 3 input channels); AlexNet's
11x11/4 and 5x5 convs run the im2col matmul, its 3x3s the dense conv
kernel. The ``fc`` layers run as ``QDense`` does (float products of the
fake-quantized weight, exact in float64).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..nn import FP32, QConvBNAct, QDense, QuantMode, QuantStub, dequant, max_pool
from ..quant import QConfig, QNNPACK
from ..quant.qtensor import QTensor
from .mobilenetv2 import _Classifier, _refuse

VGG_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
          512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512,
          "M", 512, 512, 512, 512, "M"],
}


def flatten(x):
    """(B, H, W, C) -> (B, H * W * C) in NHWC order, a QTensor's codes alike."""
    if isinstance(x, QTensor):
        return QTensor(x.q.reshape(x.q.shape[0], -1), x.scale, x.zero_point)
    return x.reshape(x.shape[0], -1)


def _pooled(n: int, window: int, stride: int) -> int:
    return (n - window) // stride + 1


class _DenseHead(_Classifier):
    """``fc0``, ``fc1`` (4096, ReLU) and ``fc2`` over the flattened map."""

    def _build_head(self, in_features: int, num_classes: int, quantized: bool,
                    qconfig: QConfig):
        kw = dict(use_bias=True, quantized=quantized, qconfig=qconfig)
        self.fc0 = QDense(in_features, 4096, act="relu", **kw)
        self.fc1 = QDense(4096, 4096, act="relu", **kw)
        self.fc2 = QDense(4096, num_classes, **kw)

    def _prepare_head(self, device) -> None:
        for fc in (self.fc0, self.fc1, self.fc2):
            fc.prepare_int8(device)
        self._frozen = True

    def _head(self, x, mode: QuantMode, train: bool, generator, drop_first: bool):
        x = flatten(x)
        for fc in (self.fc0, self.fc1):
            if drop_first:
                x = self._dropout(x, mode, train, generator)
            x = fc(x, mode)
            if not drop_first:
                x = self._dropout(x, mode, train, generator)
        return dequant(self.fc2(x, mode))


class VGG(_DenseHead):
    def __init__(self, cfg: str = "D", batch_norm: bool = False, num_classes: int = 1000,
                 drop_rate: float = 0.5, quantized: bool = True, qconfig: QConfig = QNNPACK,
                 image_size: int = 224, fuse_int8: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        _refuse(fuse_int8)
        self.num_classes, self.drop_rate, self.quantized = num_classes, drop_rate, quantized
        kw = dict(quantized=quantized, qconfig=qconfig, dtype=dtype)
        if quantized:
            self.quant = QuantStub(qconfig)
        self.layers, c, size = [], 3, image_size
        for v in VGG_CFGS[cfg]:
            if v == "M":
                self.layers.append("M")
                size = _pooled(size, 2, 2)
                continue
            conv = QConvBNAct(c, v, 3, padding=1, use_bn=batch_norm, use_bias=not batch_norm,
                              act="relu", **kw)
            self.add_module(f"conv{sum(l != 'M' for l in self.layers)}", conv)
            self.layers.append(conv)
            c = v
        self._build_head(c * size * size, num_classes, quantized, qconfig)

    def prepare_int8(self, device, image_size: int = 224) -> None:
        if not self.quantized:
            return
        g = self.quant.prepare_int8(device)
        for layer in self.layers:
            if layer != "M":
                g = layer.prepare_int8(g, device)
        self._prepare_head(device)

    def forward(self, x, mode: QuantMode = FP32, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """(B, S, S, 3) float images -> (B, num_classes) float logits."""
        self._check(mode)
        if self.quantized:
            x = self.quant(x, mode)
        for layer in self.layers:
            x = max_pool(x, 2, 2) if layer == "M" else layer(x, mode, train)
        return self._head(x, mode, train, generator, drop_first=False)


class AlexNet(_DenseHead):
    def __init__(self, num_classes: int = 1000, drop_rate: float = 0.5, quantized: bool = True,
                 qconfig: QConfig = QNNPACK, image_size: int = 224, fuse_int8: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        _refuse(fuse_int8)
        self.num_classes, self.drop_rate, self.quantized = num_classes, drop_rate, quantized
        kw = dict(quantized=quantized, qconfig=qconfig, dtype=dtype, use_bn=False,
                  use_bias=True, act="relu")
        if quantized:
            self.quant = QuantStub(qconfig)
        self._stem(kw)
        self.conv3 = QConvBNAct(192, 384, 3, padding=1, **kw)
        self.conv4 = QConvBNAct(384, 256, 3, padding=1, **kw)
        self.conv5 = QConvBNAct(256, 256, 3, padding=1, **kw)
        size = _pooled(self._stem_size(image_size), 3, 2)
        self._build_head(256 * size * size, num_classes, quantized, qconfig)

    def _stem(self, kw):
        self.conv1 = QConvBNAct(3, 64, 11, strides=4, padding=2, **kw)
        self.conv2 = QConvBNAct(64, 192, 5, padding=2, **kw)

    @staticmethod
    def _stem_size(image_size: int) -> int:
        """The side of conv3's input: conv1, a pool, conv2, a pool."""
        return _pooled(_pooled((image_size + 4 - 11) // 4 + 1, 3, 2), 3, 2)

    def _trunk(self, x, mode: QuantMode, train: bool):
        x = max_pool(self.conv1(x, mode, train), 3, 2)
        return max_pool(self.conv2(x, mode, train), 3, 2)

    def prepare_int8(self, device, image_size: int = 224) -> None:
        if not self.quantized:
            return
        g = self.quant.prepare_int8(device)
        for conv in (self.conv1, self.conv2, self.conv3, self.conv4, self.conv5):
            g = conv.prepare_int8(g, device)
        self._prepare_head(device)

    def forward(self, x, mode: QuantMode = FP32, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """(B, S, S, 3) float images -> (B, num_classes) float logits."""
        self._check(mode)
        if self.quantized:
            x = self.quant(x, mode)
        x = self._trunk(x, mode, train)
        for conv in (self.conv3, self.conv4, self.conv5):
            x = conv(x, mode, train)
        return self._head(max_pool(x, 3, 2), mode, train, generator, drop_first=True)


def vgg_factories():
    """The JAX registry's VGG and AlexNet names, quantized (``q`` prefix) and
    float, with its factories' defaults (1000 classes)."""
    reg = {}
    for name, cfg in (("vgg11", "A"), ("vgg13", "B"), ("vgg16", "D"), ("vgg19", "E")):
        for bn in (False, True):
            for quant in (True, False):
                def make(c=cfg, b=bn, q=quant, **kwargs):
                    kwargs.setdefault("num_classes", 1000)
                    return VGG(cfg=c, batch_norm=b, quantized=q, **kwargs)

                reg[f"{'q' if quant else ''}{name}{'_bn' if bn else ''}"] = make
    for quant in (True, False):
        reg[f"{'q' if quant else ''}alexnet"] = (
            lambda q=quant, **kw: AlexNet(quantized=q, **{"num_classes": 1000, **kw}))
    return reg
