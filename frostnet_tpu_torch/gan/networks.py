"""The pix2pix/CycleGAN ResnetGenerator with a quantized core.

The architecture and the module names are those of
``frostnet_tpu/gan/networks.py`` (NHWC activations, HWIO weights), so each
variable of a JAX checkpoint or INT8 artifact maps to one parameter or
buffer here (``block3.conv2.kernel`` <-> ``params/block3/conv2/kernel``):

    float reflection pad 3 -> QuantStub ``quant`` -> ``stem`` 7x7 -> ``down0``,
    ``down1`` (3x3 stride 2) -> ``block0..`` ResnetBlocks (3x3 convs and the
    ``skip_add`` QAdd) -> 2 x (dequant, bilinear x2 resize, QuantStub
    ``requant_up{i}``, ``up{i}`` 3x3) -> dequant, float reflection pad 3 ->
    ``tail`` 7x7 float conv with bias and tanh.

The port has the INT8 serving path: ``prepare_int8`` (called by
``quant.freeze``) freezes every quantized module once on the device, and
``forward(x, INT8)`` runs the frozen graph. The dense 3x3 stride-1 convs (the
blocks' and the up convs) run the ``ops/int8_conv`` kernel, the stem and
the strided downs the im2col INT8 matmul, the tail a float32 conv. The
float and QAT modes, the discriminators and the losses are not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn import QAdd, QConvBNAct, QuantMode, QuantStub, dequant
from ..ops.resize import resize_bilinear
from ..quant import QConfig, QNNPACK
from ..quant.qtensor import QParams


def reflection_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    """Reflect-pad a float NHWC tensor by ``p`` on each spatial side."""
    return F.pad(x.permute(0, 3, 1, 2), (p, p, p, p), mode="reflect").permute(0, 2, 3, 1)


def _int8_only(mode: QuantMode) -> None:
    if not mode.int8:
        raise NotImplementedError("the port runs the generator in INT8 only; the float and "
                                  "QAT modes come with the GAN training path")


class ResnetBlock(nn.Module):
    """Two 3x3 convs with an observed skip add (reference networks.py:492-550)."""

    def __init__(self, dim: int, qconfig: QConfig = QNNPACK):
        super().__init__()
        self.conv1 = QConvBNAct(dim, dim, 3, padding=1, act="relu", qconfig=qconfig)
        self.conv2 = QConvBNAct(dim, dim, 3, padding=1, act=None, qconfig=qconfig)
        self.skip_add = QAdd(qconfig)

    def prepare_int8(self, x: QParams, device) -> QParams:
        g = self.conv2.prepare_int8(self.conv1.prepare_int8(x, device), device)
        return self.skip_add.prepare_int8([x, g], device)

    def forward(self, x, mode: QuantMode):
        _int8_only(mode)
        return self.skip_add(x, self.conv2(self.conv1(x, mode), mode), mode)


class ResnetGenerator(nn.Module):
    """Quantized-core ResNet generator (reference networks.py:405-490) on RGB
    input. Dropout, which the reference's blocks may have, never acts on the
    INT8 graph, so the port has no ``use_dropout``."""

    def __init__(self, output_nc: int = 3, ngf: int = 64, n_blocks: int = 6,
                 qconfig: QConfig = QNNPACK):
        super().__init__()
        kw = dict(qconfig=qconfig)
        self.quant = QuantStub(qconfig)
        self.stem = QConvBNAct(3, ngf, 7, padding=0, act="relu", **kw)
        self.down0 = QConvBNAct(ngf, 2 * ngf, 3, strides=2, padding=1, act="relu", **kw)
        self.down1 = QConvBNAct(2 * ngf, 4 * ngf, 3, strides=2, padding=1, act="relu", **kw)
        self.blocks = []
        for i in range(n_blocks):
            blk = ResnetBlock(4 * ngf, qconfig)
            self.add_module(f"block{i}", blk)
            self.blocks.append(blk)
        self.requant_up0 = QuantStub(qconfig)
        self.up0 = QConvBNAct(4 * ngf, 2 * ngf, 3, padding=1, act="relu", **kw)
        self.requant_up1 = QuantStub(qconfig)
        self.up1 = QConvBNAct(2 * ngf, ngf, 3, padding=1, act="relu", **kw)
        self.tail = QConvBNAct(ngf, output_nc, 7, padding=0, use_bn=False, use_bias=True,
                               act="tanh", quantized=False)

    def prepare_int8(self, device, image_size: int = 256) -> None:
        """Freeze every quantized module on ``device``. The frozen graph
        takes any image size; ``image_size`` is kept for the interface that
        ``quant.freeze`` calls."""
        g = self.down1.prepare_int8(self.down0.prepare_int8(
            self.stem.prepare_int8(self.quant.prepare_int8(device), device), device), device)
        for blk in self.blocks:
            g = blk.prepare_int8(g, device)
        self.up0.prepare_int8(self.requant_up0.prepare_int8(device), device)
        self.up1.prepare_int8(self.requant_up1.prepare_int8(device), device)

    def forward(self, x: torch.Tensor, mode: QuantMode) -> torch.Tensor:
        """(B, S, S, 3) float images in [-1, 1] -> (B, S, S, output_nc) float32."""
        _int8_only(mode)
        if not hasattr(self.quant, "_out"):
            raise RuntimeError("INT8 runs frozen only: call quant.freeze(model) first")
        x = self.quant(reflection_pad(x, 3), mode)
        x = self.down1(self.down0(self.stem(x, mode), mode), mode)
        for blk in self.blocks:
            x = blk(x, mode)
        for stub, up in ((self.requant_up0, self.up0), (self.requant_up1, self.up1)):
            xf = dequant(x)
            xf = resize_bilinear(xf, (2 * xf.shape[1], 2 * xf.shape[2]), align_corners=True)
            x = up(stub(xf, mode), mode)
        return self.tail(reflection_pad(dequant(x), 3), mode)


def define_g(output_nc: int = 3, ngf: int = 64, netG: str = "resnet_6blocks",
             qconfig: QConfig = QNNPACK) -> ResnetGenerator:
    """Generator factory (reference networks.py:211-252): the quantized
    resnet_6blocks or resnet_9blocks."""
    blocks = {"resnet_6blocks": 6, "resnet_9blocks": 9}
    if netG not in blocks:
        raise ValueError(f"generator {netG!r} not supported; known: {sorted(blocks)}")
    return ResnetGenerator(output_nc, ngf, blocks[netG], qconfig)
