"""GAN networks for style transfer: the generator, the discriminators, the losses.

The architectures and the module names are those of
``frostnet_tpu/gan/networks.py`` (NHWC activations, HWIO weights), so each
variable of a JAX checkpoint or INT8 artifact maps to one parameter or
buffer here (``block3.conv2.kernel`` <-> ``params/block3/conv2/kernel``):

* :class:`ResnetGenerator`: float reflection pad 3 -> QuantStub ``quant`` ->
  ``stem`` 7x7 -> ``down0``, ``down1`` (3x3 stride 2) -> ``block0..``
  ResnetBlocks (3x3 convs and the ``skip_add`` QAdd) -> 2 x (dequant,
  bilinear x2 resize, QuantStub ``requant_up{i}``, ``up{i}`` 3x3) ->
  dequant, float reflection pad 3 -> ``tail`` 7x7 float conv with bias and
  tanh. ``forward(x, mode, train, generator)`` runs every phase: FP32, QAT
  and QAT_FROZEN on float tensors (``train`` steps the BN statistics, QAT
  the observers), and INT8 frozen (``prepare_int8``, called by
  ``quant.freeze``: the blocks' and up convs on the dense 3x3 conv kernel,
  the stem and the strided downs on the im2col INT8 matmul, the tail a
  float32 conv). ``quantized=False`` is the float generator (no stubs, a
  plain skip add). ``use_dropout`` puts a 0.5 dropout between a block's
  convs in train mode on float tensors, drawn from ``generator``.
* :class:`NLayerDiscriminator` (the PatchGAN) and
  :class:`PixelDiscriminator`: float only (``QConvBNAct(quantized=False)``,
  so their convs run float32 on the card with TF32 off), BN only for
  ``norm="batch"``; ``forward(x, train)``.
* :func:`gan_loss` (lsgan, vanilla, wgangp) and :func:`gradient_penalty`
  (WGAN-GP, a double backward through D).

:func:`gan_init` draws the reference's GAN init (``init_type='normal',
init_gain=0.02``): conv kernels ``N(0, 0.02)``, BN scales ``1 + 0.02 N``,
biases 0, from a ``torch.Generator``; ``define_g`` and ``define_d`` apply it.
``quant.numpy_init(..., init="gan")`` draws the same distribution with
numpy, for starting both packages from one seed.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..models.frostnet import dropout
from ..nn import FP32, QAdd, QConvBNAct, QuantMode, QuantStub, dequant
from ..ops import resize
from ..quant import QConfig, QNNPACK
from ..quant.qtensor import QParams, QTensor
from ..utils.losses import mean_f32

GAN_INIT_STD = 0.02


def reflection_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    """Reflect-pad a float NHWC tensor by ``p`` on each spatial side."""
    return F.pad(x.permute(0, 3, 1, 2), (p, p, p, p), mode="reflect").permute(0, 2, 3, 1)


@torch.no_grad()
def gan_init(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw ``model``'s parameters at the GAN init, in registration order:
    kernels ``N(0, 0.02)``, BN scales ``1 + 0.02 N``, biases and BN shifts 0
    (the buffers keep their fresh values)."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("kernel", "scale"):
            draw = torch.randn(p.shape, generator=generator, dtype=torch.float32)
            p.copy_(draw * GAN_INIT_STD + (1.0 if leaf == "scale" else 0.0))
        else:
            p.zero_()
    return model


def _seeded(generator: Optional[torch.Generator]) -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(0)


class ResnetBlock(nn.Module):
    """Two 3x3 convs with a skip add, observed in the quantized generator
    (reference networks.py:492-550)."""

    def __init__(self, dim: int, use_dropout: bool = False, quantized: bool = True,
                 qconfig: QConfig = QNNPACK):
        super().__init__()
        kw = dict(quantized=quantized, qconfig=qconfig)
        self.use_dropout, self.quantized = use_dropout, quantized
        self.conv1 = QConvBNAct(dim, dim, 3, padding=1, act="relu", **kw)
        self.conv2 = QConvBNAct(dim, dim, 3, padding=1, act=None, **kw)
        if quantized:
            self.skip_add = QAdd(qconfig)

    def prepare_int8(self, x: QParams, device) -> QParams:
        g = self.conv2.prepare_int8(self.conv1.prepare_int8(x, device), device)
        return self.skip_add.prepare_int8([x, g], device)

    def forward(self, x, mode: QuantMode = FP32, train: bool = False,
                generator: Optional[torch.Generator] = None):
        out = self.conv1(x, mode, train)
        if self.use_dropout and train and not isinstance(out, QTensor):
            out = dropout(out, 0.5, generator)
        out = self.conv2(out, mode, train)
        if self.quantized:
            return self.skip_add(x, out, mode)
        return x + out


class ResnetGenerator(nn.Module):
    """Quantized-core ResNet generator (reference networks.py:405-490)."""

    def __init__(self, output_nc: int = 3, ngf: int = 64, n_blocks: int = 6,
                 use_dropout: bool = False, quantized: bool = True, qconfig: QConfig = QNNPACK,
                 input_nc: int = 3):
        super().__init__()
        kw = dict(quantized=quantized, qconfig=qconfig)
        self.quantized = quantized
        if quantized:
            self.quant = QuantStub(qconfig)
        self.stem = QConvBNAct(input_nc, ngf, 7, padding=0, act="relu", **kw)
        self.down0 = QConvBNAct(ngf, 2 * ngf, 3, strides=2, padding=1, act="relu", **kw)
        self.down1 = QConvBNAct(2 * ngf, 4 * ngf, 3, strides=2, padding=1, act="relu", **kw)
        self.blocks = []
        for i in range(n_blocks):
            blk = ResnetBlock(4 * ngf, use_dropout, quantized, qconfig)
            self.add_module(f"block{i}", blk)
            self.blocks.append(blk)
        if quantized:
            self.requant_up0 = QuantStub(qconfig)
        self.up0 = QConvBNAct(4 * ngf, 2 * ngf, 3, padding=1, act="relu", **kw)
        if quantized:
            self.requant_up1 = QuantStub(qconfig)
        self.up1 = QConvBNAct(2 * ngf, ngf, 3, padding=1, act="relu", **kw)
        self.tail = QConvBNAct(ngf, output_nc, 7, padding=0, use_bn=False, use_bias=True,
                               act="tanh", quantized=False)

    def prepare_int8(self, device, image_size: int = 256) -> None:
        """Freeze every quantized module on ``device``. The frozen graph
        takes any image size; ``image_size`` is kept for the interface that
        ``quant.freeze`` calls. The float generator has nothing to freeze."""
        if not self.quantized:
            return
        g = self.down1.prepare_int8(self.down0.prepare_int8(
            self.stem.prepare_int8(self.quant.prepare_int8(device), device), device), device)
        for blk in self.blocks:
            g = blk.prepare_int8(g, device)
        self.up0.prepare_int8(self.requant_up0.prepare_int8(device), device)
        self.up1.prepare_int8(self.requant_up1.prepare_int8(device), device)

    def forward(self, x: torch.Tensor, mode: QuantMode = FP32, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, S, S, input_nc) float images in [-1, 1] -> (B, S, S, output_nc) float32."""
        int8 = mode.int8 and self.quantized
        if int8 and not hasattr(self.quant, "_out"):
            raise RuntimeError("INT8 runs frozen only: call quant.freeze(model) first")
        x = reflection_pad(x, 3)
        if self.quantized:
            x = self.quant(x, mode)
        x = self.down1(self.down0(self.stem(x, mode, train), mode, train), mode, train)
        for blk in self.blocks:
            x = blk(x, mode, train, generator)
        for i, up in enumerate((self.up0, self.up1)):
            xf = dequant(x)
            xf = resize.resize_bilinear(xf, (2 * xf.shape[1], 2 * xf.shape[2]), align_corners=True)
            if self.quantized:
                xf = getattr(self, f"requant_up{i}")(xf, mode)
            x = up(xf, mode, train)
        return self.tail(reflection_pad(dequant(x), 3), mode, train)


def _float_conv(cin: int, cout: int, k: int, strides: int = 1, padding: int = 0,
                use_bn: bool = False, use_bias: bool = False) -> QConvBNAct:
    return QConvBNAct(cin, cout, k, strides=strides, padding=padding, use_bn=use_bn,
                      use_bias=use_bias, act=None, quantized=False)


class NLayerDiscriminator(nn.Module):
    """PatchGAN discriminator (reference networks.py:553-599), float only.

    ``norm``: 'batch' (the pix2pix default) or 'none' (CycleGAN's: no BN and
    bias-free middle convs). ``input_nc``: 6 for pix2pix's conditional D
    (``cat(A, x)``), 3 for CycleGAN's."""

    def __init__(self, ndf: int = 64, n_layers: int = 3, norm: str = "batch",
                 input_nc: int = 3):
        super().__init__()
        use_bn = norm == "batch"
        self.n_layers = n_layers
        self.conv0 = _float_conv(input_nc, ndf, 4, 2, 1, use_bias=True)
        nf_prev = 1
        for n in range(1, n_layers):
            nf = min(2 ** n, 8)
            self.add_module(f"conv{n}", _float_conv(ndf * nf_prev, ndf * nf, 4, 2, 1, use_bn))
            nf_prev = nf
        nf = min(2 ** n_layers, 8)
        self.add_module(f"conv{n_layers}", _float_conv(ndf * nf_prev, ndf * nf, 4, 1, 1, use_bn))
        self.out = _float_conv(ndf * nf, 1, 4, 1, 1, use_bias=True)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(B, H, W, input_nc) -> (B, H', W', 1) patch logits."""
        for n in range(self.n_layers + 1):
            x = F.leaky_relu(getattr(self, f"conv{n}")(x, train=train), 0.2)
        return self.out(x, train=train)


class PixelDiscriminator(nn.Module):
    """1x1 PatchGAN (reference networks.py:601+), float only; the output conv
    has no bias (the reference's ``use_bias`` rule for batch and none)."""

    def __init__(self, ndf: int = 64, norm: str = "batch", input_nc: int = 3):
        super().__init__()
        self.conv0 = _float_conv(input_nc, ndf, 1, use_bias=True)
        self.conv1 = _float_conv(ndf, 2 * ndf, 1, use_bn=norm == "batch")
        self.out = _float_conv(2 * ndf, 1, 1)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = F.leaky_relu(self.conv0(x, train=train), 0.2)
        x = F.leaky_relu(self.conv1(x, train=train), 0.2)
        return self.out(x, train=train)


def gan_loss(pred: torch.Tensor, target_is_real: bool, gan_mode: str = "lsgan") -> torch.Tensor:
    """GANLoss (reference networks.py:301-368): lsgan ``mean((pred - t)^2)``,
    vanilla BCE with logits, wgangp ``-+mean(pred)``."""
    if gan_mode not in ("lsgan", "vanilla", "wgangp"):
        raise ValueError(f"unknown gan_mode {gan_mode!r}")
    if gan_mode == "wgangp":
        return -mean_f32(pred) if target_is_real else mean_f32(pred)
    target = torch.ones_like(pred) if target_is_real else torch.zeros_like(pred)
    if gan_mode == "lsgan":
        d = pred - target
        return mean_f32(d * d)
    return mean_f32(torch.clamp(pred, min=0) - pred * target
                    + torch.log1p(torch.exp(-torch.abs(pred))))


def gradient_penalty(d_apply: Callable[[torch.Tensor], torch.Tensor], real: torch.Tensor,
                     fake: torch.Tensor, generator: Optional[torch.Generator] = None,
                     constant: float = 1.0, lambda_gp: float = 10.0,
                     alpha: Optional[torch.Tensor] = None) -> torch.Tensor:
    """WGAN-GP penalty on random interpolates (reference networks.py:370-403).

    ``alpha`` (B, 1, 1, 1) is drawn uniform from ``generator`` unless given.
    The gradient of ``sum(d_apply(interp))`` with respect to the interpolates
    is taken with ``create_graph=True``, so the penalty itself trains D (a
    double backward)."""
    if alpha is None:
        alpha = torch.rand((real.shape[0], 1, 1, 1), generator=generator, device=real.device)
    interp = alpha * real + (1 - alpha) * fake
    if not interp.requires_grad:
        interp.requires_grad_(True)
    (grads,) = torch.autograd.grad(d_apply(interp).sum(), interp, create_graph=True)
    gnorm = torch.sqrt((grads.reshape(grads.shape[0], -1) ** 2).sum(dim=1) + 1e-16)
    return mean_f32((gnorm - constant) ** 2) * lambda_gp


def define_g(output_nc: int = 3, ngf: int = 64, netG: str = "resnet_6blocks",
             use_dropout: bool = False, quantized: bool = True, qconfig: QConfig = QNNPACK,
             input_nc: int = 3, generator: Optional[torch.Generator] = None) -> ResnetGenerator:
    """Generator factory (reference networks.py:211-252): resnet_6blocks or
    resnet_9blocks, at the GAN init drawn from ``generator`` (seed 0 when
    None). The quantized core has BN whatever ``--norm`` says, as the
    reference's has."""
    blocks = {"resnet_6blocks": 6, "resnet_9blocks": 9}
    if netG not in blocks:
        raise ValueError(f"generator {netG!r} not supported; known: {sorted(blocks)}")
    net = ResnetGenerator(output_nc, ngf, blocks[netG], use_dropout, quantized, qconfig,
                          input_nc)
    return gan_init(net, _seeded(generator))


def define_d(ndf: int = 64, netD: str = "basic", n_layers: int = 3, norm: str = "batch",
             input_nc: int = 3, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Discriminator factory (reference networks.py:254-299): basic (3
    layers), n_layers or pixel, ``norm`` batch or none, at the GAN init."""
    if norm not in ("batch", "none"):
        raise ValueError(f"norm must be batch|none, got {norm!r}")
    if netD == "basic":
        net = NLayerDiscriminator(ndf, 3, norm, input_nc)
    elif netD == "n_layers":
        net = NLayerDiscriminator(ndf, n_layers, norm, input_nc)
    elif netD == "pixel":
        net = PixelDiscriminator(ndf, norm, input_nc)
    else:
        raise ValueError(f"unknown discriminator {netD!r}")
    return gan_init(net, _seeded(generator))
