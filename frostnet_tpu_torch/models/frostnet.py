"""FrostNet, the quantization-friendly mobile CNN family.

The architecture and the module names are those of
``frostnet_tpu/models/frostnet.py`` (NHWC activations, HWIO weights), so
each variable of a JAX checkpoint or INT8 artifact maps to one parameter or
buffer here. ``forward(x, mode, train)`` runs one phase of the model's life:
FP32 (the StatAssist warm-up), QAT and QAT_FROZEN (fake-quantized, with the
observers stepping or frozen), or INT8, the frozen integer graph that
``prepare_int8`` (called by ``quant.freeze``) builds once on the device.
``dtype`` is the compute dtype of the float phases (parameters stay
float32).

``fuse_int8=True`` runs each Frost block of the INT8 graph as one CUDA
kernel (``ops/frost_block``), bit-identical to the unfused path.
``output_stride`` 16 or 8 dilates the later stages for dense prediction
(stage 4 by 2; stage 5 by 2, or by 4 at 8), and a dilated stage's blocks
all take stride 1; ``forward(..., features_only=True)`` returns the stage
outputs ``[x1, x2, x3, x5]``. The kernel takes undilated blocks only, so
under ``fuse_int8`` a dilated model is mixed: its dilated blocks run the
unfused route (the matmul kernel for the 1x1s, the dilated depthwise in
torch ops), as the JAX model runs them unfused. The float
FrostNets (``quantized=False``: no QuantStub, observers, QCat or QAdd; a
concatenate and a plain residual add) run in float in every phase.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn import FP32, QAdd, QCat, QConvBNAct, QuantMode, QuantStub, dequant, global_avg_pool
from ..ops.frost_block import FrostBlockSpec, build_params, frost_block_int8
from ..parallel.mesh import active_mesh
from ..quant import QConfig, QNNPACK
from ..quant.qtensor import QParams, QTensor


def make_divisible(v, divisor: int = 8, min_value: Optional[int] = None) -> int:
    """Channel rounding of the TF mobilenet recipe."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


# Stage tables: (kernel, channels, expand_ratio, reduce_factor, stride) per
# block, grouped into 5 stages (reference frostnet.py:156-269).
FROSTNET_SETTINGS = {
    "large": (
        [(3, 16, 1, 1, 1), (3, 24, 6, 4, 2), (3, 24, 3, 4, 1)],
        [(5, 40, 6, 4, 2), (3, 40, 3, 4, 1)],
        [
            (5, 80, 6, 4, 2), (5, 80, 3, 4, 1), (5, 80, 3, 4, 1),
            (5, 96, 6, 4, 1), (5, 96, 3, 4, 1), (3, 96, 3, 4, 1), (3, 96, 3, 4, 1),
        ],
        [
            (5, 192, 6, 2, 2), (5, 192, 6, 4, 1), (5, 192, 6, 4, 1),
            (5, 192, 3, 4, 1), (5, 192, 3, 4, 1),
        ],
        [(5, 320, 6, 2, 1)],
    ),
    "base": (
        [(3, 16, 1, 1, 1), (5, 24, 6, 4, 2), (3, 24, 3, 4, 1)],
        [(5, 40, 3, 4, 2), (5, 40, 3, 4, 1)],
        [
            (5, 80, 3, 4, 2), (3, 80, 3, 4, 1),
            (5, 96, 3, 2, 1), (3, 96, 3, 4, 1), (5, 96, 3, 4, 1), (5, 96, 3, 4, 1),
        ],
        [(5, 192, 6, 2, 2), (5, 192, 3, 2, 1), (5, 192, 3, 2, 1), (5, 192, 3, 2, 1)],
        [(5, 320, 6, 2, 1)],
    ),
    "small": (
        [(3, 16, 1, 1, 1), (5, 24, 3, 4, 2), (3, 24, 3, 4, 1)],
        [(5, 40, 3, 4, 2)],
        [
            (5, 80, 3, 4, 2), (5, 80, 3, 4, 1), (3, 80, 3, 4, 1),
            (5, 96, 3, 2, 1), (5, 96, 3, 4, 1), (5, 96, 3, 4, 1),
        ],
        [(5, 192, 6, 4, 2), (5, 192, 6, 4, 1), (5, 192, 6, 4, 1)],
        [(5, 320, 6, 2, 1)],
    ),
    # not a published variant: the JAX package's five-block table for quick
    # tests (its tensor-parallel check runs it)
    "tiny": (
        [(3, 16, 1, 1, 1)],
        [(5, 24, 3, 4, 2)],
        [(5, 40, 3, 4, 2)],
        [(5, 96, 3, 2, 2)],
        [(5, 160, 6, 2, 1)],
    ),
}


class CascadePreExBottleneck(nn.Module):
    """The Frost block (reference frostnet.py:81-145).

    CAS type: squeeze 1x1 -> concat with the input -> expand 1x1 ->
    depthwise kxk -> linear reduce 1x1 (+ residual when shape-preserving).
    Plain MB (inverted residual) when the squeezed width would be < 8.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 strides: int = 1, dilation: int = 1, expand_ratio: int = 6,
                 reduce_factor: int = 4, block_type: str = "CAS", quantized: bool = True,
                 qconfig: QConfig = QNNPACK, fuse_int8: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if in_channels // reduce_factor < 8:
            block_type = "MB"
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size, self.strides, self.expand_ratio = kernel_size, strides, expand_ratio
        self.dilation = dilation
        self.qconfig, self.quantized = qconfig, quantized
        # the fused kernel takes undilated blocks only (the JAX block's gate)
        self.fuse_int8 = fuse_int8 and quantized and dilation == 1
        self.r_channels = make_divisible(in_channels // reduce_factor)
        self.has_expand = expand_ratio != 1
        self.has_squeeze = self.has_expand and block_type == "CAS"
        self.residual = strides == 1 and in_channels == out_channels
        n_channels = in_channels + (self.r_channels if self.has_squeeze else 0)
        self.e = n_channels * expand_ratio if self.has_expand else in_channels
        kw = dict(quantized=quantized, qconfig=qconfig, dtype=dtype)
        if self.has_squeeze:
            self.squeeze_conv = QConvBNAct(in_channels, self.r_channels, 1, act="relu", **kw)
            if quantized:
                self.quant_cat = QCat(qconfig)
        if self.has_expand:
            self.conv1 = QConvBNAct(n_channels, self.e, 1, act="relu", **kw)
        self.conv2 = QConvBNAct(self.e, self.e, kernel_size, strides=strides,
                                padding=dilation * (kernel_size - 1) // 2, dilation=dilation,
                                groups=self.e, act="relu", **kw)
        self.reduce_conv = QConvBNAct(self.e, out_channels, 1, act=None, **kw)
        if self.residual and quantized:
            self.skip_add = QAdd(qconfig)

    def spec(self, h: int, w: int) -> FrostBlockSpec:
        return FrostBlockSpec(
            h=h, w=w, cin=self.in_channels, cout=self.out_channels,
            kernel=self.kernel_size, stride=self.strides,
            has_squeeze=self.has_squeeze, has_expand=self.has_expand,
            c_sq=self.r_channels if self.has_squeeze else 0, c_e=self.e,
            residual=self.residual, act_qmax=self.qconfig.activation.qmax)

    def prepare_int8(self, x: QParams, device, hw=None) -> QParams:
        """Freeze the block for inputs on grid ``x`` (of spatial size ``hw``
        when fused); returns the output grid."""
        if self.fuse_int8:
            return self._prepare_fused(x, device, hw)
        g = x
        if self.has_squeeze:
            sq = self.squeeze_conv.prepare_int8(x, device)
            g = self.quant_cat.prepare_int8([sq, x], device)
        if self.has_expand:
            g = self.conv1.prepare_int8(g, device)
        g = self.conv2.prepare_int8(g, device)
        g = self.reduce_conv.prepare_int8(g, device)
        if self.residual:
            g = self.skip_add.prepare_int8([x, g], device)
        return g

    def _prepare_fused(self, x: QParams, device, hw) -> QParams:
        """Gather the children's frozen operands into one kernel's params
        (the JAX block's ``_fused_int8``)."""

        def operands(conv, in_scale):
            qw, ws, bf, os_, oz = conv.int8_params()
            return (qw, torch.tensor(in_scale, dtype=torch.float32) * ws, bf, os_, oz), (os_, oz)

        spec = self.spec(*hw)
        sq = cat = ex = add = None
        in_scale = x.scale
        if self.has_squeeze:
            sq, _ = operands(self.squeeze_conv, x.scale)
            cat = self.quant_cat.qparams()
            in_scale = cat.scale
        if self.has_expand:
            ex, (in_scale, _) = operands(self.conv1, in_scale)
        dw, (in_scale, _) = operands(self.conv2, in_scale)
        rd, out = operands(self.reduce_conv, in_scale)
        out = QParams(*out)
        if self.residual:
            add = self.skip_add.qparams()
            out = add
        self._spec = spec
        self._params = build_params(spec, x_scale=x.scale, x_zp=x.zero_point, sq=sq,
                                    cat=cat, ex=ex, dw=dw, rd=rd, add=add, device=device)
        self._out_t = out.tensors(device)
        return out

    def forward(self, x, mode: QuantMode = FP32, train: bool = False):
        if mode.int8 and self.fuse_int8:
            q = frost_block_int8(x.q, self._params, self._spec)
            return QTensor(q, *self._out_t)
        out = x
        if self.has_squeeze:
            sq = self.squeeze_conv(x, mode, train)
            out = (self.quant_cat([sq, x], mode) if self.quantized
                   else torch.cat([sq, x], dim=-1))
        if self.has_expand:
            out = self.conv1(out, mode, train)
        out = self.reduce_conv(self.conv2(out, mode, train), mode, train)
        if self.residual:
            out = self.skip_add(x, out, mode) if self.quantized else x + out
        return out


class FrostNet(nn.Module):
    """FrostNet classifier (reference frostnet.py:150-351).

    Module names follow the JAX model: ``quant``, ``conv1``, ``layer{s}_{i}``,
    ``last_layer``, ``classifier``. Input: float NHWC images. Dropout before
    the classifier is active in train mode and draws from the ``generator``
    passed to ``forward``. ``output_stride=32`` is the classification
    trunk; 16 or 8 dilates the later stages. ``head=False`` builds the trunk
    alone (no ``last_layer`` or ``classifier``: the variables of the JAX
    model initialised with ``features_only=True``).
    """

    def __init__(self, num_classes: int = 1000, mode: str = "large",
                 width_mult: float = 1.0, quantized: bool = True, drop_rate: float = 0.2,
                 output_stride: int = 32, qconfig: QConfig = QNNPACK,
                 fuse_int8: bool = False, dtype: torch.dtype = torch.float32,
                 head: bool = True):
        super().__init__()
        self.num_classes, self.fuse_int8 = num_classes, fuse_int8 and quantized
        self.drop_rate, self.dtype, self.quantized = drop_rate, dtype, quantized
        self.output_stride, self.head = output_stride, head
        kw = dict(quantized=quantized, qconfig=qconfig, dtype=dtype)
        stem_c = make_divisible(int(32 * min(1.0, width_mult)))
        if quantized:
            self.quant = QuantStub(qconfig)
        self.conv1 = QConvBNAct(3, stem_c, 3, strides=2, padding=1, act="relu", **kw)
        d4 = 2 if output_stride <= 16 else 1
        d5 = (4 if output_stride <= 8 else 2) if output_stride <= 16 else 1
        self.blocks, self.stage_ends = [], []
        c = stem_c
        for si, stage in enumerate(FROSTNET_SETTINGS[mode]):
            dilation = {3: d4, 4: d5}.get(si, 1)
            for i, (k, ch, e, r, s) in enumerate(stage):
                out_c = make_divisible(int(ch * width_mult))
                blk = CascadePreExBottleneck(c, out_c, kernel_size=k,
                                             strides=s if dilation == 1 else 1,
                                             dilation=dilation, expand_ratio=e,
                                             reduce_factor=r, fuse_int8=self.fuse_int8, **kw)
                self.add_module(f"layer{si + 1}_{i}", blk)
                self.blocks.append(blk)
                c = out_c
            self.stage_ends.append(len(self.blocks) - 1)
        if head:
            self.last_layer = QConvBNAct(c, 1280, 1, act="relu", **kw)
            self.classifier = QConvBNAct(1280, num_classes, 1, use_bn=False, use_bias=True,
                                         act=None, **kw)

    def _block_sizes(self, image_size: int):
        """``[(name, block, (h, w))]``: each block's input size at ``image_size``."""
        hw = ((image_size + 2 - 3) // 2 + 1,) * 2  # the stride-2 3x3 stem
        sizes = []
        for name, blk in self.named_children():
            if isinstance(blk, CascadePreExBottleneck):
                sizes.append((name, blk, hw))
                hw = blk.spec(*hw).out_hw  # a dilated block keeps its size ('same', stride 1)
        return sizes

    def block_specs(self, image_size: int):
        """``[(name, FrostBlockSpec)]`` of the undilated blocks at ``image_size``:
        the 18 (or fewer) that the fused kernel can take."""
        return [(name, blk.spec(*hw)) for name, blk, hw in self._block_sizes(image_size)
                if blk.dilation == 1]

    def prepare_int8(self, device, image_size: int) -> None:
        """Freeze every module for ``image_size`` inputs on ``device`` (a
        float model needs nothing)."""
        if not self.quantized:
            return
        g = self.quant.prepare_int8(device)
        g = self.conv1.prepare_int8(g, device)
        for _, blk, hw in self._block_sizes(image_size):
            g = blk.prepare_int8(g, device, hw)
        if self.head:
            g = self.last_layer.prepare_int8(g, device)
            self.classifier.prepare_int8(g, device)

    def forward(self, x: torch.Tensor, mode: QuantMode = FP32, train: bool = False,
                generator: Optional[torch.Generator] = None, features_only: bool = False):
        """(B, S, S, 3) float images -> (B, num_classes) logits, or with
        ``features_only`` the outputs of stages 1, 2, 3 and 5 (dequantized).

        In INT8 a quantized model runs frozen (``quant.freeze``) and returns
        float32; the float phases return the compute dtype.
        """
        if mode.int8 and self.quantized and not hasattr(self.quant, "_out"):
            raise RuntimeError("INT8 runs frozen only: call quant.freeze(model) first")
        if self.quantized:
            x = self.quant(x, mode)
        x = self.conv1(x, mode, train)
        feats = []
        for i, blk in enumerate(self.blocks):
            x = blk(x, mode, train)
            if i in self.stage_ends:
                feats.append(x)
        if features_only or not self.head:
            return [dequant(f) for f in (feats[0], feats[1], feats[2], feats[4])]
        x = self.last_layer(x, mode, train)
        x = global_avg_pool(x, keepdims=True)
        if train and self.drop_rate > 0 and not mode.int8:
            mp = self.last_layer.mp_layer
            x = dropout(x, self.drop_rate, generator, mp[0] if mp and mp[1] == 3 else None)
        x = dequant(self.classifier(x, mode, train))
        return x.reshape(x.shape[0], x.shape[-1])


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            mp_mesh=None) -> torch.Tensor:
    """flax ``Dropout``: keep with probability ``1 - rate``, scale kept values
    by ``1 / (1 - rate)``; the mask draws from ``generator``. Under a
    data-parallel mesh the mask is drawn for the global batch and this
    rank's rows kept: the one-process step's mask. ``mp_mesh``: ``x``'s
    channels are this rank's block over that mesh's ``mp`` (the mask drawn
    for every channel, the block kept)."""
    keep = 1.0 - rate
    mesh = active_mesh()
    shape, rows, chans = list(x.shape), slice(None), slice(None)
    if mesh is not None and mesh.distributed:
        rows = slice(mesh.dp_index * x.shape[0], (mesh.dp_index + 1) * x.shape[0])
        shape[0] *= mesh.dp
    if mp_mesh is not None and mp_mesh.mp > 1:
        start, n = mp_mesh.mp_block(x.shape[-1] * mp_mesh.mp)
        chans = slice(start, start + n)
        shape[-1] *= mp_mesh.mp
    mask = torch.empty(shape, device=x.device).bernoulli_(keep, generator=generator)
    mask = mask[rows][..., chans]
    return torch.where(mask.bool(), x / torch.full((), keep, dtype=x.dtype, device=x.device),
                       torch.zeros((), dtype=x.dtype, device=x.device))
