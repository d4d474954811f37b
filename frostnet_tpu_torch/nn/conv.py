"""QConvBNAct: conv + BN + activation, quant-aware.

The variables are those of ``frostnet_tpu/nn/conv.py::QConvBNAct`` under the
same names: the parameters ``kernel`` (HWIO float), ``bias``, ``scale`` and
``bias_bn`` (BN gamma/beta), and the buffers ``mean`` and ``var`` (BN
running stats) and the observers ``w_obs`` and ``act_obs``. A block made
with ``quantized=False`` (the GAN generator's float tail) has no observers
and runs in float in every phase, INT8 included.

``forward(x, mode, train)`` runs the phase ``mode`` names, as the JAX
module does (activations NHWC at the boundary):

* FP32: conv -> BN (batch statistics in train mode, running ones in eval)
  -> act (the StatAssist warm-up; ``relu6`` is ``clamp(y, 0, 6)``);
* QAT train: the ``torch.nn.intrinsic.qat.ConvBn2d`` recipe:
  ``sf = gamma / sqrt(var + eps)``, the weight ``w * sf`` observed and
  fake-quantized, conv, ``/ sf``, BN on batch statistics (biased variance
  to normalize, unbiased into the running estimate, momentum 0.1), act;
* QAT eval: running-statistics BN folded into the weight and bias, the
  folded weight fake-quantized; without BN (the classifier) the weight
  itself;
* QAT and QAT_FROZEN then fake-quantize the activation on ``act_obs``'s
  grid (``observe`` steps the observers), and the output is stored in the
  compute ``dtype`` (bf16 for the benchmarked step);
* INT8: the frozen graph (below).

Convolutions run in ``dtype`` through ``torch.nn.functional.conv2d`` on
permuted views, so the NHWC activations are ``channels_last`` tensors to
cuDNN; BN runs in float32. The conv of a float block (``quantized=False``)
runs in float32 on the card whatever the caller set: TF32, which cuDNN
allows by default, is off for the call. The convs of quantized blocks
follow the caller's TF32 setting.

``prepare_int8`` freezes the conv once: BN fold, weight quantization on the
weight observer's grid (``fold_bn`` -> ``calculate_qparams_folded`` ->
``quantize``, the JAX chain op for op), column sums, the epilogue constants
and the packed operands, all on the target device. The INT8 forward then
takes one of five routes:

* 1x1: one INT8 matmul (``ops/int8_matmul``); a padded 1x1 pads the codes
  with the input's zero point first, then takes the strided slice, as JAX
  does;
* depthwise kh x kw, dilated or not (the segmentation trunks' last stage
  runs dilation 2), with or without a channel multiplier (the SSD extras'
  3x3 maps 32 -> 128 channels, output channel ``oc`` reading input
  ``oc // 4``), at any kernel shape and padding: the INT8 depthwise kernel
  with its epilogue (``ops/depthwise_int8``; its plain version, kh*kw
  shifted integer multiply-adds over (kh*kw, Cout) taps, tap ``(dy, dx)`` at
  ``dilation * (dy, dx)`` of the zero-point-padded codes, on the CPU; JAX
  runs the same multiply-adds as XLA code, not a TPU kernel);
* dense 3x3 stride 1 dilation 1 with 'same' padding (the GAN's ResnetBlock
  and up convs): the dense 3x3 INT8 conv kernel (``ops/int8_conv``);
* any other dense kxk (the stems, strided convs, R-ASPP's atrous 3x3s):
  zero-point-padded im2col patches (dilated taps where the conv is) and one
  INT8 matmul, whatever K the patches have;
* grouped kxk, dilated or not (ResNeXt's ``groups=32`` 3x3s): the exact
  int32 sum of a float64 grouped conv in torch (``ops/requant.py::conv_acc``;
  JAX runs it as an s32 ``lax.conv`` with ``rhs_dilation``, XLA code, not a
  TPU kernel), then the shared epilogue.

``padding`` is an int or an (h, w) pair, on both sides of each axis.

Every route takes ``relu6`` as a narrower clamp of the codes. The frozen
epilogue computes ``quantize(clip(y, 0, 6))``; quantize is monotone, so that
equals ``clamp(rint(y * f32(1/s)) + zp, max(qmin, zp), min(qmax, q6))`` with
``q6 = rint(f32(6) * f32(1/s)) + zp``, the epilogue's own arithmetic
(:meth:`QConvBNAct.code_range`).

Under a data-parallel mesh (``parallel.data_parallel``) the train-mode BN
takes the global batch's statistics, as JAX's dp step does:
:class:`GlobalBatchNorm`. Under tensor parallelism
(``parallel.shard_params_for_mp``, :meth:`QConvBNAct.shard_for_mp`) a layer
holds its block of the kernel and computes the unsharded layer's function
on it, as GSPMD does for JAX's sharded step.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.autograd.function import once_differentiable

from ..ops.depthwise_int8 import depthwise_int8, depthwise_operands
from ..ops.int8_conv import conv3x3_operands, conv3x3_s1_int8
from ..ops.int8_matmul import conv1x1_operands, int8_matmul_requant
from ..ops.requant import conv_acc, epilogue_constants, reciprocal, requant_epilogue
from ..parallel.mesh import Mesh, active_mesh, mp_enter, mp_slice, mp_sum
from ..quant import QConfig, QNNPACK, bn_scale_factor, calculate_qparams_folded, fold_bn, quantize
from ..quant.qtensor import QParams, QTensor
from .mode import FP32, QuantMode
from .quant_ops import Observer, ObserverBlock, observed_fake_quant, observed_qparams


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


@contextlib.contextmanager
def _full_f32(x: torch.Tensor, on: bool):
    """TF32 off for cuDNN while a float32 conv on the card runs, if ``on``."""
    if not on or x.device.type != "cuda" or x.dtype != torch.float32:
        yield
        return
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class GlobalBatchNorm(torch.autograd.Function):
    """Train-mode BN of NHWC float32 ``y`` over the global batch of a
    data-parallel mesh (``frostnet_tpu/nn/conv.py:526-534``: the
    single-device program on the global batch, which JAX's dp mesh runs):

        bmean = sum(y) / N                  one all-reduce of the sums
        bvar  = sum((y - bmean)^2) / N      a second one
        out   = (y - bmean) * rsqrt(bvar + eps) * gamma + beta

    with ``N`` the global count a channel, and the running statistics step
    with the global ``N / (N - 1)``. The backward all-reduces its two sums a
    channel (of ``g * gamma`` and of that times the normalized ``y``) in one
    collective; the gradients of gamma and beta stay this rank's sums, to be
    averaged with the rest of the gradient. The loss is this rank's mean,
    so that average is the global batch's gradient.

    torch's ``SyncBatchNorm`` takes another variance form and runs on CUDA
    only; DDP's default BN computes per-replica statistics, another
    function.

    The backward is once differentiable: a double backward through it (a
    gradient penalty's ``create_graph``) raises. No trainer step takes one:
    ``gan.networks.gradient_penalty`` is no part of the GAN steps, whose
    ``wgangp`` loss is ``-+mean(pred)``."""

    @staticmethod
    def forward(ctx, y, gamma, beta, running_mean, running_var, momentum: float, eps: float,
                mesh: Mesh):
        c = y.shape[-1]
        n = y.numel() // c * mesh.dp
        total = torch.full((), float(n), dtype=torch.float32, device=y.device)
        bmean = mesh.all_reduce(y.sum(dim=(0, 1, 2))) / total
        d = y - bmean
        bvar = mesh.all_reduce((d * d).sum(dim=(0, 1, 2))) / total
        inv = torch.rsqrt(bvar + eps)
        xhat = d * inv
        m = momentum
        running_mean.mul_(1 - m).add_(m * bmean)
        running_var.mul_(1 - m).add_(m * (bvar * (n / max(n - 1, 1))))
        ctx.save_for_backward(xhat, inv, gamma)
        ctx.mesh, ctx.total = mesh, total
        return xhat * gamma + beta

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        xhat, inv, gamma = ctx.saved_tensors
        gx = g * gamma
        sums = ctx.mesh.all_reduce(torch.stack([gx.sum(dim=(0, 1, 2)),
                                                (gx * xhat).sum(dim=(0, 1, 2))]))
        mean_g, mean_gx = (sums / ctx.total).unbind()
        dy = inv * (gx - mean_g - xhat * mean_gx)
        return (dy, (g * xhat).sum(dim=(0, 1, 2)), g.sum(dim=(0, 1, 2)), None, None, None,
                None, None)


class QConvBNAct(nn.Module):
    """Conv2d + optional BatchNorm + optional activation, quant-aware."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Union[int, Sequence[int]] = 3, strides: int = 1,
                 padding: Union[int, Sequence[int]] = 0, dilation: int = 1, groups: int = 1, use_bn: bool = True,
                 use_bias: bool = False, act: Optional[str] = "relu",
                 quantized: bool = True, qconfig: QConfig = QNNPACK,
                 bn_momentum: float = 0.1, bn_eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        acts = (None, "relu", "relu6") if quantized else (None, "relu", "relu6", "tanh")
        if act not in acts:
            raise ValueError(f"the port supports act {acts} on a "
                             f"{'quantized' if quantized else 'float'} block, got {act!r}")
        kh, kw = _pair(kernel_size)
        self.in_features, self.features = in_features, features
        self.kernel_size, self.strides = (kh, kw), strides
        self.padding = padding if isinstance(padding, int) else tuple(padding)
        self.dilation = dilation
        self.groups, self.use_bn, self.use_bias, self.act = groups, use_bn, use_bias, act
        self.quantized = quantized
        self.qconfig, self.bn_momentum, self.bn_eps, self.dtype = qconfig, bn_momentum, bn_eps, dtype
        self.kernel = nn.Parameter(torch.zeros(kh, kw, in_features // groups, features))
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(features))
        if use_bn:
            self.scale = nn.Parameter(torch.ones(features))
            self.bias_bn = nn.Parameter(torch.zeros(features))
            self.register_buffer("mean", torch.zeros(features))
            self.register_buffer("var", torch.ones(features))
        if quantized:
            self.w_obs = Observer(features if qconfig.weight.per_channel else None)
            self.act_obs = Observer(None)
        self.mp_layer: Optional[Tuple[Mesh, int]] = None  # (mesh, sharded HWIO axis)

    @property
    def depthwise(self) -> bool:
        return self.groups > 1 and self.groups == self.in_features

    def shard_for_mp(self, mesh: Mesh, axis: int) -> None:
        """Keep this rank's block of the kernel along ``axis`` (3: the
        out-channels; 2: the in-channels; ``parallel.shard_params_for_mp``).
        The forward then computes the layer's single-device function on
        the blocks: out-channel sharding runs the rank's channels through
        conv, BN (its block of the parameters and running statistics) and
        activation, a depthwise slicing a replicated input; in-channel
        sharding sums the partial conv outputs over ``mp`` before the bias
        and BN. A per-tensor weight observer takes min and max over ``mp``;
        a per-channel one (fbgemm) observes its block's channels under
        out-channel sharding and reduces each channel over ``mp`` under
        in-channel sharding. The kernel parameter keeps its full shape and
        its block in ``mp_block`` (the optimizer's noise draws,
        ``gather_mp``)."""
        if self.groups > 1 and not (self.depthwise and self.features == self.in_features
                                    and axis == 3):
            raise ValueError(f"a grouped conv shards only as a depthwise by out-channel "
                             f"(groups {self.groups}, axis {axis})")
        k = self.kernel
        start, n = mesh.mp_block(k.shape[axis])
        k.mp_block = (tuple(k.shape), axis, start, n)
        k.data = k.data.narrow(axis, start, n).clone()
        self.mp_layer = (mesh, axis)

    def _local_vars(self):
        """(gamma, beta, bias, mean, var) of the forward: the layer's, or
        under out-channel sharding this rank's blocks (the parameters through
        ``mp_slice``, whose gradient sums over ``mp``; the statistics as
        views, which BN steps in place)."""
        bn = self.use_bn
        gamma, beta = (self.scale, self.bias_bn) if bn else (None, None)
        mean, var = (self.mean, self.var) if bn else (None, None)
        bias = self.bias if self.use_bias else None
        if self.mp_layer is None or self.mp_layer[1] != 3:
            return gamma, beta, bias, mean, var
        mesh = self.mp_layer[0]
        start, n = mesh.mp_block(self.features)
        if bias is not None:
            bias = mp_slice(bias, 0, mesh)
        if bn:
            gamma, beta = mp_slice(gamma, 0, mesh), mp_slice(beta, 0, mesh)
            mean, var = mean.narrow(0, start, n), var.narrow(0, start, n)
        return gamma, beta, bias, mean, var

    def _weight_observer(self):
        """(the weight observer this rank steps, whether it reduces over
        ``mp``): see :meth:`shard_for_mp`."""
        if self.mp_layer is None:
            return self.w_obs, False
        mesh, axis = self.mp_layer
        if self.qconfig.weight.per_channel and axis == 3:
            return ObserverBlock(self.w_obs, *mesh.mp_block(self.features)), False
        return self.w_obs, True

    @torch.no_grad()
    def sync_mp_statistics(self) -> None:
        """Every rank's running statistics (and per-channel weight
        observer) whole: the ``mp`` ranks' blocks gathered (out-channel
        sharding steps only the rank's own)."""
        if self.mp_layer is None or self.mp_layer[1] != 3:
            return
        mesh = self.mp_layer[0]
        start, n = mesh.mp_block(self.features)
        stats = [self.mean, self.var] if self.use_bn else []
        if self.quantized and self.qconfig.weight.per_channel:
            stats += [self.w_obs.min_val, self.w_obs.max_val]
        for t in stats:
            t.copy_(mesh.mp_gather(t.narrow(0, start, n), 0))

    def int8_params(self):
        """(qw, w_scale, bias, out_scale, out_zp) on the CPU: the frozen INT8
        operands (the JAX module's ``int8_params_only`` branch)."""
        wspec = self.qconfig.weight
        w = self.kernel.detach().cpu()
        bias = self.bias.detach().cpu() if self.use_bias else None
        if self.use_bn:
            wf, bf = fold_bn(w, bias, self.scale.detach().cpu(), self.bias_bn.detach().cpu(),
                             self.mean.detach().cpu(), self.var.detach().cpu(), self.bn_eps)
        else:
            wf = w
            bf = bias if bias is not None else torch.zeros(self.features)
        w_scale, w_zp = calculate_qparams_folded(self.w_obs.state(), wspec)
        qw = quantize(wf, w_scale, w_zp, wspec, channel_axis=-1 if wspec.per_channel else None)
        out = observed_qparams(self.act_obs, self.qconfig.activation)
        return qw, w_scale, bf, out.scale, out.zero_point

    def code_range(self, out_mult: float, out_zp: int) -> Tuple[int, int]:
        """(qmin, qmax) of the frozen epilogue's output codes: the grid's, or
        for ``relu6`` the codes of [0, 6] (``out_mult`` is the epilogue's
        ``f32(1/s)``)."""
        aspec = self.qconfig.activation
        if self.act != "relu6":
            return aspec.qmin, aspec.qmax
        q6 = torch.round(torch.tensor(6.0, dtype=torch.float32)
                         * torch.tensor(out_mult, dtype=torch.float32))
        return max(aspec.qmin, out_zp), min(aspec.qmax, int(q6) + out_zp)

    def prepare_int8(self, x: QParams, device) -> QParams:
        """Freeze the conv for inputs on grid ``x``; returns the output grid."""
        if self.mp_layer is not None and tuple(self.kernel.shape) != self.kernel.mp_block[0]:
            raise RuntimeError("an mp-sharded layer freezes from its full kernel: inside "
                               "parallel.gather_mp")
        qw, w_scale, bf, out_s, out_zp = self.int8_params()
        comb = torch.tensor(x.scale, dtype=torch.float32) * w_scale
        relu = self.act in ("relu", "relu6")
        qmin, qmax = self.code_range(reciprocal(out_s), int(out_zp))
        kh, kw = self.kernel_size
        self._in, self._out = x, QParams(out_s, out_zp)
        self._out_t = self._out.tensors(device)
        ph, pw = _pair(self.padding)
        if kh == 1 and kw == 1 and self.groups == 1:
            self._route = "matmul"
            self._op = conv1x1_operands(qw[0, 0], comb, bf, x.zero_point, out_s, out_zp,
                                        relu, qmin, qmax, device)
        elif self.depthwise:  # channel multiplier features // groups, 1 or more
            self._route = "depthwise"
            self._op = depthwise_operands(qw, comb, bf, x.zero_point, out_s, out_zp, relu,
                                          qmin, qmax, self.strides, self.dilation, (ph, pw),
                                          device)
        elif ((kh, kw) == (3, 3) and self.strides == 1 and (ph, pw) == (1, 1)
              and self.dilation == 1 and self.groups == 1):
            self._route = "dense3x3"
            self._op = conv3x3_operands(qw, comb, bf, x.zero_point, out_s, out_zp, relu,
                                        qmin, qmax, device)
        elif self.groups == 1:
            self._route = "im2col"
            self._op = conv1x1_operands(qw.reshape(kh * kw * self.in_features, self.features),
                                        comb, bf, x.zero_point, out_s, out_zp, relu,
                                        qmin, qmax, device)
        else:
            self._route = "grouped"
            self._w64 = qw.to(torch.float64).permute(3, 2, 0, 1).contiguous().to(device)
            scale, bias, mult = epilogue_constants(comb, bf, out_s, relu)
            self._epilogue = (scale.to(device), bias.to(device), mult, qmin, qmax)
        return self._out

    def _patches(self, q: torch.Tensor) -> torch.Tensor:
        """Zero-point-padded im2col patches, columns in (dy, dx, cin) order
        (tap ``(dy, dx)`` reads ``dilation * (dy, dx)`` from the window's
        corner), then zero columns up to a multiple of 16: the matmul kernel
        reads 16-byte aligned rows, and the packed weight is zero there."""
        kh, kw = self.kernel_size
        s, d = self.strides, self.dilation
        q = self._zp_padded(q)
        hp, wp = q.shape[1], q.shape[2]
        ho, wo = (hp - d * (kh - 1) - 1) // s + 1, (wp - d * (kw - 1) - 1) // s + 1
        cols = [q[:, d * dy:d * dy + (ho - 1) * s + 1:s, d * dx:d * dx + (wo - 1) * s + 1:s, :]
                for dy in range(kh) for dx in range(kw)]
        pad = -(kh * kw * q.shape[3]) % 16
        if pad:
            cols.append(q.new_zeros(q.shape[0], ho, wo, pad))
        return torch.cat(cols, dim=-1)

    def _conv(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """NHWC ``x`` (*) HWIO ``w`` -> NHWC, in the compute dtype; under
        in-channel sharding the partial outputs summed over ``mp``."""
        groups = self.groups
        if self.mp_layer is not None and self.depthwise:
            groups //= self.mp_layer[0].mp
        xt = x.to(self.dtype).permute(0, 3, 1, 2)
        wt = w.to(self.dtype).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        with _full_f32(xt, not self.quantized):
            y = F.conv2d(xt, wt, None, self.strides, self.padding, self.dilation, groups)
        y = y.permute(0, 2, 3, 1)
        return mp_sum(y, self.mp_layer[0]) if self.mp_layer and self.mp_layer[1] == 2 else y

    def _batch_norm(self, y: torch.Tensor, train: bool, gamma=None, beta=None, mean=None,
                    var=None) -> torch.Tensor:
        """BN over NHWC ``y`` in float32; in train mode it normalizes with the
        batch statistics and steps the running ones once. One value per
        channel (the ESPNetv2 classifier's reinforcement call on a 1x1 zeros
        image), which ``F.batch_norm`` refuses in train mode, normalizes to
        ``bias_bn`` and steps the statistics as JAX does: the mean toward
        that value, the variance toward 0 (``n / max(n - 1, 1)`` is 1).
        Under a data-parallel mesh the statistics are the global batch's
        (:class:`GlobalBatchNorm`). ``gamma`` .. ``var`` default to the
        layer's (a sharded layer passes its blocks)."""
        if gamma is None:
            gamma, beta, mean, var = self.scale, self.bias_bn, self.mean, self.var
        mesh = active_mesh() if train else None
        if mesh is not None and mesh.distributed:
            return GlobalBatchNorm.apply(y.to(torch.float32), gamma, beta, mean, var,
                                         self.bn_momentum, self.bn_eps, mesh)
        if train and y.numel() == y.shape[-1]:
            y = y.to(torch.float32)
            bmean = y.reshape(-1)
            with torch.no_grad():
                m = self.bn_momentum
                mean.mul_(1 - m).add_(m * bmean.detach())
                var.mul_(1 - m)
            inv = torch.rsqrt(torch.full_like(bmean, self.bn_eps))
            return ((y - bmean) * inv * gamma + beta).reshape(y.shape)
        y = F.batch_norm(y.to(torch.float32).permute(0, 3, 1, 2), mean, var,
                         gamma, beta, training=train,
                         momentum=self.bn_momentum, eps=self.bn_eps)
        return y.permute(0, 2, 3, 1)

    def _float_forward(self, x: torch.Tensor, mode: QuantMode, train: bool) -> torch.Tensor:
        wspec, aspec = self.qconfig.weight, self.qconfig.activation
        w_axis = -1 if wspec.per_channel else None
        gamma, beta, bias, mean, var = self._local_vars()
        q_on = self.quantized and (mode.fake_quant or mode.observe)
        sharded = self.mp_layer is not None
        if sharded:
            x = self._mp_input(x, mode)
        w_obs, w_mp = self._weight_observer() if self.quantized else (None, False)
        if q_on and self.use_bn and train:
            sf = bn_scale_factor(gamma, var, self.bn_eps)
            w_q = observed_fake_quant(self.kernel * self._mp_weight_side(sf), w_obs, wspec,
                                      mode, w_axis, replicated=True, mp_sharded=w_mp)
            y = self._conv(x, w_q) / sf
            if bias is not None:
                y = y + bias
            y = self._batch_norm(y, True, gamma, beta, mean, var)
        elif q_on and self.use_bn:
            wf, bf = fold_bn(self.kernel, bias, gamma, beta, mean, var, self.bn_eps)
            if sharded and self.mp_layer[1] == 2:
                wf = fold_bn(self.kernel, bias, self._mp_weight_side(gamma), beta, mean, var,
                             self.bn_eps)[0]
            w_q = observed_fake_quant(wf, w_obs, wspec, mode, w_axis, replicated=True,
                                      mp_sharded=w_mp)
            y = self._conv(x, w_q) + bf
        elif q_on:  # quantized conv without BN (the classifier)
            w_q = observed_fake_quant(self.kernel, w_obs, wspec, mode, w_axis,
                                      replicated=True, mp_sharded=w_mp)
            y = self._conv(x, w_q)
            if bias is not None:
                y = y + bias
        else:
            y = self._conv(x, self.kernel)
            if bias is not None:
                y = y + bias
            if self.use_bn:
                y = self._batch_norm(y, train, gamma, beta, mean, var)
        if self.act == "relu":
            y = F.relu(y)
        elif self.act == "relu6":
            y = torch.clamp(y, 0.0, 6.0)
        elif self.act == "tanh":
            y = torch.tanh(y)
        if q_on:
            y = observed_fake_quant(y, self.act_obs, aspec, mode)
        return y.to(self.dtype)

    def _mp_weight_side(self, t: torch.Tensor) -> torch.Tensor:
        """A replicated per-out-channel factor of the weight: under
        in-channel sharding each rank's weight block gives it part of its
        gradient, summed over ``mp`` (``mp_enter``)."""
        if self.mp_layer is None or self.mp_layer[1] != 2:
            return t
        return mp_enter(t, self.mp_layer[0])

    def _mp_input(self, x: torch.Tensor, mode: QuantMode) -> torch.Tensor:
        """The input of a sharded layer: a replicated map entering an
        out-channel-sharded dense conv (its gradient summed over ``mp``), the
        rank's channels of a replicated map entering a sharded depthwise;
        a map already sharded (the depthwise after a sharded expand, the
        in-channel-sharded consumer) as it is."""
        mesh, axis = self.mp_layer
        if mode.observe and active_mesh() is None:
            raise RuntimeError("an mp-sharded layer observes only inside "
                               "parallel.data_parallel(mesh)")
        if axis != 3:
            return x
        if not self.depthwise:
            return mp_enter(x, mesh)
        return mp_slice(x, -1, mesh) if x.shape[-1] == self.in_features else x

    def forward(self, x, mode: QuantMode = FP32, train: bool = False):
        """NHWC float ``x`` in FP32/QAT/QAT_FROZEN and into a float block; a
        QTensor into a quantized block in INT8 (frozen)."""
        if not mode.int8 or not self.quantized:
            return self._float_forward(x, mode, train)
        if self._route == "depthwise":
            # (a channel split, ShuffleNetV2's, hands over a strided view)
            return QTensor(depthwise_int8(x.q.contiguous(), self._op), *self._out_t)
        if self._route == "grouped":
            acc = conv_acc(x.q, self._w64, self._in.zero_point, self.strides,
                           _pair(self.padding), self.groups, self.dilation)
            scale, bias, mult, qmin, qmax = self._epilogue
            q = requant_epilogue(acc, scale, bias, mult, self._out.zero_point,
                                 self.act in ("relu", "relu6"), qmin, qmax)
            return QTensor(q, *self._out_t)
        if self._route == "dense3x3":
            return QTensor(conv3x3_s1_int8(x.q, self._op), *self._out_t)
        a = self.matmul_input(x.q)
        q = int8_matmul_requant(a.reshape(-1, a.shape[-1]), self._op).reshape(a.shape[:3] + (self.features,))
        return QTensor(q, *self._out_t)

    def _zp_padded(self, q: torch.Tensor) -> torch.Tensor:
        """The codes padded by ``padding`` with the input's zero point."""
        ph, pw = _pair(self.padding)
        if not (ph or pw):
            return q
        return torch.nn.functional.pad(q, (0, 0, pw, pw, ph, ph), value=self._in.zero_point)

    def matmul_input(self, q: torch.Tensor) -> torch.Tensor:
        """The (B, Ho, Wo, K') matmul operand of the 1x1 and im2col routes:
        K' is the conv's K on the 1x1 route (the codes zero-point-padded,
        then strided); the im2col route pads it with zero columns to a
        multiple of 16 (``_patches``)."""
        if self._route == "matmul":
            q = self._zp_padded(q)
            return q[:, ::self.strides, ::self.strides, :] if self.strides != 1 else q
        return self._patches(q)
