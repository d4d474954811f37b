"""INT8 depthwise conv with the fused requant epilogue (CUDA kernel
``csrc/depthwise_int8.cu``).

Added, not ported: the JAX package computes the INT8 depthwise conv as XLA
code (``frostnet_tpu/nn/conv.py``'s INT8 branch), not as a Pallas TPU kernel.
It computes what :func:`depthwise_int8_plain` computes, the INT8 depthwise
route of ``nn/conv.py::QConvBNAct`` as torch ops::

    acc = requant.depthwise_acc(x, taps, kernel, stride, zp_in, dilation, padding)
    out = requant.requant_epilogue(acc, scale, bias, out_mult, out_zp, relu, qmin, qmax)

bit for bit: the kernel adds the same int32 products (the zero point folded
into ``zterm``) and rounds as ``csrc/requant.cuh::requant_acc`` does. Any
kernel shape, stride, dilation, padding and channel multiplier (output
channel ``oc`` reads input channel ``oc // m``) and any channel count.

:func:`depthwise_int8` calls the ``torch.library`` op
``frostnet::depthwise_int8`` where ``torch.export`` traces it (the operands'
fields by name): its CUDA implementation launches the kernel, its CPU
implementation is :func:`depthwise_int8_plain`, for CPU tensors only.
Called eagerly, the wrapper runs the plain version on CPU tensors and
launches the kernel on CUDA tensors (or raises), without the dispatcher.
What bounds the kernel and how it is built is in the source note of the
``.cu`` file.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import torch

from ..utils.profiling import span
from . import cuda_build
from .requant import depthwise_acc, epilogue_constants, requant_epilogue


@dataclasses.dataclass(frozen=True, eq=False)
class DepthwiseOperands:
    """Frozen operands of one INT8 depthwise conv."""

    taps: torch.Tensor      # (kh * kw, Cout) int8, tap (dy, dx) in row dy * kw + dx
    zterm: torch.Tensor     # (Cout,) int32 = -zp_in * sum over the taps
    scale: torch.Tensor     # (Cout,) f32
    bias: torch.Tensor      # (Cout,) f32
    out_mult: float
    zp_in: int
    out_zp: int
    relu: bool
    qmin: int
    qmax: int
    kernel: Tuple[int, int]
    stride: int
    dilation: int
    padding: Tuple[int, int]

    @property
    def cout(self) -> int:
        return self.taps.shape[1]

    def out_hw(self, h: int, w: int) -> Tuple[int, int]:
        (kh, kw), (ph, pw), s, d = self.kernel, self.padding, self.stride, self.dilation
        return (h + 2 * ph - d * (kh - 1) - 1) // s + 1, (w + 2 * pw - d * (kw - 1) - 1) // s + 1


def depthwise_operands(qw: torch.Tensor, comb: torch.Tensor, bias: torch.Tensor, in_zp: int,
                       out_scale, out_zp, relu: bool, qmin: int, qmax: int, stride: int,
                       dilation: int, padding: Tuple[int, int], device) -> DepthwiseOperands:
    """Pack a frozen depthwise conv: ``qw`` the (kh, kw, 1, Cout) int8 weight,
    ``comb`` the input scale times the weight scale (0-dim when per-tensor),
    ``bias`` the folded float bias, ``in_zp`` the input zero point."""
    kh, kw, _, cout = qw.shape
    taps = qw.reshape(kh * kw, cout)
    zterm = -int(in_zp) * taps.to(torch.int32).sum(dim=0)
    scale, bias, out_mult = epilogue_constants(comb, bias, out_scale, relu)
    return DepthwiseOperands(
        taps=taps.to(torch.int8).contiguous().to(device), zterm=zterm.to(torch.int32).to(device),
        scale=scale.reshape(cout).to(device), bias=bias.reshape(cout).to(device),
        out_mult=float(out_mult), zp_in=int(in_zp), out_zp=int(out_zp), relu=bool(relu),
        qmin=int(qmin), qmax=int(qmax), kernel=(int(kh), int(kw)), stride=int(stride),
        dilation=int(dilation), padding=(int(padding[0]), int(padding[1])))


def depthwise_int8_plain(x: torch.Tensor, op: DepthwiseOperands) -> torch.Tensor:
    """The kernel's function in torch ops: (B, H, W, C) codes -> (B, Ho, Wo, Cout)."""
    acc = depthwise_acc(x, op.taps, op.kernel, op.stride, op.zp_in, op.dilation, op.padding)
    return requant_epilogue(acc, op.scale, op.bias, op.out_mult, op.out_zp, op.relu,
                            op.qmin, op.qmax)


def _bind():
    lib = cuda_build.load("depthwise_int8")
    fn = lib.frost_depthwise_int8
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, p] + [i] * 13 + [f] * 4 + [p]
        fn.restype = i
        lib.frost_depthwise_int8_error_string.argtypes = [i]
        lib.frost_depthwise_int8_error_string.restype = ctypes.c_char_p
    return lib


def depthwise_int8(x: torch.Tensor, op: DepthwiseOperands) -> torch.Tensor:
    """(B, H, W, C) uint8 -> (B, Ho, Wo, Cout) uint8 through the CUDA kernel.

    CPU tensors take the plain version; a CUDA tensor launches the kernel
    on the current stream (or raises); under ``torch.export`` the call is
    the op. Each launch adds one to ``depthwise_int8.launches``.
    """
    with span("ops.depthwise"):
        if x.dim() != 4 or op.cout % x.shape[3] != 0:
            raise ValueError(f"x must be (B, H, W, C) with C dividing {op.cout}, "
                             f"got {tuple(x.shape)}")
        if x.dtype != torch.uint8:
            raise TypeError(f"x must be uint8 codes, got {x.dtype}")
        if x.device != op.taps.device:
            raise ValueError(f"x on {x.device}, operands on {op.taps.device}")
        if cuda_build.traced(x):
            return torch.ops.frostnet.depthwise_int8(x, *cuda_build.fields(op))
        if x.device.type == "cpu":
            return depthwise_int8_plain(x, op)
        if x.device.type != "cuda":
            raise ValueError(f"unsupported device {x.device}")
        if not x.is_contiguous():
            raise ValueError("x must be contiguous (NHWC codes)")
        return _launch(x, op)


depthwise_int8.launches = 0


def _launch(x: torch.Tensor, op: DepthwiseOperands) -> torch.Tensor:
    b, h, w, c = x.shape
    ho, wo = op.out_hw(h, w)
    out = torch.empty((b, ho, wo, op.cout), dtype=torch.uint8, device=x.device)
    lib = _bind()
    (kh, kw), (ph, pw) = op.kernel, op.padding
    err = lib.frost_depthwise_int8(
        x.data_ptr(), op.taps.data_ptr(), op.zterm.data_ptr(), op.scale.data_ptr(),
        op.bias.data_ptr(), out.data_ptr(), b, h, w, c, op.cout // c, kh, kw, op.stride,
        op.dilation, ph, pw, op.zp_in, int(op.relu), op.out_mult, float(op.out_zp),
        float(op.qmin), float(op.qmax), torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(err, lib.frost_depthwise_int8_error_string, "depthwise_int8")
    depthwise_int8.launches += 1
    return out


# The op, for torch.export: the x and the operands' fields in their dataclass
# order (a schema ``float`` is a double, which holds a float32 exactly; an
# ``int[]`` pair comes back as a list). Registered on the dispatcher directly,
# as the other kernels' ops are: CUDA launches, CPU runs the plain version,
# the fake implementation gives the output's shape.
def _operands(*f) -> DepthwiseOperands:
    kw = dict(zip((fl.name for fl in dataclasses.fields(DepthwiseOperands)), f))
    return DepthwiseOperands(**{**kw, "kernel": tuple(kw["kernel"]),
                                "padding": tuple(kw["padding"])})


def _op_fake(x, *f):
    op = _operands(*f)
    return x.new_empty((x.shape[0], *op.out_hw(x.shape[1], x.shape[2]), op.cout),
                       dtype=torch.uint8)


_LIB = torch.library.Library("frostnet", "FRAGMENT")
_LIB.define("depthwise_int8(Tensor x, Tensor taps, Tensor zterm, Tensor scale, Tensor bias, "
            "float out_mult, int zp_in, int out_zp, bool relu, int qmin, int qmax, "
            "int[] kernel, int stride, int dilation, int[] padding) -> Tensor")
_LIB.impl("depthwise_int8", lambda x, *f: depthwise_int8_plain(x, _operands(*f)), "CPU")
_LIB.impl("depthwise_int8", lambda x, *f: _launch(x.contiguous(), _operands(*f)), "CUDA")
torch.library.register_fake("frostnet::depthwise_int8", _op_fake, lib=_LIB)
