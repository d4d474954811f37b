"""Dense 3x3 stride-1 INT8 conv with the fused requant epilogue (CUDA kernel
``csrc/int8_conv.cu``).

Replaces the Pallas TPU kernel ``frostnet_tpu/ops/pallas_int8_conv.py::
conv3x3_s1_int8``. It computes what the frozen JAX graph computes for a dense
3x3 stride-1 INT8 conv with 'same' padding (``frostnet_tpu/nn/conv.py`` INT8
branch, the s32 ``lax.conv`` and its epilogue): the GAN generator's convs and
the ResNets' non-strided 3x3s::

    acc = sum_{dy,dx,c} (x - zp_in)[h+dy-1, w+dx-1, c] * qw[dy, dx, c, o]   int32,
          taps outside the image are 0 (they read the zero point)
    y   = fma(float(acc), scale[o], bias[o]), then ReLU if asked
    out = clamp(rint(y * out_mult) + out_zp, qmin, qmax) -> uint8

``x`` is the (B, H, W, Cin) uint8 codes, unpadded and unshifted: the kernel
pads with the zero point itself and adds ``zterm = -zp_in * sum(qw)``. The
TPU kernel's VMEM gate (``usable``, ``pick_h_tile``) has no counterpart:
the CUDA kernel takes any H, W, Cin and Cout, masking its edge tiles (rows
of channels that are not 4-byte aligned, an RGB image's 3 among them, are
staged by byte loads, unaligned output rows stored byte by byte).

:func:`conv3x3_s1_int8` calls the ``torch.library`` op
``frostnet::conv3x3_s1_int8`` where ``torch.export`` traces it (the operands'
fields by name): its CUDA implementation launches the kernel, its CPU
implementation is :func:`conv3x3_s1_int8_plain`, for CPU tensors only.
Called eagerly, the wrapper goes to the same launch without the dispatcher.
What bounds the kernel and how it is built is in the source note of the
``.cu`` file.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..utils.profiling import span
from . import cuda_build
from .requant import conv_acc, epilogue_constants, requant_epilogue

KC = 32  # input channels per kernel stage; the packed weight pads Cin to it


@dataclasses.dataclass
class Conv3x3Operands:
    """Frozen operands of one dense 3x3 stride-1 INT8 conv."""

    # (cin_pad / KC, 9, KC / 16, Cout, 16) int8: qw[dy, dx, c, o] at
    # [c // KC, 3*dy+dx, (c % KC) // 16, o, c % 16], zero past Cin. One
    # chunk's 16-channel slice of one tap is contiguous over o, as the
    # kernel stages it (16 bytes per output channel).
    wt: torch.Tensor
    cin: int
    zp_in: int
    zterm: torch.Tensor     # (Cout,) int32 = -zp_in * sum(qw[..., o])
    scale: torch.Tensor     # (Cout,) f32
    bias: torch.Tensor      # (Cout,) f32
    out_mult: float
    out_zp: int
    relu: bool
    qmin: int
    qmax: int

    @property
    def cout(self) -> int:
        return self.wt.shape[3]

    def weight(self) -> torch.Tensor:
        """The (Cout, Cin, 3, 3) int8 weight (torch's conv layout)."""
        w = self.wt.permute(3, 1, 0, 2, 4).reshape(self.cout, 9, -1)[:, :, :self.cin]
        return w.reshape(self.cout, 3, 3, self.cin).permute(0, 3, 1, 2)


def conv3x3_operands(qw: torch.Tensor, comb: torch.Tensor, bias: torch.Tensor, in_zp: int,
                     out_scale, out_zp, relu: bool, qmin: int, qmax: int,
                     device) -> Conv3x3Operands:
    """Pack a frozen conv: ``qw`` (3, 3, Cin, Cout) int8, ``comb`` the input
    scale times the weight scale (0-dim when per-tensor), ``bias`` the folded
    float bias, ``in_zp`` the input zero point."""
    kh, kw, cin, cout = qw.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"a 3x3 weight is needed, got {tuple(qw.shape)}")
    cin_pad = -(-cin // KC) * KC
    wt = torch.zeros((cout, 9, cin_pad), dtype=torch.int8)
    wt[:, :, :cin] = qw.to(torch.int8).permute(3, 0, 1, 2).reshape(cout, 9, cin)
    wt = wt.reshape(cout, 9, cin_pad // KC, KC // 16, 16).permute(2, 1, 3, 0, 4).contiguous()
    zterm = -int(in_zp) * qw.to(torch.int32).sum(dim=(0, 1, 2))
    scale, bias, out_mult = epilogue_constants(comb, bias, out_scale, relu)
    return Conv3x3Operands(
        wt=wt.to(device), cin=cin, zp_in=int(in_zp), zterm=zterm.to(torch.int32).to(device),
        scale=scale.reshape(cout).to(device), bias=bias.reshape(cout).to(device),
        out_mult=float(out_mult), out_zp=int(out_zp), relu=bool(relu),
        qmin=int(qmin), qmax=int(qmax))


def conv3x3_acc(x: torch.Tensor, op: Conv3x3Operands) -> torch.Tensor:
    """The int32 accumulator, zero-point term included (``requant.conv_acc``:
    a float64 conv, exact, rounded once)."""
    return conv_acc(x, op.weight().to(torch.float64).contiguous(), op.zp_in)


def conv3x3_s1_int8_plain(x: torch.Tensor, op: Conv3x3Operands) -> torch.Tensor:
    """The kernel's function in torch ops: (B, H, W, Cin) codes -> (B, H, W, Cout)."""
    return requant_epilogue(conv3x3_acc(x, op), op.scale, op.bias, op.out_mult, op.out_zp,
                            op.relu, op.qmin, op.qmax)


def _bind():
    lib = cuda_build.load("int8_conv")
    fn = lib.frost_conv3x3_s1_int8
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, f, f, f, f, p]
        fn.restype = i
        lib.frost_conv3x3_error_string.argtypes = [i]
        lib.frost_conv3x3_error_string.restype = ctypes.c_char_p
    return lib


def conv3x3_s1_int8(x: torch.Tensor, op: Conv3x3Operands) -> torch.Tensor:
    """(B, H, W, Cin) uint8 -> (B, H, W, Cout) uint8 through the CUDA kernel.

    CPU tensors take the plain version; a CUDA tensor launches the kernel
    (or raises); under ``torch.export`` the call is the op. Each launch adds
    one to ``conv3x3_s1_int8.launches``.
    """
    with span("ops.int8_conv"):
        if x.dim() != 4 or x.shape[3] != op.cin:
            raise ValueError(f"x must be (B, H, W, {op.cin}), got {tuple(x.shape)}")
        if x.dtype != torch.uint8:
            raise TypeError(f"x must be uint8 codes, got {x.dtype}")
        if x.device != op.wt.device:
            raise ValueError(f"x on {x.device}, operands on {op.wt.device}")
        if cuda_build.traced(x):
            return torch.ops.frostnet.conv3x3_s1_int8(x, *cuda_build.fields(op))
        if x.device.type == "cpu":
            return conv3x3_s1_int8_plain(x, op)
        if x.device.type != "cuda":
            raise ValueError(f"unsupported device {x.device}")
        return _launch(x, op)


conv3x3_s1_int8.launches = 0


def _launch(x: torch.Tensor, op: Conv3x3Operands) -> torch.Tensor:
    """Launch the kernel on the current stream (raises if the build or the
    launch fails)."""
    x = x.contiguous()
    b, h, w, _ = x.shape
    out = torch.empty((b, h, w, op.cout), dtype=torch.uint8, device=x.device)
    lib = _bind()
    err = lib.frost_conv3x3_s1_int8(
        x.data_ptr(), op.wt.data_ptr(), op.zterm.data_ptr(), op.scale.data_ptr(),
        op.bias.data_ptr(), out.data_ptr(), b, h, w, op.cin, op.cout, op.wt.shape[0] * KC,
        op.zp_in, int(op.relu), op.out_mult, float(op.out_zp), float(op.qmin),
        float(op.qmax), torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(err, lib.frost_conv3x3_error_string, "conv3x3_s1_int8")
    conv3x3_s1_int8.launches += 1
    return out


# The op, for torch.export: the x and the operands' fields in their dataclass
# order (a schema ``float`` is a double, which holds a float32 exactly).
# Registered on the dispatcher directly (not ``torch.library.custom_op``, whose
# Python autograd layer runs at every call): CUDA launches, CPU runs the plain
# version, the fake implementation gives the output's shape.
_LIB = torch.library.Library("frostnet", "FRAGMENT")
_LIB.define("conv3x3_s1_int8(Tensor x, Tensor wt, int cin, int zp_in, Tensor zterm, "
            "Tensor scale, Tensor bias, float out_mult, int out_zp, bool relu, int qmin, "
            "int qmax) -> Tensor")
_LIB.impl("conv3x3_s1_int8", lambda x, *f: conv3x3_s1_int8_plain(x, Conv3x3Operands(*f)), "CPU")
_LIB.impl("conv3x3_s1_int8", lambda x, *f: _launch(x, Conv3x3Operands(*f)), "CUDA")
torch.library.register_fake(
    "frostnet::conv3x3_s1_int8",
    lambda x, wt, *f: x.new_empty(tuple(x.shape[:3]) + (wt.shape[3],), dtype=torch.uint8),
    lib=_LIB)
