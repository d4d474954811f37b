"""INT8 matmul with the fused requant epilogue (CUDA kernel ``csrc/int8_matmul.cu``).

Replaces the Pallas TPU kernel ``frostnet_tpu/ops/pallas_int8_matmul.py::
int8_matmul_requant``. It computes what the frozen JAX graph computes for an
INT8 1x1 convolution (``frostnet_tpu/nn/conv.py`` INT8 branch)::

    acc = x @ w + zterm             int32, zterm[n] = -zp_in * sum_k w[k, n]
    y   = fma(float(acc), scale[n], bias[n]), then ReLU if asked
    out = clamp(rint(y * out_mult) + out_zp, qmin, qmax) -> uint8

``x`` is the (M, K) uint8 activation codes (or int8 values). Taking the
codes unshifted gives the same int32 as the JAX package's ``(q - 128)``
form. The TPU kernel is the case of no ReLU, ``zterm = 0`` and [0, 255].
``x`` may carry extra columns up to the packed weight's row length (the
im2col route pads its rows to 16 bytes): they meet zero weights and are
ignored.

On the detection path (300x300, VOC geometry) one INT8 forward of the
SSDLite-MobileNetV2 feature net launches it 38 times: the stem by im2col
(M = B x 22,500, K = 27 in rows padded to 32, N = 32), every 1x1 of the
trunk, ``final_conv`` (K = 320, N = 1280 on the 19x19 map) and the extras'
1x1s (K = 1280 and 128, N = 32); Tiny-DSOD's launches it 39 times
(``base1`` by im2col, K = 27, N = 64; its 1x1s, K up to 736). The float head
launches none.

:func:`int8_matmul_requant` launches the kernel for CUDA tensors and runs
:func:`int8_matmul_requant_plain` for CPU tensors only. What bounds the
kernel and how it is built is in the source note of the ``.cu`` file.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import cuda_build
from .requant import epilogue_constants, requant_epilogue

# weight rows are zero-padded to a multiple of K_ALIGN bytes (the launcher
# checks it; TMA fills zeros from there to the end of a 128-byte K chunk)
K_ALIGN = 64


@dataclasses.dataclass
class MatmulOperands:
    """Frozen operands of one INT8 matmul: packed weight and epilogue."""

    wt: torch.Tensor        # (N, ldw) int8: the (K, N) weight, transposed, K zero-padded
    k: int
    zterm: torch.Tensor     # (N,) int32
    scale: torch.Tensor     # (N,) f32
    bias: torch.Tensor      # (N,) f32
    out_mult: float
    out_zp: int
    relu: bool
    qmin: int
    qmax: int

    @property
    def n(self) -> int:
        return self.wt.shape[0]


def pack_operands(w: torch.Tensor, zterm: torch.Tensor, scale: torch.Tensor,
                  bias: torch.Tensor, out_mult: float, out_zp: int, relu: bool,
                  qmin: int, qmax: int, device) -> MatmulOperands:
    """Pack a (K, N) int8 weight and its epilogue onto ``device``."""
    k, n = w.shape
    ldw = -(-k // K_ALIGN) * K_ALIGN
    wt = torch.zeros((n, ldw), dtype=torch.int8)
    wt[:, :k] = w.to(torch.int8).t()
    return MatmulOperands(
        wt=wt.to(device), k=k, zterm=zterm.to(torch.int32).to(device),
        scale=scale.to(torch.float32).reshape(n).to(device),
        bias=bias.to(torch.float32).reshape(n).to(device),
        out_mult=float(out_mult), out_zp=int(out_zp), relu=bool(relu),
        qmin=int(qmin), qmax=int(qmax))


def conv1x1_operands(qw: torch.Tensor, comb: torch.Tensor, bias: torch.Tensor,
                     in_zp: int, out_scale, out_zp, relu: bool, qmin: int,
                     qmax: int, device) -> MatmulOperands:
    """Operands of a frozen INT8 conv written as a matmul.

    ``qw`` is the (K, N) int8 weight, ``comb`` the input scale times the
    weight scale (0-dim when per-tensor), ``bias`` the folded float bias and
    ``in_zp`` the input zero point: ``zterm = -in_zp * sum_k qw``.
    """
    zterm = -int(in_zp) * qw.to(torch.int32).sum(dim=0)
    scale, bias, out_mult = epilogue_constants(comb, bias, out_scale, relu)
    return pack_operands(qw, zterm, scale, bias, out_mult, int(out_zp), relu,
                         qmin, qmax, device)


def int8_matmul_requant_plain(x: torch.Tensor, op: MatmulOperands) -> torch.Tensor:
    """The kernel's function in torch ops: (M, K) codes -> (M, N) uint8.

    The int32 product is taken in float64, which holds every partial sum of
    these int8 products exactly.
    """
    w = op.wt[:, :op.k].to(torch.float64).t()
    acc = (x[:, :op.k].to(torch.float64) @ w).to(torch.int32) + op.zterm
    return requant_epilogue(acc, op.scale, op.bias, op.out_mult, op.out_zp,
                            op.relu, op.qmin, op.qmax)


def _bind():
    lib = cuda_build.load("int8_matmul")
    fn = lib.frost_int8_matmul_requant
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, f, f, f, f, p]
        fn.restype = i
        lib.frost_int8_matmul_error_string.argtypes = [i]
        lib.frost_int8_matmul_error_string.restype = ctypes.c_char_p
    return lib


def int8_matmul_requant(x: torch.Tensor, op: MatmulOperands) -> torch.Tensor:
    """(M, K') uint8/int8 -> (M, N) uint8 through the CUDA kernel.

    CPU tensors take the plain version; a CUDA tensor launches the kernel
    (or raises). Each launch adds one to ``int8_matmul_requant.launches``.
    """
    if x.dim() != 2 or not op.k <= x.shape[1] <= op.wt.shape[1]:
        raise ValueError(f"x must be (M, K) with {op.k} <= K <= {op.wt.shape[1]}, "
                         f"got {tuple(x.shape)}")
    if x.dtype not in (torch.uint8, torch.int8):
        raise TypeError(f"x must be uint8 or int8, got {x.dtype}")
    if x.device != op.wt.device:
        raise ValueError(f"x on {x.device}, operands on {op.wt.device}")
    if x.device.type == "cpu":
        return int8_matmul_requant_plain(x, op)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x = x.contiguous()
    m = x.shape[0]
    out = torch.empty((m, op.n), dtype=torch.uint8, device=x.device)
    lib = _bind()
    err = lib.frost_int8_matmul_requant(
        x.data_ptr(), op.wt.data_ptr(), op.zterm.data_ptr(), op.scale.data_ptr(),
        op.bias.data_ptr(), out.data_ptr(), m, op.n, x.shape[1], op.wt.shape[1],
        int(x.dtype == torch.uint8), int(op.relu), op.out_mult, float(op.out_zp),
        float(op.qmin), float(op.qmax), torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(err, lib.frost_int8_matmul_error_string, "int8_matmul_requant")
    int8_matmul_requant.launches += 1
    return out


int8_matmul_requant.launches = 0
