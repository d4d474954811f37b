"""Bilinear resize (``align_corners``) with the rounding of the frozen JAX graph.

The JAX package resizes NHWC tensors with two float32 einsums against
host-built interpolation matrices (``frostnet_tpu/ops/resize.py``), the H
pass first. Each output is the dot of one matrix row with the input, and a
row has at most two nonzero taps, ``lo = floor(pos)`` and ``lo + 1``. The
zero taps add exact zeros. How XLA's CPU dot rounds the two taps depends on
the pass's output side (read from its output at the GAN's and the
segmentation models' sizes, for 16 or more channels):

* a multiple of 64 (the GAN's 64 -> 128 and 128 -> 256, the segmentation
  tails' 96 -> 768, 8 -> 64, 48 -> 192): fused multiply-adds in index order,
  the ``lo`` product rounded, then ``fma(w_hi, x_hi, w_lo * x_lo)``;
* any other side (the LR-ASPP heads' 48 -> 96, 6 -> 12, 4 -> 8; the 96
  crop's tail 12 -> 96): each product rounded, then their sum,
  ``w_lo * x_lo + w_hi * x_hi``.

:func:`resize_bilinear_plain` writes these forms as elementwise torch ops,
so it gives the same bits on any device (no cuBLAS, whose order of
summation is not specified). ``tests/test_torch_resize.py`` holds it
bit-exact against the JAX function at each of those sizes.

:func:`resize_bilinear` launches the CUDA kernel ``csrc/resize_bilinear.cu``
(both passes, the same roundings; ``tests/test_torch_resize_kernel.py``
holds it bit-exact to the plain version) for a CUDA tensor, with the tap
tables kept on the card (:func:`resize_tables`): after the first call at a
shape it copies nothing from the host, so a CUDA graph can capture it. CPU
tensors take the plain version. Where the input's gradient is recorded, or
``torch.export`` traces the call, the wrapper calls the ``torch.library`` op
``frostnet::resize_bilinear``: its CUDA implementation launches the kernel,
its CPU implementation is the plain version, and its gradient is the two
passes' transposes (:func:`resize_bilinear_transpose`, the ops that autograd
runs through the plain version). Each launch adds one to
``resize_bilinear.launches``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from ..utils.profiling import span
from . import cuda_build
from .requant import fma_f32

SMEM_BYTES = 48 * 1024  # the most shared memory a block of the kernel takes


def _taps(n_in: int, n_out: int, align_corners: bool):
    """(lo, hi, w_lo, w_hi) of each output row, the float32 weights of the
    reference's interpolation matrix. Where both taps fall on one input
    (``pos == n_in - 1``), ``w_hi`` is 0."""
    if n_out == 1:
        pos = np.zeros((1,), np.float64)
    elif align_corners:
        pos = np.linspace(0.0, n_in - 1.0, n_out)
    else:
        pos = np.clip((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5, 0.0, n_in - 1.0)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    w = (pos - lo).astype(np.float64)
    return lo, hi, (1.0 - w).astype(np.float32), w.astype(np.float32)


def _linear_matrix(n_in: int, n_out: int, align_corners: bool) -> np.ndarray:
    """(n_out, n_in) row-stochastic interpolation matrix (host-computed)."""
    lo, hi, w_lo, w_hi = _taps(n_in, n_out, align_corners)
    m = np.zeros((n_out, n_in), np.float32)
    m[np.arange(n_out), lo] += w_lo
    m[np.arange(n_out), hi] += w_hi
    return m


def _interp(x: torch.Tensor, dim: int, n_out: int, align_corners: bool) -> torch.Tensor:
    lo, hi, w_lo, w_hi = _taps(x.shape[dim], n_out, align_corners)
    dev = x.device
    shape = [1] * x.dim()
    shape[dim] = n_out

    def weight(w):
        return torch.as_tensor(w, device=dev).reshape(shape)

    x_lo = x.index_select(dim, torch.as_tensor(lo, device=dev))
    x_hi = x.index_select(dim, torch.as_tensor(hi, device=dev))
    if n_out % 64 == 0:
        return fma_f32(x_hi, weight(w_hi), x_lo * weight(w_lo))
    return x_lo * weight(w_lo) + x_hi * weight(w_hi)


def resize_bilinear_plain(x: torch.Tensor, size: Tuple[int, int],
                          align_corners: bool = True) -> torch.Tensor:
    """NHWC bilinear resize to ``size`` = (H, W) in float32 torch ops, out in
    ``x``'s dtype."""
    h_out, w_out = size
    if tuple(x.shape[1:3]) == (h_out, w_out):
        return x
    y = _interp(x.to(torch.float32), 1, h_out, align_corners)
    return _interp(y, 2, w_out, align_corners).to(x.dtype)


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int],
                    align_corners: bool = True) -> torch.Tensor:
    """NHWC bilinear resize to ``size`` = (H, W), computed in float32, out in
    ``x``'s dtype: the CUDA kernel for a CUDA tensor (or it raises),
    :func:`resize_bilinear_plain` for a CPU tensor, the op where the call is
    traced or the gradient recorded."""
    h_out, w_out = size
    if tuple(x.shape[1:3]) == (h_out, w_out):
        return x
    args = (int(h_out), int(w_out), bool(align_corners))
    if cuda_build.traced(x):
        return torch.ops.frostnet.resize_bilinear(x, *args)
    if x.device.type == "cpu":
        return resize_bilinear_plain(x, size, align_corners)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    with span("ops.resize"):
        if torch.is_grad_enabled() and x.requires_grad:
            return torch.ops.frostnet.resize_bilinear(x, *args)
        return _launch(x, *args)


resize_bilinear.launches = 0

_TABLES: Dict[tuple, torch.Tensor] = {}
_PLANS: Dict[tuple, Tuple[int, int]] = {}


def resize_tables(n_in: int, n_out: int, align_corners: bool, device) -> torch.Tensor:
    """The (4, n_out) int32 taps of one pass on ``device``: ``lo``, ``hi``
    and the float32 bits of ``w_lo`` and ``w_hi`` (:func:`_taps`), built and
    copied once per (n_in, n_out, align_corners, device)."""
    key = (n_in, n_out, bool(align_corners), torch.device(device))
    tables = _TABLES.get(key)
    if tables is None:
        lo, hi, w_lo, w_hi = _taps(n_in, n_out, align_corners)
        host = np.stack([lo.astype(np.int32), hi.astype(np.int32), w_lo.view(np.int32),
                         w_hi.view(np.int32)])
        tables = _TABLES[key] = torch.from_numpy(host).to(device)
    return tables


def resize_plan(w_in: int, w_out: int, align_corners: bool, c: int) -> Tuple[int, int]:
    """(output columns a block, shared-memory bytes a block) of
    the kernel's W pass: the whole row where its input span fits in
    :data:`SMEM_BYTES` (16 bytes a column's taps, 4 a value of the span),
    else tiles of half as many columns, and so on."""
    key = (w_in, w_out, bool(align_corners), c)
    plan = _PLANS.get(key)
    if plan is None:
        lo, hi, _, _ = _taps(w_in, w_out, align_corners)
        tile = w_out
        while True:
            starts = np.arange(0, w_out, tile)
            ends = np.minimum(starts + tile, w_out) - 1
            smem = int(16 * tile + 4 * c * int((hi[ends] - lo[starts]).max() + 1))
            if smem <= SMEM_BYTES:
                break
            if tile == 1:
                raise ValueError(f"resize_bilinear: {c} channels need {smem} bytes of shared "
                                 f"memory a column, over the kernel's {SMEM_BYTES}")
            tile = (tile + 1) // 2
        plan = _PLANS[key] = (tile, smem)
    return plan


def _bind():
    lib = cuda_build.load("resize_bilinear")
    fn = lib.frost_resize_bilinear
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p] + [i] * 10 + [p]
        fn.restype = i
        lib.frost_resize_bilinear_error_string.argtypes = [i]
        lib.frost_resize_bilinear_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x: torch.Tensor, h_out: int, w_out: int, align_corners: bool) -> torch.Tensor:
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    b, h, w, c = x.shape
    src = x.to(torch.float32).contiguous()
    out = torch.empty((b, h_out, w_out, c), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out.to(x.dtype)
    th = resize_tables(h, h_out, align_corners, x.device)
    tw = resize_tables(w, w_out, align_corners, x.device)
    tile, smem = resize_plan(w, w_out, align_corners, c)
    lib = _bind()
    err = lib.frost_resize_bilinear(
        src.data_ptr(), out.data_ptr(), th.data_ptr(), tw.data_ptr(), b, h, w, c, h_out, w_out,
        tile, smem, int(h_out % 64 == 0), int(w_out % 64 == 0),
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(err, lib.frost_resize_bilinear_error_string, "resize_bilinear")
    resize_bilinear.launches += 1
    return out.to(x.dtype)


def _transpose(g: torch.Tensor, dim: int, n_in: int, align_corners: bool) -> torch.Tensor:
    """The gradient of one :func:`_interp` pass along ``dim``: each output's
    gradient times its two weights, added into its ``lo`` and its ``hi`` tap
    apart, then summed, as autograd adds the two ``index_select``
    gradients."""
    taps = resize_tables(n_in, g.shape[dim], align_corners, g.device)
    shape = [1] * g.dim()
    shape[dim] = -1
    full = list(g.shape)
    full[dim] = n_in

    def part(index, weight):
        return g.new_zeros(full).index_add_(dim, index, g * weight.view(torch.float32)
                                            .reshape(shape))

    return part(taps[0], taps[2]) + part(taps[1], taps[3])


def resize_bilinear_transpose(g: torch.Tensor, size: Tuple[int, int],
                              align_corners: bool = True) -> torch.Tensor:
    """The gradient of :func:`resize_bilinear_plain` from an input of
    ``size`` = (H, W) to ``g``'s size, with respect to that input: the W
    pass's transpose, then the H pass's, in float32."""
    h, w = size
    return _transpose(_transpose(g.to(torch.float32), 2, w, align_corners), 1, h, align_corners)


# The op: the CUDA implementation launches, the CPU one runs the plain
# version, the fake one gives the output's shape, and the gradient is the
# transposes in the input's dtype.
def _op_fake(x, h_out, w_out, align_corners):
    return x.new_empty((x.shape[0], h_out, w_out, x.shape[3]))


def _op_setup(ctx, inputs, output):
    x, _, _, align_corners = inputs
    ctx.size, ctx.dtype, ctx.align_corners = tuple(x.shape[1:3]), x.dtype, align_corners


def _op_backward(ctx, g):
    return (resize_bilinear_transpose(g, ctx.size, ctx.align_corners).to(ctx.dtype),
            None, None, None)


_LIB = torch.library.Library("frostnet", "FRAGMENT")
_LIB.define("resize_bilinear(Tensor x, int h_out, int w_out, bool align_corners) -> Tensor")
_LIB.impl("resize_bilinear", lambda x, h, w, ac: resize_bilinear_plain(x, (h, w), ac), "CPU")
_LIB.impl("resize_bilinear", _launch, "CUDA")
torch.library.register_fake("frostnet::resize_bilinear", _op_fake, lib=_LIB)
torch.library.register_autograd("frostnet::resize_bilinear", _op_backward,
                                setup_context=_op_setup, lib=_LIB)
