"""Observe and fake-quantize a per-tensor QAT site (CUDA kernel ``csrc/fake_quant.cu``).

Replaces the Pallas TPU kernel ``frostnet_tpu/ops/pallas_fake_quant.py::
_fq_observe_fwd`` (with its custom VJP ``fake_quant_observe``). The port
runs it at every per-tensor site of a QAT forward (``nn/quant_ops.py``
``observed_fake_quant``), where it computes what the JAX train step
computes there through ``apply_observer``::

    state    <- update_observer(state, x)          (in place; QAT only)
    scale,zp  = calculate_qparams_traced(state)
    y, mask   = fake_quantize(x, scale, zp)         (y in x's dtype)

The kernel makes two launches, both counted in
``fake_quant_observe.launches``: a statistics pass that finishes the
observer step and the qparams on the device, and a quantize pass that
derives the qparams from the state in every thread. QAT_FROZEN
(``observe=False``) makes the quantize launch alone. No launch waits for
the host. The backward is ``where(mask, g, 0)``, a torch op, as the TPU
kernel's VJP is plain JAX.

:func:`fake_quant_observe_plain` is the same function in torch ops
(``quant.observer`` and ``quant.fake_quant``); the wrapper runs it for CPU
tensors only and launches the kernel (or raises) for CUDA tensors.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from ..quant.fake_quant import fake_quant_forward, ste_backward
from ..quant.observer import (ObserverState, calculate_qparams_traced, qparams_range_factor,
                              update_observer)
from ..quant.qtypes import SCALE_EPS, QSpec
from . import cuda_build

MAX_BLOCKS = 132 * 8  # grid cap: 8 blocks of 256 threads per H100 SM

_SCRATCH: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


def fake_quant_observe_plain(x: torch.Tensor, state: ObserverState, spec: QSpec,
                             observe: bool = True):
    """(y, mask, new_state, scale, zero_point) of one per-tensor site, in torch ops."""
    if observe:
        state = update_observer(state, x, spec)
    scale, zp = calculate_qparams_traced(state, spec)
    y, mask = fake_quant_forward(x, scale, zp, spec.qmin, spec.qmax)
    return y, mask, state, scale, zp


def _bind():
    lib = cuda_build.load("fake_quant")
    if lib.frost_fq_stats.argtypes is None:
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.frost_fq_stats.argtypes = [p, i, ll, i, p, p, p, p, p, i, f, i, f, f, f, f, f, i, p]
        lib.frost_fq_stats.restype = i
        lib.frost_fq_quantize.argtypes = [p, p, p, i, ll, i, p, p, f, f, f, f, f, i, i, p]
        lib.frost_fq_quantize.restype = i
        lib.frost_fq_error_string.argtypes = [i]
        lib.frost_fq_error_string.restype = ctypes.c_char_p
    return lib


def _scratch(device: torch.device):
    """Per-device partials (2 floats per block) and the last-block ticket,
    which the kernel leaves at 0 for the next launch."""
    buf = _SCRATCH.get(device)
    if buf is None:
        buf = (torch.empty(2 * MAX_BLOCKS, dtype=torch.float32, device=device),
               torch.zeros(1, dtype=torch.int32, device=device))
        _SCRATCH[device] = buf
    return buf


@functools.lru_cache(maxsize=None)
def _grid_args(spec: QSpec):
    """The kernel's grid constants of ``spec`` (computed once per spec)."""
    sym_zp = 0.0 if spec.qmin < 0 else 128.0
    return (float(spec.qmin), float(spec.qmax), qparams_range_factor(spec), SCALE_EPS,
            sym_zp, int(spec.symmetric))


def _check(x: torch.Tensor, min_val: torch.Tensor, max_val: torch.Tensor):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.numel() == 0:
        raise ValueError("x is empty")
    for t in (min_val, max_val):
        if t.shape != () or t.dtype != torch.float32 or t.device != x.device:
            raise ValueError("the observer state must be float32 scalars on x's device "
                             "(per-tensor sites only)")


def fake_quant_observe(x: torch.Tensor, min_val: torch.Tensor, max_val: torch.Tensor,
                       spec: QSpec, observe: bool = True):
    """(y, mask, qparams) of one per-tensor site; the state is updated in place.

    ``min_val``/``max_val`` are the observer's float32 scalar buffers.
    ``qparams`` is a (2,) float32 tensor (scale, zero point) after a
    statistics pass, None when ``observe`` is False. CPU tensors take the
    plain version; a CUDA tensor launches the kernel (or raises).
    """
    _check(x, min_val, max_val)
    if x.device.type == "cpu":
        y, mask, st, scale, zp = fake_quant_observe_plain(
            x, ObserverState(min_val, max_val), spec, observe)
        if not observe:
            return y, mask, None
        with torch.no_grad():
            min_val.copy_(st.min_val)
            max_val.copy_(st.max_val)
        return y, mask, torch.stack([scale, zp.to(torch.float32)])
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x = x.contiguous()
    n = x.numel()
    aligned = int(x.data_ptr() % 16 == 0)
    is_bf16 = int(x.dtype == torch.bfloat16)
    grid = _grid_args(spec)
    lib = _bind()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    qparams = None
    if observe:
        partials, ticket = _scratch(x.device)
        qparams = torch.empty(2, dtype=torch.float32, device=x.device)
        c = spec.averaging_constant
        err = lib.frost_fq_stats(
            x.data_ptr(), is_bf16, n, aligned, min_val.data_ptr(), max_val.data_ptr(),
            qparams.data_ptr(), partials.data_ptr(), ticket.data_ptr(), MAX_BLOCKS,
            0.0 if c is None else float(c), int(c is not None), *grid, stream)
        cuda_build.check(err, lib.frost_fq_error_string, "fake_quant_observe (stats)")
        fake_quant_observe.launches += 1
    y = torch.empty_like(x)
    mask = torch.empty(x.shape, dtype=torch.bool, device=x.device)
    err = lib.frost_fq_quantize(
        x.data_ptr(), y.data_ptr(), mask.data_ptr(), is_bf16, n, aligned,
        min_val.data_ptr(), max_val.data_ptr(), *grid, MAX_BLOCKS * 2, stream)
    cuda_build.check(err, lib.frost_fq_error_string, "fake_quant_observe (quantize)")
    fake_quant_observe.launches += 1
    return y, mask, qparams


fake_quant_observe.launches = 0


class ObservedFakeQuant(torch.autograd.Function):
    """Autograd op of one per-tensor site: the kernel forward, STE backward.

    The observer (an object with ``min_val``/``max_val`` buffers) goes in as
    a plain argument, so autograd does not track its in-place update.
    """

    @staticmethod
    def forward(ctx, x, observer, spec, observe):
        y, mask, _ = fake_quant_observe(x.detach(), observer.min_val, observer.max_val,
                                        spec, observe)
        ctx.save_for_backward(mask)
        return y

    @staticmethod
    def backward(ctx, g):
        (mask,) = ctx.saved_tensors
        return ste_backward(mask, g), None, None, None
