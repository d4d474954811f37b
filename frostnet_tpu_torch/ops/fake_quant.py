"""Observe and fake-quantize a per-tensor QAT site (CUDA kernel ``csrc/fake_quant.cu``).

Replaces the Pallas TPU kernel ``frostnet_tpu/ops/pallas_fake_quant.py::
_fq_observe_fwd`` (with its custom VJP ``fake_quant_observe``). The port
runs it at every per-tensor site of a QAT forward (``nn/quant_ops.py``
``observed_fake_quant``), where it computes what the JAX train step
computes there through ``apply_observer``::

    state    <- update_observer(state, x)          (in place; QAT only)
    scale,zp  = calculate_qparams_traced(state)
    y, mask   = fake_quantize(x, scale, zp)         (y in x's dtype)

An observing call is one launch, counted in ``fake_quant_observe.launches``.
On the detection path (300x300) a QAT step of the SSDLite-MobileNetV2
feature net observes 127 sites (the largest its 150x150x96 expand
outputs), Tiny-DSOD's 185; the float head has none.
:func:`plan_fake_quant` picks its shape per site: one thread-block cluster
holding all of x in registers (small sites), or a cooperative grid of one
CUDA block an SM, whose shared memory holds as much of x as fits while the
blocks stream the rest (the kernel's note says why). QAT_FROZEN
(``observe=False``) is one quantize launch on the frozen state. No launch
waits for the host, and none allocates: the grid shape's partials and
generation live in a per-device scratch, which the launches of one stream
share (keep the QAT step on one stream). The backward is
``where(mask, g, 0)``, a torch op, as the TPU kernel's VJP is plain JAX.

:func:`fake_quant_observe_plain` is the same function in torch ops
(``quant.observer`` and ``quant.fake_quant``); the wrapper runs it for CPU
tensors only and launches the kernel (or raises) for CUDA tensors.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Tuple

import torch

from ..quant.fake_quant import fake_quant_forward, ste_backward
from ..quant.observer import (ObserverState, calculate_qparams_traced, qparams_range_factor,
                              update_observer)
from ..quant.qtypes import SCALE_EPS, QSpec
from . import cuda_build
from .frost_block import sm_count

VECTOR_BYTES = 16  # the kernel's loads, bulk copies and stores
RESIDENT_BYTES = 208 * 1024  # x a CUDA block keeps in shared memory at most (kResidentBytes)
TILE_VECTORS = 4 * 1024  # vectors of a streamed tile (kTile)
SLOT_BYTES = 128  # a CUDA block's slot in the grid shape's exchange (kSlotWords x 8)
MAX_CLUSTER = 16  # CUDA blocks of the cluster shape at most (a non-portable size)
# x a CUDA block of the cluster shape holds at most (in registers, 4 vectors
# a thread): one H100 SM moves a few tens of GB/s, so sites beyond
# MAX_CLUSTER of these take all SMs in the grid shape
RANK_BYTES = 16 * 1024
CLUSTER_BYTES = MAX_CLUSTER * RANK_BYTES
QUANTIZE_BLOCKS = 132 * 16  # grid cap of the QAT_FROZEN quantize launch

_SCRATCH: Dict[torch.device, torch.Tensor] = {}


@dataclasses.dataclass(frozen=True)
class FakeQuantPlan:
    """One observing launch over ``blocks`` CUDA blocks. Of the ``nv``
    16-byte vectors of x (0 where x is not 16-byte aligned), block ``b``
    holds ``[b * res, (b + 1) * res)`` on chip; the rest,
    ``[blocks * res, nv)``, is streamed in tiles of ``TILE_VECTORS``, tile
    ``k`` by block ``k % blocks``. Block ``b`` also owns the elements
    ``[nv * vec + b * schunk, nv * vec + (b + 1) * schunk)`` of the scalar
    range ``[nv * vec, n)`` (all of x where it is not aligned, else the
    ragged tail). Each range is cut at its end."""

    cluster: bool  # (a) one cluster of ``blocks``; else (b) a cooperative grid
    blocks: int
    n: int
    vec: int  # elements a vector
    nv: int
    res: int
    schunk: int

    @property
    def smem(self) -> int:
        """Dynamic shared memory of a CUDA block: the grid shape's resident
        vectors (the cluster shape holds its vectors in registers)."""
        return 0 if self.cluster else self.res * VECTOR_BYTES

    def ranges(self, b: int):
        """CUDA block ``b``'s resident vector range, its streamed tiles (vector
        ranges) and its scalar element range, each range a (start, stop) pair."""
        v0 = min(self.nv, b * self.res)
        step = self.blocks * TILE_VECTORS
        tiles = [(t, min(self.nv, t + TILE_VECTORS)) for t in
                 range(min(self.nv, self.blocks * self.res) + b * TILE_VECTORS, self.nv, step)]
        e0 = min(self.n, self.nv * self.vec + b * self.schunk)
        return (v0, min(self.nv, v0 + self.res)), tiles, (e0, min(self.n, e0 + self.schunk))


@functools.lru_cache(maxsize=None)
def plan_fake_quant(n: int, itemsize: int, aligned: bool, sms: int) -> FakeQuantPlan:
    """The launch of an observing site of ``n`` elements of ``itemsize``
    bytes (x 16-byte ``aligned`` or not) on a card of ``sms`` SMs: for x up
    to ``CLUSTER_BYTES``, the cluster shape (the fewest CUDA blocks, a power
    of two, that hold ``RANK_BYTES`` of x each), else a grid of one CUDA
    block an SM. Either way x is spread evenly over the blocks as far as it
    fits on chip (the grid's shared memory, the cluster's registers)."""
    if n < 1 or itemsize not in (2, 4) or sms < 1:
        raise ValueError(f"no fake-quant plan for n={n}, itemsize={itemsize}, sms={sms}")
    vec = VECTOR_BYTES // itemsize
    nv = n // vec if aligned else 0
    cluster = n * itemsize <= CLUSTER_BYTES
    if cluster:
        blocks = 1
        while blocks * RANK_BYTES < n * itemsize:
            blocks *= 2
    else:
        blocks = sms
    return FakeQuantPlan(cluster=cluster, blocks=blocks, n=n, vec=vec, nv=nv,
                         res=min(-(-nv // blocks), RESIDENT_BYTES // VECTOR_BYTES),
                         schunk=-(-(n - nv * vec) // blocks))


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
    if lib.frost_fq_observe.argtypes is None:
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        layout = (lib.frost_fq_resident_bytes, lib.frost_fq_tile_vectors, lib.frost_fq_slot_bytes)
        for fn in layout:
            fn.argtypes, fn.restype = [], i
        if tuple(fn() for fn in layout) != (RESIDENT_BYTES, TILE_VECTORS, SLOT_BYTES):
            raise RuntimeError("RESIDENT_BYTES, TILE_VECTORS or SLOT_BYTES differ from "
                               "csrc/fake_quant.cu")
        lib.frost_fq_observe.argtypes = [p, p, p, i, ll, ll, ll, i, i, i, i, p, p, p, p, p,
                                         f, i, f, f, f, f, f, i, p]
        lib.frost_fq_observe.restype = i
        lib.frost_fq_occupancy.argtypes = [i, i, i, i, ctypes.POINTER(i)]
        lib.frost_fq_occupancy.restype = i
        lib.frost_fq_quantize.argtypes = [p, p, p, i, ll, i, p, p, f, f, f, f, f, i, i, p]
        lib.frost_fq_quantize.restype = i
        lib.frost_fq_error_string.argtypes = [i]
        lib.frost_fq_error_string.restype = ctypes.c_char_p
    return lib


def _scratch(device: torch.device, sms: int) -> Tuple[int, int]:
    """Addresses of the grid shape's per-device slots (``SLOT_BYTES`` a CUDA
    block: partial min and max tagged with the launch's generation) and
    generation word, zeroed once; the kernel needs no reset between
    launches."""
    buf = _SCRATCH.get(device)
    if buf is None:
        buf = _SCRATCH[device] = torch.zeros((sms + 1) * SLOT_BYTES // 4, dtype=torch.int32,
                                             device=device)
    return buf.data_ptr(), buf.data_ptr() + sms * SLOT_BYTES


@functools.lru_cache(maxsize=None)
def _check_fits(cluster: bool, blocks: int, smem: int, is_bf16: int, device_index: int) -> None:
    """Raise unless the card can hold a planned launch at once: its cluster
    (``cudaOccupancyMaxActiveClusters``) or all CUDA blocks of its grid
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` x SMs)."""
    lib = _bind()
    count = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = lib.frost_fq_occupancy(is_bf16, int(cluster), blocks, smem, ctypes.byref(count))
        cuda_build.check(err, lib.frost_fq_error_string, "fake_quant_observe occupancy")
        held = count.value if cluster else count.value * sm_count(device_index)
        if held < (1 if cluster else blocks):
            raise RuntimeError(
                f"fake_quant_observe: a {'cluster' if cluster else 'cooperative grid'} of "
                f"{blocks} CUDA blocks with {smem} bytes of shared memory each cannot be "
                f"held at once on {torch.cuda.get_device_name(device_index)}")


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
    ``qparams`` is a (2,) float32 tensor (scale, zero point) of the new
    state, None when ``observe`` is False. CPU tensors take the plain
    version; a CUDA tensor launches the kernel (or raises).
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
    aligned = x.data_ptr() % VECTOR_BYTES == 0
    is_bf16 = int(x.dtype == torch.bfloat16)
    grid = _grid_args(spec)
    lib = _bind()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    y = torch.empty_like(x)
    mask = torch.empty(x.shape, dtype=torch.bool, device=x.device)
    if not observe:
        err = lib.frost_fq_quantize(
            x.data_ptr(), y.data_ptr(), mask.data_ptr(), is_bf16, n, int(aligned),
            min_val.data_ptr(), max_val.data_ptr(), *grid, QUANTIZE_BLOCKS, stream)
        cuda_build.check(err, lib.frost_fq_error_string, "fake_quant_observe (QAT_FROZEN)")
        fake_quant_observe.launches += 1
        return y, mask, None
    index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    sms = sm_count(index)
    plan = plan_fake_quant(n, x.element_size(), aligned, sms)
    _check_fits(plan.cluster, plan.blocks, plan.smem, is_bf16, index)
    slots, gen = _scratch(x.device, sms)
    qparams = torch.empty(2, dtype=torch.float32, device=x.device)
    c = spec.averaging_constant
    err = lib.frost_fq_observe(
        x.data_ptr(), y.data_ptr(), mask.data_ptr(), is_bf16, n, plan.nv, plan.schunk,
        plan.res, int(plan.cluster), plan.blocks, plan.smem, min_val.data_ptr(),
        max_val.data_ptr(), qparams.data_ptr(), slots, gen,
        0.0 if c is None else float(c), int(c is not None), *grid, stream)
    cuda_build.check(err, lib.frost_fq_error_string, "fake_quant_observe")
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
