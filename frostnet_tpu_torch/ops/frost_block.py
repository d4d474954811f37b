"""One fused INT8 Frost block (CUDA kernel ``csrc/frost_block.cu``).

Replaces the Pallas TPU kernel ``frostnet_tpu/ops/pallas_frost_block.py::
frost_block_int8``. The frozen INT8 Frost block (``models/frostnet.py``
CascadePreExBottleneck) is

    squeeze 1x1 -> QCat -> expand 1x1 -> depthwise kxk -> reduce 1x1 [-> QAdd]

and the kernel runs it in one launch per block, bit-identical to the unfused
path of the frozen graph (``ops/requant.py`` says what that is). Its plain
version, :func:`frost_block_int8_plain`, is the port of
``reference_frost_block_int8``: the op-by-op composition.

The TPU kernel's batch tile (``pick_batch_tile``, a VMEM gate) has no
counterpart: the CUDA kernel tiles the output spatially and splits the
expanded width across a thread-block cluster, planned per batch size for the
card's SM count (:func:`plan_launch`); it takes every block shape of the
registered FrostNets, and a shape it cannot take raises.

:func:`frost_block_int8` calls the ``torch.library`` op
``frostnet::frost_block_int8`` where ``torch.export`` traces it
(``quant/serialize.py``); called eagerly, it goes to the same launch without
the dispatcher. The op takes the spec and the operands as lists of tensors,
ints and floats, each named (:func:`op_args`). Its CUDA implementation plans
the launch per batch size and packs the weights on the host at the first
call at that batch, as the wrapper does, and keeps them by the reduce
weight's tensor (a constant of the loaded program, the same object at every
call), weakly: they go with the program. Its CPU implementation is
:func:`frost_block_int8_plain`, for CPU tensors only.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from ..utils.profiling import span
from . import cuda_build
from .int8_matmul import MatmulOperands, conv1x1_operands, int8_matmul_requant_plain
from .requant import (depthwise_acc, epilogue_constants, qadd_codes, reciprocal,
                      requant_codes, requant_epilogue)

SMEM_LIMIT = 232448  # shared memory one CUDA block may use on an H100 (227 KB)
SMEM_TWO_PER_SM = 115712  # two CUDA blocks an SM (228 KB, 1 KB of it reserved a block)
WHOLE_MAP = 14      # input maps up to WHOLE_MAP x WHOLE_MAP are one output tile
TILE = 8            # output tile edge of larger maps
E_UNIT = 16         # the expanded width is split across a cluster in units of 16 channels
E_CHUNK = 128       # expanded channels staged in shared memory at a time
MAX_CLUSTER = 16    # CUDA blocks in a cluster (above 8: a non-portable size)
MIN_SLICE = 32      # expanded channels a rank keeps at least


@dataclasses.dataclass(frozen=True)
class FrostBlockSpec:
    """Static shape/variant config of one fused block."""

    h: int
    w: int
    cin: int
    cout: int
    kernel: int            # depthwise kernel size (3 or 5)
    stride: int            # 1 or 2
    has_squeeze: bool      # CAS variant (squeeze + cat)
    has_expand: bool       # expand_ratio > 1
    c_sq: int              # squeeze channels (0 when not has_squeeze)
    c_e: int               # depthwise width (expanded channels)
    residual: bool
    act_qmax: int = 255    # activation grid max: 255 qnnpack, 127 fbgemm

    @property
    def pad(self) -> int:
        return (self.kernel - 1) // 2

    @property
    def out_hw(self) -> Tuple[int, int]:
        k, s, p = self.kernel, self.stride, self.pad
        return ((self.h + 2 * p - k) // s + 1, (self.w + 2 * p - k) // s + 1)


@dataclasses.dataclass
class FrostBlockParams:
    """Frozen operands of one block, on one device (see :func:`build_params`)."""

    x_scale: float
    x_zp: int
    sq: Optional[MatmulOperands]
    cat_sq_s: float          # squeeze half onto the cat grid: (q - z) * s * mult
    cat_sq_mult: float
    cat_x_s: float           # input half onto the cat grid
    cat_x_mult: float
    cat_zp: int
    ex: Optional[MatmulOperands]
    dw_w: torch.Tensor       # (k*k, E) int8 taps, (dy, dx) order
    dw_zt: torch.Tensor      # (E,) int32: -dw_in_zp * sum of each channel's taps
    dw_scale: torch.Tensor   # (E,) f32
    dw_bias: torch.Tensor    # (E,) f32
    dw_mult: float
    dw_in_zp: int
    dw_zp: int
    rd: MatmulOperands
    rd_s: float              # reduce output scale (the residual's second operand)
    add_mult: float
    add_zp: int
    # batch size -> the planned launch (:func:`prepare_launch`), filled on the
    # first CUDA call at that batch; the packed weights those launches point
    # to, one copy per ``LaunchPlan.pack_key``; neither copied by
    # dataclasses.replace
    launches: Dict[int, "Launch"] = dataclasses.field(default_factory=dict, init=False,
                                                      repr=False, compare=False)
    packed: Dict[tuple, torch.Tensor] = dataclasses.field(default_factory=dict, init=False,
                                                          repr=False, compare=False)


def build_params(spec: FrostBlockSpec, *, x_scale, x_zp, sq=None, cat=None,
                 ex=None, dw=None, rd=None, add=None, device="cpu") -> FrostBlockParams:
    """Pack HWIO int8 weights and qparams into the block's frozen operands.

    Each conv is ``(qw, comb, bias, out_scale, out_zp)``: ``comb`` is the
    input scale times the weight scale (0-dim when per-tensor), ``bias`` the
    folded float bias. ``cat`` and ``add`` are ``(scale, zero_point)``.
    """
    qmax = spec.act_qmax

    def f(v) -> float:
        return float(torch.as_tensor(v, dtype=torch.float32))

    def i(v) -> int:
        return int(torch.as_tensor(v))

    def t(v) -> torch.Tensor:
        return torch.as_tensor(v)

    x_zp = i(x_zp)
    sq_ops = ex_ops = None
    cat_sq_s = cat_sq_mult = cat_x_s = cat_x_mult = 1.0
    cat_zp = 0
    e_zp = x_zp
    if spec.has_squeeze:
        qw, comb, bias, os_, oz = sq
        sq_ops = conv1x1_operands(t(qw).reshape(spec.cin, spec.c_sq), t(comb), t(bias),
                                  x_zp, os_, oz, True, 0, qmax, device)
        inv_cat = reciprocal(cat[0])
        cat_sq_s, cat_sq_mult = f(os_), inv_cat
        cat_x_s, cat_x_mult = f(x_scale), inv_cat
        cat_zp = e_zp = i(cat[1])
    if spec.has_expand:
        qw, comb, bias, os_, oz = ex
        k_in = spec.c_sq + spec.cin if spec.has_squeeze else spec.cin
        ex_ops = conv1x1_operands(t(qw).reshape(k_in, spec.c_e), t(comb), t(bias),
                                  e_zp, os_, oz, True, 0, qmax, device)
        e_zp = i(oz)
    qw, comb, bias, os_, oz = dw
    dw_w = t(qw).to(torch.int8).reshape(spec.kernel ** 2, spec.c_e)
    dw_scale, dw_bias, dw_mult = epilogue_constants(t(comb), t(bias), os_, True)
    dw_zp = i(oz)
    qw, comb, bias, os_, oz = rd
    rd_ops = conv1x1_operands(t(qw).reshape(spec.c_e, spec.cout), t(comb), t(bias),
                              dw_zp, os_, oz, False, 0, qmax, device)
    return FrostBlockParams(
        x_scale=f(x_scale), x_zp=x_zp, sq=sq_ops,
        cat_sq_s=cat_sq_s, cat_sq_mult=cat_sq_mult, cat_x_s=cat_x_s,
        cat_x_mult=cat_x_mult, cat_zp=cat_zp, ex=ex_ops,
        dw_w=dw_w.to(device), dw_zt=(-e_zp * dw_w.to(torch.int32).sum(dim=0)).to(torch.int32).to(device),
        dw_scale=dw_scale.to(device), dw_bias=dw_bias.to(device), dw_mult=dw_mult,
        dw_in_zp=e_zp, dw_zp=dw_zp, rd=rd_ops, rd_s=f(os_),
        add_mult=reciprocal(add[0]) if spec.residual else 1.0,
        add_zp=i(add[1]) if spec.residual else 0)


def frost_block_int8_plain(x: torch.Tensor, p: FrostBlockParams,
                           spec: FrostBlockSpec) -> torch.Tensor:
    """The block op by op in torch: (B, H, W, Cin) uint8 -> (B, Ho, Wo, Cout)."""
    qmax = spec.act_qmax

    def conv1x1(a, op):
        out = int8_matmul_requant_plain(a.reshape(-1, a.shape[-1]), op)
        return out.reshape(a.shape[:3] + (op.n,))

    h = x
    if spec.has_expand:
        if spec.has_squeeze:
            q_s = conv1x1(x, p.sq)
            h = torch.cat([
                requant_codes(q_s, p.sq.out_zp, p.cat_sq_s, p.cat_sq_mult, p.cat_zp, 0, qmax),
                requant_codes(x, p.x_zp, p.cat_x_s, p.cat_x_mult, p.cat_zp, 0, qmax),
            ], dim=-1)
        h = conv1x1(h, p.ex)
    acc = depthwise_acc(h, p.dw_w, spec.kernel, spec.stride, p.dw_in_zp)
    q_d = requant_epilogue(acc, p.dw_scale, p.dw_bias, p.dw_mult, p.dw_zp, True, 0, qmax)
    q_r = conv1x1(q_d, p.rd)
    if spec.residual:
        q_r = qadd_codes(x, p.x_zp, p.x_scale, q_r, p.rd.out_zp, p.rd_s,
                         p.add_mult, p.add_zp, 0, qmax)
    return q_r


def _random_conv(rng, cin, cout, k=1, qmax=255):
    """Random calibrated conv operands on realistic scale magnitudes."""
    qw = rng.randint(-127, 128, (k, k, cin if k == 1 else 1, cout), np.int8)
    scale = rng.rand(cout).astype(np.float32) * 1e-3 + 1e-4
    bias = rng.randn(cout).astype(np.float32) * 0.05
    out_s = np.float32(rng.rand() * 0.05 + 0.01)
    out_zp = np.int32(rng.randint(0, qmax))
    return (torch.as_tensor(qw), torch.as_tensor(scale), torch.as_tensor(bias),
            out_s, out_zp)


def random_block_case(spec: FrostBlockSpec, batch: int, seed: int = 0, device="cpu"):
    """(x, params) with random weights and qparams for ``spec``.

    Draws the numbers of ``frostnet_tpu.ops.pallas_frost_block.
    random_block_case`` in the same order, so one seed gives both packages
    the same block.
    """
    rng = np.random.RandomState(seed)
    qmax = spec.act_qmax
    x = torch.as_tensor(rng.randint(0, qmax + 1, (batch, spec.h, spec.w, spec.cin), np.uint8))
    c_cat = spec.c_sq + spec.cin if spec.has_squeeze else spec.cin
    params = build_params(
        spec,
        x_scale=np.float32(0.02), x_zp=np.int32(114 if qmax > 127 else 60),
        sq=(_random_conv(rng, spec.cin, spec.c_sq, qmax=qmax)
            if spec.has_squeeze else None),
        cat=((np.float32(0.018), np.int32(min(120, qmax - 7)))
             if spec.has_squeeze else None),
        ex=(_random_conv(rng, c_cat, spec.c_e, qmax=qmax)
            if spec.has_expand else None),
        dw=_random_conv(rng, 1, spec.c_e, k=spec.kernel, qmax=qmax),
        rd=_random_conv(rng, spec.c_e, spec.cout, qmax=qmax),
        add=((np.float32(0.03), np.int32(100)) if spec.residual else None),
        device=device,
    )
    return x.to(device), params


# ---------------------------------------------------------------------------
# CUDA launch
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class FrostBlockArgs(ctypes.Structure):
    """Mirror of ``struct FrostBlockArgs`` in ``csrc/frost_block.cu``."""

    _fields_ = (
        [("x", _P), ("out", _P), ("head", _P), ("stages", _P)]
        + [(n, _I) for n in ("B", "H", "W", "Cin", "Cout", "Ho", "Wo", "E", "Ccat", "Csq",
                             "has_squeeze", "has_expand", "residual",
                             "threads", "cluster", "tile_h", "tile_w", "halo_h", "halo_w",
                             "tiles_w",
                             "e_unit", "e_units", "e_chunk", "max_chunks",
                             "ld_x", "ld_sq", "ld_cat", "ld_e", "ld_d", "ld_ex", "ld_rd", "ld_dw",
                             "n_cols", "off_acc", "off_rdc", "off_cat", "off_sqc", "head_bytes",
                             "off_e", "off_d", "off_w", "w_stage", "off_cx", "off_slot",
                             "chunk_bytes", "first_bytes", "rd_bytes", "off_tab", "off_bar")]
        + [(n, _F) for n in ("qmax", "x_zp", "x_scale", "sq_mult", "sq_zp", "cat_sq_s",
                             "cat_sq_mult", "cat_x_s", "cat_x_mult", "cat_zp", "ex_mult", "ex_zp")]
        + [("dw_in_zp", _I)]
        + [(n, _F) for n in ("dw_mult", "dw_zp", "rd_mult", "rd_zp", "rd_s", "add_mult",
                             "add_zp")]
    )


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """Threads, cluster, output tile, expanded-width chunk and shared-memory
    layout of one launch at one batch size.

    A cluster of ``cluster`` CUDA blocks takes one (image, output tile); rank
    r owns the expanded channels of units ``[r U / C, (r + 1) U / C)`` (units
    of ``E_UNIT`` channels, U = ``e_units``), walked ``e_chunk`` at a time
    (at most ``max_chunks``), and output columns ``[r n_cols, (r + 1) n_cols)``
    (``n_cols`` a multiple of 4; past Cout, fewer or none).
    ``stages`` weight stages of ``w_stage`` bytes (two when a slice has more
    than one chunk). Offsets and strides are in bytes; ``csrc/frost_block.cu``
    says what each section holds.
    """

    batch: int
    threads: int
    cluster: int
    tile_h: int
    tile_w: int
    halo_h: int
    halo_w: int
    tiles_h: int
    tiles_w: int
    e_unit: int
    e_units: int
    e_chunk: int
    max_chunks: int
    stages: int
    ld_x: int
    ld_sq: int
    ld_cat: int
    ld_e: int
    ld_d: int
    ld_ex: int
    ld_rd: int
    ld_dw: int
    n_cols: int
    off_acc: int
    off_rdc: int
    off_cat: int
    off_sqc: int
    head_bytes: int
    off_e: int
    off_d: int
    off_w: int
    w_stage: int
    off_cx: int
    off_slot: int
    chunk_bytes: int
    first_bytes: int
    rd_bytes: int
    off_tab: int
    off_bar: int
    smem: int

    @property
    def grid(self) -> Tuple[int, int]:
        return self.tiles_h * self.tiles_w * self.cluster, self.batch

    @property
    def pack_key(self) -> Tuple[int, int]:
        """The fields :func:`pack_stages` depends on besides the spec (the
        head depends on the spec alone): plans of one block that agree on
        them share one packed copy of the weights."""
        return self.cluster, self.e_chunk

    def e_slices(self, e: int):
        """``[(lo, hi)]`` expanded channels of each rank of a cluster."""
        u, c = self.e_units, self.cluster
        return [((r * u // c) * E_UNIT, min(e, ((r + 1) * u // c) * E_UNIT)) for r in range(c)]

    def cout_slices(self, cout: int):
        """``[(lo, hi)]`` output columns each rank finishes."""
        return [(min(cout, r * self.n_cols), min(cout, (r + 1) * self.n_cols))
                for r in range(self.cluster)]


def _row_stride(nbytes: int) -> int:
    """Shared-memory row stride of an ldmatrix operand: an odd number of
    16-byte units, so eight consecutive rows fall in eight bank groups."""
    units = max(1, -(-nbytes // 16))
    return 16 * (units + 1 - units % 2)


def _pad32(n: int) -> int:
    return -(-n // 32) * 32


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def _layout(spec: FrostBlockSpec, batch: int, sms: int, cluster: int, th: int, tw: int,
            ec: int) -> LaunchPlan:
    ho, wo = spec.out_hw
    hh = (th - 1) * spec.stride + spec.kernel
    hw = (tw - 1) * spec.stride + spec.kernel
    hp, tp = hh * hw, th * tw
    ccat = spec.c_sq + spec.cin if spec.has_squeeze else spec.cin
    n_in = min(hh, spec.h) * min(hw, spec.w)  # in-image halo rows of a tile, at most
    units = -(-spec.c_e // E_UNIT)
    max_chunks = -(-(-(-units // cluster) * E_UNIT) // ec)
    stages = 1 if max_chunks == 1 else 2
    ld_x = _row_stride(_pad32(spec.cin))
    ld_sq = _row_stride(_pad32(spec.cin)) if spec.has_squeeze else 0
    ld_cat = _row_stride(_pad32(ccat)) if spec.has_squeeze else 0
    ld_e = _align16(ec) if spec.has_expand else 0
    ld_d = ld_rd = _row_stride(_pad32(ec))
    ld_ex = _row_stride(_pad32(ccat)) if spec.has_expand else 0
    ld_dw = _align16(ec)
    # the reduce partial, [rank finishing the columns][pixel][n_cols] int32
    n_cols = -(-spec.cout // 4 // cluster) * 4
    x_bytes, part_bytes = _align16(hp * ld_x), cluster * tp * n_cols * 4
    # with a squeeze, the input halo is dead once the cat is built: the
    # reduce partial takes its place (the residual reads x from device memory)
    off_acc = 0 if spec.has_squeeze else x_bytes
    off_rdc = max(x_bytes, part_bytes) if spec.has_squeeze else x_bytes + part_bytes
    off_cat = off_rdc + 12 * spec.cout  # the head's reduce constants before it
    # the head's squeeze constants, then the squeeze weights, which are dead
    # before the expanded chunk and the depthwise output are first written
    off_sqc = off_cat + _align16(n_in * ld_cat)
    off_e = off_sqc + 12 * spec.c_sq
    head_bytes = 12 * (spec.cout + spec.c_sq) + spec.c_sq * ld_sq
    off_d = off_e + _align16(hp * ld_e)
    off_w = max(off_d + _align16(tp * ld_d), off_e + _align16(spec.c_sq * ld_sq))
    # a stage: the taps, the expand's and the depthwise's epilogue constants,
    # a slot for the expand weights and then the reduce weights
    off_cx = _align16(spec.kernel ** 2 * ld_dw)
    off_slot = off_cx + 24 * ec
    first_bytes, rd_bytes = off_slot + ec * ld_ex, spec.cout * ld_rd
    w_stage = off_slot + max(ec * ld_ex, rd_bytes)
    # two 256-byte lookup tables, an int32 per column, a uint16 per in-image
    # row; before them, from off_cat, room for the peers' partials of this
    # rank's columns
    off_tab = max(off_w + stages * w_stage, off_cat + part_bytes)
    off_bar = off_tab + _align16(512 + 4 * spec.cout + 2 * n_in)  # six mbarriers
    threads = 512 if batch * -(-ho // th) * -(-wo // tw) * cluster <= sms else 256
    return LaunchPlan(batch, threads, cluster, th, tw, hh, hw, -(-ho // th), -(-wo // tw), E_UNIT, units, ec,
                      max_chunks, stages, ld_x, ld_sq, ld_cat, ld_e, ld_d, ld_ex, ld_rd, ld_dw,
                      n_cols, off_acc, off_rdc, off_cat, off_sqc, head_bytes, off_e, off_d,
                      off_w, w_stage, off_cx, off_slot, first_bytes + rd_bytes, first_bytes,
                      rd_bytes, off_tab, off_bar, off_bar + 48)


def plan_launch(spec: FrostBlockSpec, batch: int, sms: int) -> LaunchPlan:
    """The launch of ``spec`` at ``batch`` on a card with ``sms`` SMs.

    Maps of ``WHOLE_MAP`` x ``WHOLE_MAP`` and smaller are one tile (no halo
    recomputed between tiles), larger ones ``TILE`` x ``TILE`` tiles. The
    cluster is the smallest of 1, 2, 4, 8, 16 that gives at least one CUDA
    block per SM, as long as each rank keeps ``MIN_SLICE`` channels of the
    expanded width (in ``E_UNIT`` units: 16 channels balance the ranks
    better than 32), and a cluster of 16 only where two CUDA blocks share an
    SM. The chunk is the largest of the rank's slice (up to ``E_CHUNK``
    channels) cut by ``E_UNIT`` that fits shared memory; where the grid has
    more CUDA blocks than SMs, the largest that lets two share an SM, if
    one does. If none fits, the tile is halved. A grid of at most one CUDA block an SM runs 512
    threads a CUDA block (more warps to hide latency), a larger one 256. A
    shape that does not fit raises.
    """
    for name, v in (("cin", spec.cin), ("cout", spec.cout), ("c_sq", spec.c_sq),
                    ("c_e", spec.c_e)):
        if v % 8:
            raise ValueError(f"frost_block_int8 takes channel counts divisible by 8; {name}={v}")
    if spec.kernel not in (3, 5) or spec.stride not in (1, 2):
        raise ValueError(f"frost_block_int8 takes k 3|5, stride 1|2; got {spec}")
    if spec.residual and (spec.stride != 1 or spec.cin != spec.cout):
        raise ValueError(f"residual block must keep its shape: {spec}")
    if spec.has_squeeze and not spec.has_expand:
        raise ValueError(f"a squeeze without an expand is not a Frost block: {spec}")
    if not 1 <= batch <= 65535:
        raise ValueError(f"batch {batch} outside the kernel's grid (1-65535)")
    ho, wo = spec.out_hw
    whole = spec.h <= WHOLE_MAP and spec.w <= WHOLE_MAP
    th, tw = (ho, wo) if whole else (min(TILE, ho), min(TILE, wo))
    while True:
        groups = batch * -(-ho // th) * -(-wo // tw)
        cluster = 1
        while (cluster < MAX_CLUSTER and groups * cluster < sms
               and spec.c_e >= 2 * cluster * MIN_SLICE):
            cluster *= 2
        plan = _fit(spec, batch, sms, cluster, th, tw,
                    two_per_sm=groups * cluster > sms or cluster == MAX_CLUSTER)
        if cluster == MAX_CLUSTER and (plan is None or plan.smem > SMEM_TWO_PER_SM):
            # a cluster of 16 with one CUDA block an SM: an H100 holds only 7
            # of them at once (cudaOccupancyMaxActiveClusters); 8 do better
            plan = _fit(spec, batch, sms, cluster // 2, th, tw, two_per_sm=False)
        if plan is not None:
            return plan
        if max(th, tw) == 1:
            raise ValueError(f"no tile of {spec} fits {SMEM_LIMIT} bytes of shared memory")
        th, tw = -(-th // 2), -(-tw // 2)


def _fit(spec, batch, sms, cluster, th, tw, two_per_sm) -> Optional[LaunchPlan]:
    """The layout with the largest chunk that fits shared memory, or, with
    ``two_per_sm``, that lets two CUDA blocks share an SM if one does; None
    if none fits."""
    units = -(-spec.c_e // E_UNIT)
    slice_ = -(-units // cluster) * E_UNIT
    plans = [_layout(spec, batch, sms, cluster, th, tw, ec)
             for ec in range(min(slice_, E_CHUNK), 0, -E_UNIT)]
    for limit in ((SMEM_TWO_PER_SM,) if two_per_sm else ()) + (SMEM_LIMIT,):
        for plan in plans:
            if plan.smem <= limit:
                return plan
    return None


def _bytes(*tensors) -> torch.Tensor:
    """The tensors' bytes, one after another (uint8, on the CPU)."""
    return torch.cat([t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
                      for t in tensors])


def pack_head(spec: FrostBlockSpec, p: FrostBlockParams, plan: LaunchPlan) -> torch.Tensor:
    """The head the kernel bulk-copies to shared memory: the reduce's and the
    squeeze's epilogue constants (zero-point term, scale, bias), then the
    squeeze weights [Csq][ld_sq] (Cin padded to 32 with zeros)."""
    head = torch.zeros(plan.head_bytes, dtype=torch.uint8)
    consts = _bytes(p.rd.zterm, p.rd.scale, p.rd.bias,
                    *((p.sq.zterm, p.sq.scale, p.sq.bias) if spec.has_squeeze else ()))
    head[:consts.numel()] = consts
    if spec.has_squeeze:
        k = _pad32(spec.cin)
        rows = head[consts.numel():].view(spec.c_sq, plan.ld_sq)
        rows[:, :k] = _bytes(p.sq.wt).view(spec.c_sq, -1)[:, :k]
    return head.to(p.rd.wt.device)


def pack_stages(spec: FrostBlockSpec, p: FrostBlockParams, plan: LaunchPlan) -> torch.Tensor:
    """The weights the kernel bulk-copies to shared memory, one block of
    ``chunk_bytes`` per (rank, chunk) at ``(rank * max_chunks + chunk) *
    chunk_bytes``: the depthwise taps, the expand's and the depthwise's
    epilogue constants and the expand weights (``first_bytes``), then the
    reduce's columns of the chunk, in the layout of ``csrc/frost_block.cu``.
    Zero past E and past each row's K."""
    ec_max, k2 = plan.e_chunk, spec.kernel ** 2
    ccat = spec.c_sq + spec.cin if spec.has_squeeze else spec.cin
    blob = torch.zeros((plan.cluster * plan.max_chunks, plan.chunk_bytes), dtype=torch.uint8)
    ex_w = _bytes(p.ex.wt).view(spec.c_e, -1) if spec.has_expand else None
    rd_w = _bytes(p.rd.wt).view(spec.cout, -1)
    dw_w = _bytes(p.dw_w).view(k2, spec.c_e)
    ex_c = [t.cpu() for t in (p.ex.zterm, p.ex.scale, p.ex.bias)] if spec.has_expand else None
    dw_c = [t.cpu() for t in (p.dw_zt, p.dw_scale, p.dw_bias)]
    for r, (lo, hi) in enumerate(plan.e_slices(spec.c_e)):
        for j, c0 in enumerate(range(lo, hi, ec_max)):
            ec = min(ec_max, hi - c0)
            st = blob[r * plan.max_chunks + j]
            st[:k2 * plan.ld_dw].view(k2, plan.ld_dw)[:, :ec] = dw_w[:, c0:c0 + ec]
            for base, consts in ((plan.off_cx, ex_c), (plan.off_cx + 12 * ec_max, dw_c)):
                for i, v in enumerate(consts or ()):
                    at = base + 4 * ec_max * i
                    st[at:at + 4 * ec] = _bytes(v[c0:c0 + ec])
            if spec.has_expand:
                k = _pad32(ccat)
                st[plan.off_slot:plan.first_bytes].view(ec_max, plan.ld_ex)[:ec, :k] = \
                    ex_w[c0:c0 + ec, :k]
            st[plan.first_bytes:].view(spec.cout, plan.ld_rd)[:, :ec] = rd_w[:, c0:c0 + ec]
    return blob.reshape(-1).to(p.rd.wt.device)


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def launch_args(spec: FrostBlockSpec, p: FrostBlockParams, plan: LaunchPlan,
                head: torch.Tensor, stages: torch.Tensor) -> FrostBlockArgs:
    """The static part of the kernel's arguments (x and out set per call);
    ``head`` and ``stages`` from :func:`pack_head` and :func:`pack_stages`."""
    ho, wo = spec.out_hw
    a = FrostBlockArgs()
    a.head, a.stages = head.data_ptr(), stages.data_ptr()
    a.B, a.H, a.W, a.Cin, a.Cout, a.Ho, a.Wo = plan.batch, spec.h, spec.w, spec.cin, spec.cout, ho, wo
    a.E, a.Csq = spec.c_e, spec.c_sq
    a.Ccat = spec.c_sq + spec.cin if spec.has_squeeze else spec.cin
    a.has_squeeze, a.has_expand, a.residual = spec.has_squeeze, spec.has_expand, spec.residual
    for name in ("threads", "cluster", "tile_h", "tile_w", "halo_h", "halo_w", "tiles_w", "e_unit", "e_units",
                 "e_chunk", "max_chunks", "ld_x", "ld_sq", "ld_cat", "ld_e", "ld_d", "ld_ex",
                 "ld_rd", "ld_dw", "n_cols", "off_acc", "off_rdc", "off_cat", "off_sqc",
                 "head_bytes", "off_e", "off_d", "off_w", "w_stage", "off_cx", "off_slot",
                 "chunk_bytes", "first_bytes", "rd_bytes", "off_tab", "off_bar"):
        setattr(a, name, getattr(plan, name))
    a.qmax = float(spec.act_qmax)
    a.x_zp, a.x_scale = float(p.x_zp), p.x_scale
    for prefix, op in (("sq", p.sq), ("ex", p.ex), ("rd", p.rd)):
        if op is not None:
            setattr(a, f"{prefix}_mult", op.out_mult)
            setattr(a, f"{prefix}_zp", float(op.out_zp))
    a.cat_sq_s, a.cat_sq_mult = p.cat_sq_s, p.cat_sq_mult
    a.cat_x_s, a.cat_x_mult, a.cat_zp = p.cat_x_s, p.cat_x_mult, float(p.cat_zp)
    a.dw_in_zp, a.dw_mult, a.dw_zp = p.dw_in_zp, p.dw_mult, float(p.dw_zp)
    a.rd_s, a.add_mult, a.add_zp = p.rd_s, p.add_mult, float(p.add_zp)
    return a


@dataclasses.dataclass
class Launch:
    """A planned launch: the plan, the kernel's static arguments and the
    packed weights they point to (kept alive here)."""

    plan: LaunchPlan
    args: FrostBlockArgs
    head: torch.Tensor
    stages: torch.Tensor


def _bind():
    lib = cuda_build.load("frost_block")
    fn = lib.frost_block_int8
    if fn.argtypes is None:
        size = lib.frost_block_args_size()
        if size != ctypes.sizeof(FrostBlockArgs):
            raise RuntimeError(f"FrostBlockArgs is {ctypes.sizeof(FrostBlockArgs)} bytes "
                               f"here, {size} in csrc/frost_block.cu")
        fn.argtypes = [ctypes.POINTER(FrostBlockArgs), _I, _I, _I, _P]
        fn.restype = _I
        lib.frost_block_max_active_clusters.argtypes = [ctypes.POINTER(FrostBlockArgs), _I, _I,
                                                        _I, ctypes.POINTER(_I)]
        lib.frost_block_max_active_clusters.restype = _I
        lib.frost_block_error_string.argtypes = [_I]
        lib.frost_block_error_string.restype = ctypes.c_char_p
    return lib


def max_active_clusters(spec: FrostBlockSpec, args: FrostBlockArgs, plan: LaunchPlan) -> int:
    """``cudaOccupancyMaxActiveClusters`` of a planned launch on the current
    device: how many of its clusters the card holds at once."""
    lib = _bind()
    n = _I(0)
    err = lib.frost_block_max_active_clusters(ctypes.byref(args), spec.kernel, spec.stride,
                                              plan.smem, ctypes.byref(n))
    cuda_build.check(err, lib.frost_block_error_string, "cudaOccupancyMaxActiveClusters")
    return n.value


def prepare_launch(spec: FrostBlockSpec, p: FrostBlockParams, batch: int,
                   device: torch.device) -> Launch:
    """Plan a launch at ``batch`` for ``device``'s SM count, pack its weights
    (once per ``plan.pack_key``, kept in ``p.packed``) and check that the card
    can schedule its cluster at all; raises if it cannot."""
    with torch.cuda.device(device):
        plan = plan_launch(spec, batch, sm_count(torch.cuda.current_device()))
        if "head" not in p.packed:
            p.packed["head"] = pack_head(spec, p, plan)
        if plan.pack_key not in p.packed:
            p.packed[plan.pack_key] = pack_stages(spec, p, plan)
        head, stages = p.packed["head"], p.packed[plan.pack_key]
        launch = Launch(plan, launch_args(spec, p, plan, head, stages), head, stages)
        if max_active_clusters(spec, launch.args, plan) < 1:
            raise RuntimeError(f"frost_block_int8: a cluster of {plan.cluster} CUDA blocks with "
                               f"{plan.smem} bytes of shared memory each cannot be scheduled "
                               f"on {torch.cuda.get_device_name()}")
    return launch


_MM_TENSORS = ("wt", "zterm", "scale", "bias")
_MM_INTS = ("k", "out_zp", "relu", "qmin", "qmax")
_MMS = ("rd", "sq", "ex")
_INTS = (tuple(f.name for f in dataclasses.fields(FrostBlockSpec))
         + ("x_zp", "cat_zp", "dw_in_zp", "dw_zp", "add_zp")
         + tuple(f"{m}.{f}" for m in _MMS for f in _MM_INTS))
_FLOATS = (("x_scale", "cat_sq_s", "cat_sq_mult", "cat_x_s", "cat_x_mult", "dw_mult", "rd_s",
            "add_mult") + tuple(f"{m}.out_mult" for m in _MMS))


def _tensor_names(has_squeeze: bool, has_expand: bool) -> Tuple[str, ...]:
    """The names of the op's tensors: the reduce's matmul operands first,
    the depthwise's, then the squeeze's and the expand's where the block
    has them."""
    mms = ["rd"] + [m for m, on in (("sq", has_squeeze), ("ex", has_expand)) if on]
    names = tuple(f"{m}.{f}" for m in mms for f in _MM_TENSORS)
    return names[:4] + ("dw_w", "dw_zt", "dw_scale", "dw_bias") + names[4:]


def op_args(spec: FrostBlockSpec, p: FrostBlockParams
            ) -> Tuple[List[torch.Tensor], List[int], List[float]]:
    """(tensors, ints, floats): the spec and the operands as the op takes
    them, in the order of :func:`_tensor_names`, ``_INTS`` and ``_FLOATS``
    (an absent matmul's scalars are 0)."""
    named = {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)}
    named.update((f.name, getattr(p, f.name)) for f in dataclasses.fields(p)
                  if f.init and f.name not in _MMS)
    for m in _MMS:
        op = getattr(p, m)
        named.update((f"{m}.{f.name}", getattr(op, f.name) if op is not None else 0)
                     for f in dataclasses.fields(MatmulOperands))
    return ([named[n] for n in _tensor_names(spec.has_squeeze, spec.has_expand)],
            [int(named[n]) for n in _INTS], [float(named[n]) for n in _FLOATS])


def _spec_of(ints) -> FrostBlockSpec:
    named = dict(zip(_INTS, ints))
    return FrostBlockSpec(**{f.name: named[f.name] for f in dataclasses.fields(FrostBlockSpec)})


def from_op_args(tensors, ints, floats) -> Tuple[FrostBlockSpec, FrostBlockParams]:
    """The inverse of :func:`op_args`."""
    spec = _spec_of(ints)
    named = {**dict(zip(_INTS, ints)), **dict(zip(_FLOATS, floats)),
             **dict(zip(_tensor_names(spec.has_squeeze, spec.has_expand), tensors))}
    mm = {m: MatmulOperands(**{f.name: named[f"{m}.{f.name}"]
                               for f in dataclasses.fields(MatmulOperands)})
          if f"{m}.wt" in named else None for m in _MMS}
    p = FrostBlockParams(**mm, **{f.name: named[f.name] for f in dataclasses.fields(
        FrostBlockParams) if f.init and f.name not in _MMS})
    return spec, p


def frost_block_int8(x: torch.Tensor, p: FrostBlockParams, spec: FrostBlockSpec) -> torch.Tensor:
    """Run one fused INT8 Frost block: (B, H, W, Cin) uint8 -> (B, Ho, Wo, Cout).

    CPU tensors take the plain version; a CUDA tensor launches the kernel
    (or raises); under ``torch.export`` the call is the op. The first call at
    a batch size does host work before its launch: it plans the launch, packs
    the weights where no earlier plan packed them alike and copies them to
    the card (:func:`prepare_launch`, kept in ``p.launches``). Make that call
    outside a CUDA graph's capture. Each launch adds one to
    ``frost_block_int8.launches``.
    """
    with span("ops.frost_block"):
        if (x.dtype != torch.uint8 or x.dim() != 4
                or tuple(x.shape[1:]) != (spec.h, spec.w, spec.cin)):
            raise ValueError(f"x must be (B, {spec.h}, {spec.w}, {spec.cin}) uint8, "
                             f"got {tuple(x.shape)} {x.dtype}")
        if x.device != p.rd.wt.device:
            raise ValueError(f"x on {x.device}, operands on {p.rd.wt.device}")
        if cuda_build.traced(x):
            return torch.ops.frostnet.frost_block_int8(x, *op_args(spec, p))
        if x.device.type == "cpu":
            return frost_block_int8_plain(x, p, spec)
        if x.device.type != "cuda":
            raise ValueError(f"unsupported device {x.device}")
        launch = p.launches.get(x.shape[0])
        if launch is None:
            launch = p.launches[x.shape[0]] = prepare_launch(spec, p, x.shape[0], x.device)
        return _launch(x, spec, launch)


frost_block_int8.launches = 0


def _launch(x: torch.Tensor, spec: FrostBlockSpec, launch: Launch) -> torch.Tensor:
    """Launch a planned kernel on the current stream; raises if the build or
    the launch fails."""
    batch = x.shape[0]
    x = x.contiguous()
    if x.data_ptr() % 16:  # the kernel reads the input in 8- and 16-byte words
        x = x.clone()
    ho, wo = spec.out_hw
    out = torch.empty((batch, ho, wo, spec.cout), dtype=torch.uint8, device=x.device)
    a = FrostBlockArgs.from_buffer_copy(launch.args)
    a.x, a.out = x.data_ptr(), out.data_ptr()
    lib = _bind()
    err = lib.frost_block_int8(ctypes.byref(a), spec.kernel, spec.stride, launch.plan.smem,
                               torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(err, lib.frost_block_error_string, "frost_block_int8")
    frost_block_int8.launches += 1
    return out


@dataclasses.dataclass
class _Plans:
    """What the op's CUDA implementation keeps of one block: its arguments'
    scalars (to tell a block apart from another that shares its reduce
    weight), its spec, its launches by batch size and their packed weights.
    Nothing here refers to the op's tensors."""

    ints: List[int]
    floats: List[float]
    spec: FrostBlockSpec
    launches: Dict[int, Launch] = dataclasses.field(default_factory=dict)
    packed: Dict[tuple, torch.Tensor] = dataclasses.field(default_factory=dict)


# reduce weight tensor -> _Plans; an entry goes with its tensor
_PLANS = WeakIdKeyDictionary()


def _op_cuda(x: torch.Tensor, tensors: List[torch.Tensor], ints: List[int],
             floats: List[float]) -> torch.Tensor:
    plans = _PLANS.get(tensors[0])
    if plans is None or plans.ints != ints or plans.floats != floats:
        plans = _PLANS[tensors[0]] = _Plans(list(ints), list(floats), _spec_of(ints))
    launch = plans.launches.get(x.shape[0])
    if launch is None:
        p = from_op_args(tensors, ints, floats)[1]
        p.packed = plans.packed
        launch = plans.launches[x.shape[0]] = prepare_launch(plans.spec, p, x.shape[0], x.device)
    return _launch(x, plans.spec, launch)


def _op_cpu(x, tensors, ints, floats):
    spec, p = from_op_args(tensors, ints, floats)
    return frost_block_int8_plain(x, p, spec)


def _op_fake(x, tensors, ints, floats):
    spec = _spec_of(ints)
    ho, wo = spec.out_hw
    return x.new_empty((x.shape[0], ho, wo, spec.cout), dtype=torch.uint8)


# The op, for torch.export. Registered on the dispatcher directly (not
# ``torch.library.custom_op``, whose Python autograd layer runs at every
# call): CUDA launches, CPU runs the plain version, the fake implementation
# gives the output's shape.
_LIB = torch.library.Library("frostnet", "FRAGMENT")
_LIB.define("frost_block_int8(Tensor x, Tensor[] tensors, int[] ints, float[] floats) -> Tensor")
_LIB.impl("frost_block_int8", _op_cpu, "CPU")
_LIB.impl("frost_block_int8", _op_cuda, "CUDA")
torch.library.register_fake("frostnet::frost_block_int8", _op_fake, lib=_LIB)
