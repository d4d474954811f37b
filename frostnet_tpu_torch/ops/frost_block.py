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
counterpart: the CUDA kernel tiles the output spatially
(:func:`plan_launch`) and takes every block shape of the model; a shape it
cannot take raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from . import cuda_build
from .int8_matmul import MatmulOperands, conv1x1_operands, int8_matmul_requant_plain
from .requant import (depthwise_acc, epilogue_constants, qadd_codes, reciprocal,
                      requant_codes, requant_epilogue)

SMEM_LIMIT = 232448  # shared memory one block may use on an H100 (227 KB)
TILE = 8            # output tile edge; the 7x7 maps take the whole map
E_CHUNK = 128       # expanded channels held in shared memory at a time


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
    dw_scale: torch.Tensor   # (E,) f32
    dw_bias: torch.Tensor    # (E,) f32
    dw_mult: float
    dw_in_zp: int
    dw_zp: int
    rd: MatmulOperands
    rd_s: float              # reduce output scale (the residual's second operand)
    add_mult: float
    add_zp: int


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
    dw_scale, dw_bias, dw_mult = epilogue_constants(t(comb), t(bias), os_, True)
    dw_zp = i(oz)
    qw, comb, bias, os_, oz = rd
    rd_ops = conv1x1_operands(t(qw).reshape(spec.c_e, spec.cout), t(comb), t(bias),
                              dw_zp, os_, oz, False, 0, qmax, device)
    return FrostBlockParams(
        x_scale=f(x_scale), x_zp=x_zp, sq=sq_ops,
        cat_sq_s=cat_sq_s, cat_sq_mult=cat_sq_mult, cat_x_s=cat_x_s,
        cat_x_mult=cat_x_mult, cat_zp=cat_zp, ex=ex_ops,
        dw_w=t(dw[0]).to(torch.int8).reshape(spec.kernel ** 2, spec.c_e).to(device),
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
        [("x", _P), ("out", _P)]
        + [(n, _I) for n in ("B", "H", "W", "Cin", "Cout", "Ho", "Wo", "E", "Ccat", "Csq",
                             "has_squeeze", "has_expand", "residual",
                             "tile_h", "tile_w", "halo_h", "halo_w", "e_chunk", "tiles_w",
                             "ld_x", "ld_cat", "ld_e", "ld_d",
                             "off_cat", "off_e", "off_d", "off_acc")]
        + [("qmax", _F), ("x_zp", _F), ("x_scale", _F)]
        + [("sq_w", _P), ("sq_zt", _P), ("sq_scale", _P), ("sq_bias", _P),
           ("sq_ldw", _I), ("sq_mult", _F), ("sq_zp", _F)]
        + [(n, _F) for n in ("cat_sq_s", "cat_sq_mult", "cat_x_s", "cat_x_mult", "cat_zp")]
        + [("ex_w", _P), ("ex_zt", _P), ("ex_scale", _P), ("ex_bias", _P),
           ("ex_ldw", _I), ("ex_mult", _F), ("ex_zp", _F)]
        + [("dw_w", _P), ("dw_scale", _P), ("dw_bias", _P), ("dw_in_zp", _I),
           ("dw_mult", _F), ("dw_zp", _F)]
        + [("rd_w", _P), ("rd_zt", _P), ("rd_scale", _P), ("rd_bias", _P),
           ("rd_ldw", _I), ("rd_mult", _F), ("rd_zp", _F), ("rd_s", _F)]
        + [("add_mult", _F), ("add_zp", _F)]
    )


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """Output tile, expanded-width chunk and shared-memory layout of a launch."""

    tile_h: int
    tile_w: int
    halo_h: int
    halo_w: int
    e_chunk: int
    tiles_h: int
    tiles_w: int
    ld_x: int
    ld_cat: int
    ld_e: int
    ld_d: int
    off_cat: int
    off_e: int
    off_d: int
    off_acc: int
    smem: int


def _row_stride(nbytes: int) -> int:
    """Shared-memory row stride: whole words, an odd number of them."""
    words = -(-nbytes // 4)
    return 4 * (words + 1 - words % 2)


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def _layout(spec: FrostBlockSpec, th: int, tw: int, ec: int) -> LaunchPlan:
    ho, wo = spec.out_hw
    hh = (th - 1) * spec.stride + spec.kernel
    hw = (tw - 1) * spec.stride + spec.kernel
    hp, tp = hh * hw, th * tw
    ld_x = _row_stride(spec.cin)
    ld_cat = _row_stride(spec.c_sq + spec.cin) if spec.has_squeeze else 0
    ld_e = _row_stride(ec) if spec.has_expand else 0
    ld_d = _row_stride(ec)
    off_cat = _align16(hp * ld_x)
    off_e = off_cat + _align16(hp * ld_cat)
    off_d = off_e + _align16(hp * ld_e)
    off_acc = off_d + _align16(tp * ld_d)
    smem = off_acc + tp * spec.cout * 4
    return LaunchPlan(th, tw, hh, hw, ec, -(-ho // th), -(-wo // tw),
                      ld_x, ld_cat, ld_e, ld_d, off_cat, off_e, off_d, off_acc, smem)


def plan_launch(spec: FrostBlockSpec) -> LaunchPlan:
    """Largest output tile (up to TILE x TILE) and expanded-width chunk (up to
    E_CHUNK channels) whose working set fits shared memory."""
    for name, v in (("cin", spec.cin), ("cout", spec.cout), ("c_sq", spec.c_sq),
                    ("c_e", spec.c_e)):
        if v % 8:
            raise ValueError(f"frost_block_int8 takes channel counts divisible by 8; {name}={v}")
    if spec.kernel not in (3, 5) or spec.stride not in (1, 2):
        raise ValueError(f"frost_block_int8 takes k 3|5, stride 1|2; got {spec}")
    if spec.residual and (spec.stride != 1 or spec.cin != spec.cout):
        raise ValueError(f"residual block must keep its shape: {spec}")
    ho, wo = spec.out_hw
    th, tw, ec = min(TILE, ho), min(TILE, wo), min(E_CHUNK, spec.c_e)
    while True:
        plan = _layout(spec, th, tw, ec)
        if plan.smem <= SMEM_LIMIT:
            return plan
        if ec > 32:
            ec = max(32, ec // 2 // 8 * 8)
        elif max(th, tw) > 1:
            th, tw = max(1, th // 2), max(1, tw // 2)
        else:
            raise ValueError(f"no tile of {spec} fits {SMEM_LIMIT} bytes of shared memory")


def _ptr(t: Optional[torch.Tensor]) -> int:
    return t.data_ptr() if t is not None else 0


def launch_args(spec: FrostBlockSpec, p: FrostBlockParams, plan: LaunchPlan) -> FrostBlockArgs:
    """The static part of the kernel's arguments (x, out and B set per call)."""
    ho, wo = spec.out_hw
    a = FrostBlockArgs()
    a.H, a.W, a.Cin, a.Cout, a.Ho, a.Wo = spec.h, spec.w, spec.cin, spec.cout, ho, wo
    a.E, a.Csq = spec.c_e, spec.c_sq
    a.Ccat = spec.c_sq + spec.cin if spec.has_squeeze else spec.cin
    a.has_squeeze, a.has_expand, a.residual = spec.has_squeeze, spec.has_expand, spec.residual
    for name in ("tile_h", "tile_w", "halo_h", "halo_w", "e_chunk", "tiles_w", "ld_x",
                 "ld_cat", "ld_e", "ld_d", "off_cat", "off_e", "off_d", "off_acc"):
        setattr(a, name, getattr(plan, name))
    a.qmax = float(spec.act_qmax)
    a.x_zp, a.x_scale = float(p.x_zp), p.x_scale
    for prefix, op in (("sq", p.sq), ("ex", p.ex), ("rd", p.rd)):
        if op is None:
            continue
        setattr(a, f"{prefix}_w", _ptr(op.wt))
        setattr(a, f"{prefix}_zt", _ptr(op.zterm))
        setattr(a, f"{prefix}_scale", _ptr(op.scale))
        setattr(a, f"{prefix}_bias", _ptr(op.bias))
        setattr(a, f"{prefix}_ldw", op.wt.shape[1])
        setattr(a, f"{prefix}_mult", op.out_mult)
        setattr(a, f"{prefix}_zp", float(op.out_zp))
    a.cat_sq_s, a.cat_sq_mult = p.cat_sq_s, p.cat_sq_mult
    a.cat_x_s, a.cat_x_mult, a.cat_zp = p.cat_x_s, p.cat_x_mult, float(p.cat_zp)
    a.dw_w, a.dw_scale, a.dw_bias = _ptr(p.dw_w), _ptr(p.dw_scale), _ptr(p.dw_bias)
    a.dw_in_zp, a.dw_mult, a.dw_zp = p.dw_in_zp, p.dw_mult, float(p.dw_zp)
    a.rd_s, a.add_mult, a.add_zp = p.rd_s, p.add_mult, float(p.add_zp)
    return a


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
        lib.frost_block_error_string.argtypes = [_I]
        lib.frost_block_error_string.restype = ctypes.c_char_p
    return lib


def frost_block_int8(x: torch.Tensor, p: FrostBlockParams, spec: FrostBlockSpec,
                     plan: Optional[LaunchPlan] = None,
                     args: Optional[FrostBlockArgs] = None) -> torch.Tensor:
    """Run one fused INT8 Frost block: (B, H, W, Cin) uint8 -> (B, Ho, Wo, Cout).

    CPU tensors take the plain version; a CUDA tensor launches the kernel
    (or raises). ``plan``/``args`` may be precomputed once per block (the
    frozen model does). Each launch adds one to ``frost_block_int8.launches``.
    """
    if x.dtype != torch.uint8 or x.dim() != 4 or tuple(x.shape[1:]) != (spec.h, spec.w, spec.cin):
        raise ValueError(f"x must be (B, {spec.h}, {spec.w}, {spec.cin}) uint8, "
                         f"got {tuple(x.shape)} {x.dtype}")
    if x.device != p.rd.wt.device:
        raise ValueError(f"x on {x.device}, operands on {p.rd.wt.device}")
    if x.device.type == "cpu":
        return frost_block_int8_plain(x, p, spec)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.shape[0] > 65535:
        raise ValueError(f"batch {x.shape[0]} exceeds the kernel's grid")
    plan = plan or plan_launch(spec)
    base = args if args is not None else launch_args(spec, p, plan)
    x = x.contiguous()
    if x.data_ptr() % 16:  # the kernel reads the input in 32-bit words
        x = x.clone()
    ho, wo = spec.out_hw
    out = torch.empty((x.shape[0], ho, wo, spec.cout), dtype=torch.uint8, device=x.device)
    a = FrostBlockArgs.from_buffer_copy(base)
    a.x, a.out, a.B = x.data_ptr(), out.data_ptr(), x.shape[0]
    lib = _bind()
    err = lib.frost_block_int8(ctypes.byref(a), spec.kernel, spec.stride, plan.smem,
                               torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(err, lib.frost_block_error_string, "frost_block_int8")
    frost_block_int8.launches += 1
    return out


frost_block_int8.launches = 0
