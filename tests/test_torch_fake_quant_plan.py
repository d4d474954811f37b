"""PyTorch port: the fake-quant kernel's launch plan and its dataflow, on the CPU.

``ops.fake_quant.plan_fake_quant`` picks each observing site's launch: one
thread-block cluster whose shared memory holds all of x, or a grid of one
CUDA block an SM, each keeping part of its chunk of x in shared memory and
streaming the rest. The kernel (``csrc/fake_quant.cu``) runs only on a card,
so these tests check what surrounds it:

* at every per-tensor site of a frostnet_quant_large_1_0 QAT forward (224x224,
  batch 8, 128 and 256, float32 and bf16 sizes, x aligned or not) and at the
  GPU tests' shapes, the planned ranges cover every element exactly once, a
  CUDA block's shared memory stays within an H100's 227 KB, tiny sites take
  the cluster and large ones the grid;
* a numpy emulation of both shapes' dataflow on the planned ranges (each
  block's partial min/max, the reduction every block makes in the same
  order, the old state each block reads before block 0 writes the new one,
  the quantize of each range) equals ``fake_quant_observe_plain`` bit for
  bit, for an unaligned view and a fresh (+-inf) state too.
"""
import functools

import numpy as np
import pytest
import torch

from frostnet_tpu_torch import quant as tq
from frostnet_tpu_torch.ops.fake_quant import (CLUSTER_BYTES, MAX_CLUSTER, RANK_BYTES,
                                               RESIDENT_BYTES, VECTOR_BYTES,
                                               fake_quant_observe_plain, plan_fake_quant)
from frostnet_tpu_torch.quant.fake_quant import fake_quant_forward

H100_SMS = 132
SMEM_LIMIT = 232448  # shared memory one CUDA block may use on an H100
STATIC_SMEM = 1024  # the kernel's static shared memory, with room to spare


@functools.lru_cache(maxsize=None)
def _site_shapes():
    """(shape, is_weight) of the 166 per-tensor sites of one QAT forward of
    frostnet_quant_large_1_0 at 224x224, batch 1, in call order."""
    from chip_smoke import MODEL, capture_sites
    from frostnet_tpu_torch.models import create_model
    from frostnet_tpu_torch.nn import QAT
    from frostnet_tpu_torch.quant import from_jax_variables, numpy_init

    model = create_model(MODEL, num_classes=1000, drop_rate=0.0)
    from_jax_variables(model, numpy_init(model, 0))
    x = torch.as_tensor(np.random.RandomState(0).randn(1, 224, 224, 3).astype(np.float32))
    return [(tuple(s[0].shape), s[3].symmetric) for s in capture_sites(model, x, QAT)]


def _check_plan(plan, n, itemsize, aligned, sms=H100_SMS):
    """Every element in exactly one range; shared memory within the card's."""
    assert plan.n == n and plan.vec * itemsize == VECTOR_BYTES
    assert plan.nv == (n // plan.vec if aligned else 0)
    vectors, scalars = [], []
    for b in range(plan.blocks):
        (r0, r1), tiles, (e0, e1) = plan.ranges(b)
        assert r1 - r0 <= plan.res and e0 <= e1
        vectors += [(r0, r1)] + tiles
        scalars.append((e0, e1))
    for spans, start, stop in ((vectors, 0, plan.nv), (scalars, plan.nv * plan.vec, n)):
        at = start
        for lo, hi in sorted(s for s in spans if s[1] > s[0]):
            assert lo == at, f"gap or overlap at {at}: {lo}"
            at = hi
        assert at == stop
    assert plan.smem == (0 if plan.cluster else plan.res * VECTOR_BYTES) <= RESIDENT_BYTES
    assert plan.smem + STATIC_SMEM <= SMEM_LIMIT
    if plan.cluster:
        assert plan.blocks & (plan.blocks - 1) == 0 and plan.blocks <= MAX_CLUSTER
        assert plan.blocks * plan.res >= plan.nv  # all of x resident,
        assert plan.res * VECTOR_BYTES <= RANK_BYTES  # in 4 registers of 256 threads
    else:
        assert plan.blocks == sms


@pytest.mark.parametrize("itemsize", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("batch", [8, 128, 256])
def test_plan_covers_every_site_of_the_model(batch, itemsize):
    shapes = _site_shapes()
    assert len(shapes) == 166
    shapes_seen = {"cluster": 0, "grid": 0}
    for shape, is_weight in shapes:
        n = int(np.prod(shape)) * (1 if is_weight else batch)
        for aligned in (True, False):
            plan = plan_fake_quant(n, itemsize, aligned, H100_SMS)
            _check_plan(plan, n, itemsize, aligned)
            nbytes = n * itemsize
            assert plan.cluster == (nbytes <= CLUSTER_BYTES)
            if plan.cluster:
                assert plan.blocks == 1 or (plan.blocks // 2) * RANK_BYTES < nbytes
                assert plan.blocks * RANK_BYTES >= nbytes
            shapes_seen["cluster" if plan.cluster else "grid"] += aligned
    # most weights take the cluster; at batch 128 every activation the grid
    assert shapes_seen["cluster"] >= 50 and shapes_seen["grid"] >= (50 if batch == 8 else 96)


# the GPU tests' shapes (tests/test_torch_cuda.py FQ_CASES) and sizes at the
# shapes' boundaries: one vector, one cluster rank, the largest cluster, one
# element past it, a grid with streamed vectors, ragged tails
PLAN_SIZES = [1, 7, 8, 91, 8 * 112 * 112 * 32, 8 * 56 * 56 * 144, 3 * 3 * 720, 8 * 1000,
              128 * 56 * 56 * 144, 4 * 7 * 7 * 1440, 6 * 14 * 14 * 104, 4 * 7 * 7 * 96,
              RANK_BYTES // 4, RANK_BYTES // 4 + 1, CLUSTER_BYTES // 4, CLUSTER_BYTES // 4 + 1,
              CLUSTER_BYTES // 2 + 3, H100_SMS * RESIDENT_BYTES // 4 + 5,
              3 * H100_SMS * RESIDENT_BYTES // 4 - 1]


@pytest.mark.parametrize("n", PLAN_SIZES)
def test_plan_covers_sizes_at_the_shape_boundaries(n):
    for itemsize in (4, 2):
        for aligned in (True, False):
            plan = plan_fake_quant(n, itemsize, aligned, H100_SMS)
            _check_plan(plan, n, itemsize, aligned)
    assert plan_fake_quant(RANK_BYTES // 4, 4, True, H100_SMS).blocks == 1
    assert plan_fake_quant(RANK_BYTES // 4 + 1, 4, True, H100_SMS).blocks == 2
    assert plan_fake_quant(CLUSTER_BYTES // 4, 4, True, H100_SMS).blocks == MAX_CLUSTER
    assert not plan_fake_quant(CLUSTER_BYTES // 4 + 1, 4, True, H100_SMS).cluster
    big = plan_fake_quant(3 * H100_SMS * RESIDENT_BYTES // 4 - 1, 4, True, H100_SMS)
    assert big.res * VECTOR_BYTES == RESIDENT_BYTES and big.ranges(0)[1]  # streams a part


def test_plan_rejects_what_the_kernel_cannot_take():
    for n, itemsize, sms in ((0, 4, 132), (5, 8, 132), (5, 4, 0)):
        with pytest.raises(ValueError):
            plan_fake_quant(n, itemsize, True, sms)


def _nan_min(a, b):
    return a if (a < b or a != a) else b


def _nan_max(a, b):
    return a if (a > b or a != a) else b


def _emulate(x, state, spec, plan):
    """The kernel's dataflow on the CPU: (y, mask, new state, scale, zero
    point, blocks' new states)."""
    flat = x.reshape(-1)
    xf = flat.to(torch.float32).numpy()
    vec = plan.vec
    old = [(state.min_val.clone(), state.max_val.clone()) for _ in range(plan.blocks)]

    def elems(b):  # block b's element ranges: resident, streamed tiles, scalar
        (r0, r1), tiles, (e0, e1) = plan.ranges(b)
        return [(r0 * vec, r1 * vec)] + [(t0 * vec, t1 * vec) for t0, t1 in tiles] + [(e0, e1)]

    # 1-2. each block's partial (min, max) over its ranges
    parts = []
    for b in range(plan.blocks):
        mn, mx = np.float32(np.inf), np.float32(-np.inf)
        for lo, hi in elems(b):
            mn = _nan_min(mn, np.float32(xf[lo:hi].min(initial=np.inf)))
            mx = _nan_max(mx, np.float32(xf[lo:hi].max(initial=-np.inf)))
        parts.append((mn, mx))
    # 3. the reduction every block makes: the cluster's in rank order, the
    # grid's 32 lanes strided over the blocks, then a butterfly
    if plan.cluster:
        gmn, gmx = np.float32(np.inf), np.float32(-np.inf)
        for mn, mx in parts:
            gmn, gmx = _nan_min(gmn, mn), _nan_max(gmx, mx)
    else:
        lanes = [[np.float32(np.inf), np.float32(-np.inf)] for _ in range(32)]
        for b, (mn, mx) in enumerate(parts):
            lanes[b % 32] = [_nan_min(lanes[b % 32][0], mn), _nan_max(lanes[b % 32][1], mx)]
        o = 16
        while o:
            lanes = [[_nan_min(lo, lanes[i ^ o][0]), _nan_max(hi, lanes[i ^ o][1])]
                     for i, (lo, hi) in enumerate(lanes)]
            o //= 2
        gmn, gmx = lanes[0]
    # each block finishes from the old state it read before the barrier
    batch = torch.tensor([gmn, gmx], dtype=torch.float32)
    finished = []
    for m0, mx0 in old:
        st = tq.update_observer(tq.ObserverState(m0, mx0), batch, spec)
        finished.append((st, *tq.calculate_qparams_traced(st, spec)))
    st, scale, zp = finished[0]  # block 0 writes the state and qparams
    # 4. each block quantizes its ranges with its own qparams
    y = torch.full_like(flat, float("nan"))
    mask = torch.zeros(flat.shape, dtype=torch.int8)
    for b in range(plan.blocks):
        _, s_b, z_b = finished[b]
        for lo, hi in elems(b):
            if hi > lo:
                yb, mb = fake_quant_forward(flat[lo:hi], s_b, z_b, spec.qmin, spec.qmax)
                y[lo:hi] = yb
                mask[lo:hi] += mb.to(torch.int8) + 2  # 2 or 3: written once
    assert bool((mask >= 2).all() and (mask <= 3).all()), "an element written 0 or 2+ times"
    return y.reshape(x.shape), (mask == 3).reshape(x.shape), st, scale, zp, finished


# (n, dtype, scale of the values, state before: None = fresh, spec, SMs)
EMULATED = [
    (1, torch.float32, 1.0, None, "act", 132),
    (7 * 13, torch.float32, 1.0, None, "act", 132),
    (3 * 3 * 720, torch.float32, 0.1, (-0.2, 0.3), "weight", 132),
    (8 * 1000 + 3, torch.bfloat16, 20.0, (-30.0, 20.0), "act", 132),
    (8 * 28 * 28 * 40, torch.bfloat16, 3.0, (-1.0, 1.5), "act", 132),
    (CLUSTER_BYTES // 4, torch.float32, 2.0, (-0.5, 2.0), "act", 132),
    (CLUSTER_BYTES // 4 + 1, torch.float32, 2.0, None, "act", 132),
    (CLUSTER_BYTES // 2 + 9, torch.bfloat16, 1.0, (-2.0, 2.0), "act", 132),
    (2 * RESIDENT_BYTES + 9, torch.bfloat16, 1.0, (-2.0, 2.0), "act", 4),
    (900_001, torch.float32, 5.0, (-3.0, 6.0), "running", 4),
    (900_000, torch.float32, 0.05, (-0.1, 0.1), "weight", 3),
]


@pytest.mark.parametrize("unaligned", [False, True], ids=["aligned", "view"])
@pytest.mark.parametrize("case", EMULATED, ids=lambda c: f"{c[0]}_{str(c[1])[6:]}_{c[4]}_sms{c[5]}")
def test_emulated_dataflow_equals_the_plain_version(case, unaligned):
    n, dtype, mag, before, kind, sms = case
    spec = {"act": tq.QNNPACK_ACT, "weight": tq.QNNPACK_WEIGHT,
            "running": tq.QSpec(0, 255, False, averaging_constant=None)}[kind]
    rng = np.random.RandomState(n % 1000 + sms)
    base = torch.as_tensor((rng.randn(n + 1) * mag + 0.3).astype(np.float32)).to(dtype)
    x = base[1:] if unaligned else base[:n]
    assert (x.data_ptr() % VECTOR_BYTES != 0) == unaligned or n == 1
    mn, mx = (float("inf"), float("-inf")) if before is None else before
    state = tq.ObserverState(torch.tensor(mn), torch.tensor(mx))
    plan = plan_fake_quant(n, x.element_size(), x.data_ptr() % VECTOR_BYTES == 0, sms)
    _check_plan(plan, n, x.element_size(), x.data_ptr() % VECTOR_BYTES == 0, sms)
    y, mask, st, scale, zp, finished = _emulate(x, state, spec, plan)
    py, pmask, pst, ps, pz = fake_quant_observe_plain(x, state, spec)
    assert y.dtype == dtype and torch.equal(y, py) and torch.equal(mask, pmask)
    assert torch.equal(st.min_val, pst.min_val) and torch.equal(st.max_val, pst.max_val)
    assert torch.equal(scale, ps) and torch.equal(zp, pz)
    for b_st, b_s, b_z in finished:  # every block derives the same
        assert torch.equal(b_st.min_val, pst.min_val) and torch.equal(b_s, ps)
        assert torch.equal(b_z, pz)
    if n > 1000 and before is not None and kind != "running":  # the EMA lags: some clip
        assert (~mask).any() and mask.any()

