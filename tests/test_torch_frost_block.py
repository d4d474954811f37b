"""PyTorch port, fused INT8 Frost block (frostnet_tpu_torch/ops/frost_block).

The plain version is held bit-exact against the JAX spec of the TPU kernel
(``reference_frost_block_int8``) on the five cases of
tests/test_pallas_frost_block.py, from the same ``random_block_case`` draws.
The CUDA kernel is held against the plain version on the card in
tests/test_torch_cuda.py and chip_smoke.py.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from frostnet_tpu.ops import pallas_frost_block as jfb
from frostnet_tpu_torch.models import create_model, list_models
from frostnet_tpu_torch.ops import frost_block as tfb
from frostnet_tpu_torch.ops.int8_matmul import int8_matmul_requant_plain
from frostnet_tpu_torch.quant import get_qconfig

CASES = [
    dict(h=14, w=14, cin=96, cout=96, kernel=5, stride=1, has_squeeze=True,
         has_expand=True, c_sq=24, c_e=360, residual=True),
    dict(h=28, w=28, cin=40, cout=80, kernel=5, stride=2, has_squeeze=True,
         has_expand=True, c_sq=16, c_e=336, residual=False),
    dict(h=56, w=56, cin=24, cout=24, kernel=3, stride=1, has_squeeze=False,
         has_expand=True, c_sq=0, c_e=144, residual=True),
    dict(h=32, w=32, cin=16, cout=16, kernel=3, stride=1, has_squeeze=False,
         has_expand=False, c_sq=0, c_e=16, residual=True),
    dict(h=14, w=14, cin=96, cout=96, kernel=5, stride=1, has_squeeze=True,
         has_expand=True, c_sq=24, c_e=360, residual=True, act_qmax=127),
]


def _case_id(c):
    kind = "cas" if c["has_squeeze"] else ("mb" if c["has_expand"] else "e1")
    return f"{kind}_k{c['kernel']}s{c['stride']}{'r' if c['residual'] else ''}_q{c.get('act_qmax', 255)}"


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_plain_matches_jax_reference(case):
    jspec, tspec = jfb.FrostBlockSpec(**case), tfb.FrostBlockSpec(**case)
    seed = 7
    jx, jp = jfb.random_block_case(jspec, 2, seed=seed)
    tx, tp = tfb.random_block_case(tspec, 2, seed=seed)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))  # the same draws
    np.testing.assert_array_equal(tp.rd.wt[:, :case["c_e"]].t().numpy(), np.asarray(jp.rd_w))

    # The spec run as the frozen graph runs: scales are compile-time constants.
    want = np.asarray(jax.jit(lambda x: jfb.reference_frost_block_int8(x, jp, jspec))(jx))
    if tspec.has_squeeze:
        # The spec requantizes each cat half on its own, so XLA folds
        # (q - z) * s_in * (1 / s_cat) into one multiply by f32(s_in / s_cat)
        # there; in the model a concatenate sits between the two products and
        # they round separately (the port's default, as in the model).
        inv = torch.tensor(tp.cat_sq_mult, dtype=torch.float32)  # f32(1 / s_cat)

        def fold(s):
            return float(torch.tensor(s, dtype=torch.float32) * inv)

        tp = dataclasses.replace(tp, cat_sq_s=fold(tp.cat_sq_s), cat_sq_mult=1.0,
                                 cat_x_s=fold(tp.cat_x_s), cat_x_mult=1.0)
    got = tfb.frost_block_int8(tx, tp, tspec)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


QUANT_MODELS = [n for n in list_models("frostnet_quant_")]
SMS = 132  # an H100's SM count


@functools.lru_cache(maxsize=None)
def _specs(name, backend):
    return create_model(name, qconfig=get_qconfig(backend)).block_specs(224)


def _plan_cases():
    # the model the port serves keeps its earlier ids at batch 8
    for backend in ("qnnpack", "fbgemm"):
        for name in QUANT_MODELS:
            for batch in (1, 8, 128):
                plain = name == "frostnet_quant_large_1_0" and batch == 8
                yield pytest.param(backend, name, batch,
                                   id=backend if plain else f"{backend}-{name}-b{batch}")


def _odd16(stride, nbytes):
    """A shared-memory operand row: an odd number of 16-byte units holding
    ``nbytes`` padded to the MMA's 32-byte K step."""
    return stride % 16 == 0 and (stride // 16) % 2 == 1 and stride >= -(-nbytes // 32) * 32


@pytest.mark.parametrize("backend,name,batch", list(_plan_cases()))
def test_launch_plan_fits_every_block_of_the_model(backend, name, batch):
    specs = _specs(name, backend)
    assert len(specs) >= 14
    for _, spec in specs:
        plan = tfb.plan_launch(spec, batch, SMS)
        assert plan.cluster in (1, 2, 4, 8, 16)
        assert plan.smem <= tfb.SMEM_LIMIT
        # each rank owns a run of E_UNIT-channel units, MIN_SLICE channels at
        # least; together they cover the expanded width once
        lo = 0
        for e_lo, e_hi in plan.e_slices(spec.c_e):
            assert e_lo == lo and e_lo % tfb.E_UNIT == 0
            assert e_hi - e_lo >= min(tfb.MIN_SLICE, spec.c_e)
            lo = e_hi
        assert lo == spec.c_e
        lo = 0
        for n_lo, n_hi in plan.cout_slices(spec.cout):
            assert n_lo == lo and n_lo <= n_hi and n_lo % 4 == 0
            lo = n_hi
        assert lo == spec.cout
        # one wave of CUDA blocks wherever the expanded width allows it
        groups = batch * plan.tiles_h * plan.tiles_w
        c16 = tfb._fit(spec, batch, SMS, 16, plan.tile_h, plan.tile_w, True)
        assert (groups * plan.cluster >= SMS or plan.cluster == tfb.MAX_CLUSTER
                or spec.c_e < 2 * plan.cluster * tfb.MIN_SLICE
                or (plan.cluster == 8 and (c16 is None or c16.smem > tfb.SMEM_TWO_PER_SM)))
        if plan.cluster == tfb.MAX_CLUSTER:
            assert plan.smem <= tfb.SMEM_TWO_PER_SM
        assert plan.threads == (512 if groups * plan.cluster <= SMS else 256)
        assert plan.grid == (plan.tiles_h * plan.tiles_w * plan.cluster, batch)
        ho, wo = spec.out_hw
        assert plan.tiles_h * plan.tile_h >= ho and plan.tiles_w * plan.tile_w >= wo
        if spec.h <= tfb.WHOLE_MAP and spec.w <= tfb.WHOLE_MAP:
            assert (plan.tiles_h, plan.tiles_w) == (1, 1)
        ccat = spec.c_sq + spec.cin if spec.has_squeeze else spec.cin
        assert _odd16(plan.ld_x, spec.cin) and _odd16(plan.ld_d, plan.e_chunk)
        assert _odd16(plan.ld_rd, plan.e_chunk)
        if spec.has_squeeze:
            assert _odd16(plan.ld_sq, spec.cin) and _odd16(plan.ld_cat, ccat)
        if spec.has_expand:
            assert _odd16(plan.ld_ex, ccat)
        assert plan.e_chunk % tfb.E_UNIT == 0 and plan.stages in (1, 2)
        assert (plan.stages == 2) == (plan.e_chunk < max(hi - lo for lo, hi in
                                                         plan.e_slices(spec.c_e)))


def _sections(spec, plan):
    """``(name, start, end, first phase, last phase)`` of every shared-memory
    section the kernel uses; phases: 0 prologue, 1 squeeze and cat, 2 the
    expanded chunk's zero-point fill and the chunks, 3 the exchange and the
    epilogue."""
    hp, tp = plan.halo_h * plan.halo_w, plan.tile_h * plan.tile_w
    n_in = min(plan.halo_h, spec.h) * min(plan.halo_w, spec.w)
    part = plan.cluster * tp * plan.n_cols * 4
    secs = [("xs", 0, hp * plan.ld_x, 0, 1 if spec.has_squeeze else 2),
            ("part", plan.off_acc, plan.off_acc + part, 2, 3),
            ("rd consts", plan.off_rdc, plan.off_rdc + 12 * spec.cout, 0, 3),
            ("stages", plan.off_w, plan.off_w + plan.stages * plan.w_stage, 0, 2),
            ("tables", plan.off_tab, plan.off_tab + 512 + 4 * spec.cout + 2 * n_in, 0, 2),
            ("mbarriers", plan.off_bar, plan.off_bar + 48, 0, 3),
            ("ds", plan.off_d, plan.off_d + tp * plan.ld_d, 2, 2)]
    if spec.has_squeeze:
        secs += [("cat", plan.off_cat, plan.off_cat + n_in * plan.ld_cat, 1, 2),
                 ("squeeze head", plan.off_sqc, plan.off_e + spec.c_sq * plan.ld_sq, 0, 1)]
    if spec.has_expand:
        secs.append(("es", plan.off_e, plan.off_e + hp * plan.ld_e, 2, 2))
    if plan.cluster > 1:
        secs.append(("received partials", plan.off_cat, plan.off_cat + part, 3, 3))
    return secs


@pytest.mark.parametrize("backend,name,batch", list(_plan_cases()))
def test_shared_memory_sections_live_at_once_do_not_overlap(backend, name, batch):
    for _, spec in _specs(name, backend):
        plan = tfb.plan_launch(spec, batch, SMS)
        secs = _sections(spec, plan)
        for i, (n1, s1, e1, f1, l1) in enumerate(secs):
            assert s1 % 16 == 0 and e1 <= plan.smem
            for n2, s2, e2, f2, l2 in secs[i + 1:]:
                live_together = f1 <= l2 and f2 <= l1
                assert not (live_together and s1 < e2 and s2 < e1), (spec, n1, n2)


def test_plan_rejects_shapes_the_kernel_cannot_take():
    base = dict(h=14, w=14, cin=96, cout=96, kernel=5, stride=1, has_squeeze=True,
                has_expand=True, c_sq=24, c_e=360, residual=True)
    for bad in (dict(cin=90, cout=90), dict(kernel=7), dict(stride=2), dict(has_expand=False)):
        with pytest.raises(ValueError):
            tfb.plan_launch(tfb.FrostBlockSpec(**{**base, **bad}), 8, SMS)
    huge = tfb.FrostBlockSpec(**{**base, "cin": 8192, "cout": 8192, "c_e": 8192})
    with pytest.raises(ValueError):
        tfb.plan_launch(huge, 8, SMS)
    for batch in (0, 65536):
        with pytest.raises(ValueError):
            tfb.plan_launch(tfb.FrostBlockSpec(**base), batch, SMS)


@pytest.mark.parametrize("backend", ["qnnpack", "fbgemm"])
def test_plans_with_one_pack_key_pack_the_weights_alike(backend):
    """The wrapper packs a block's weights once per ``pack_key`` and shares
    them across batch sizes: plans that agree on the key must pack the same
    bytes, and the head must not depend on the plan at all."""
    shared = 0
    for i, (_, spec) in enumerate(_specs("frostnet_quant_large_1_0", backend)):
        _, p = tfb.random_block_case(spec, 1, seed=i)
        plans = [tfb.plan_launch(spec, b, SMS) for b in (1, 2, 8, 16, 128)]
        heads = {bytes(tfb.pack_head(spec, p, pl).numpy()) for pl in plans}
        assert len(heads) == 1
        packs = {}
        for pl in plans:
            got = tfb.pack_stages(spec, p, pl)
            if pl.pack_key in packs:
                assert torch.equal(packs[pl.pack_key], got)
                shared += 1
            packs[pl.pack_key] = got
    assert shared >= 18


@pytest.mark.parametrize("c_e,batch", [(1440, 8), (720, 8), (1440, 128)])
def test_reduce_over_the_plan_slices_adds_the_zero_point_term_once(c_e, batch):
    """The kernel's split reduce: int32 partials over the plan's E slices,
    summed, the zero-point term (over the whole E) added once, equal the
    whole reduce; adding the term per slice would not."""
    spec = tfb.FrostBlockSpec(h=7, w=7, cin=192, cout=192, kernel=5, stride=1, has_squeeze=True,
                              has_expand=True, c_sq=48, c_e=c_e, residual=True)
    plan = tfb.plan_launch(spec, batch, SMS)
    assert plan.cluster > 1
    _, p = tfb.random_block_case(spec, 1, seed=11)
    rng = np.random.RandomState(12)
    q_d = torch.as_tensor(rng.randint(0, 256, (batch * 49, c_e)).astype(np.uint8))
    slices = plan.e_slices(c_e)
    w = p.rd.wt[:, :c_e].to(torch.float64).t()
    partials = [(q_d[:, lo:hi].to(torch.float64) @ w[lo:hi]).to(torch.int32) for lo, hi in slices]

    def reduce(zterm):
        return tfb.requant_epilogue(sum(partials) + zterm, p.rd.scale, p.rd.bias, p.rd.out_mult,
                                    p.rd.out_zp, False, 0, 255)

    want = int8_matmul_requant_plain(q_d, p.rd)
    assert torch.equal(reduce(p.rd.zterm), want)
    assert len(torch.unique(want)) > 32
    assert not torch.equal(reduce(p.rd.zterm * len(slices)), want)  # the term once per slice


def test_kernel_operands_have_the_dtypes_the_kernel_reads():
    """ctypes hands the kernel raw pointers: every zero-point term is int32,
    every scale and bias float32, the weights int8."""
    spec = tfb.FrostBlockSpec(**CASES[0])
    _, p = tfb.random_block_case(spec, 1, seed=3)
    for op in (p.sq, p.ex, p.rd):
        assert op.wt.dtype == torch.int8 and op.zterm.dtype == torch.int32
        assert op.scale.dtype == torch.float32 and op.bias.dtype == torch.float32
    assert p.dw_w.dtype == torch.int8 and p.dw_zt.dtype == torch.int32
    assert p.dw_scale.dtype == torch.float32 and p.dw_bias.dtype == torch.float32
    want = -p.dw_in_zp * p.dw_w.to(torch.int64).sum(dim=0)
    assert torch.equal(p.dw_zt.to(torch.int64), want)


def _packed_block(x, p, spec, plan):
    """The kernel's dataflow on the CPU, reading every weight and epilogue
    constant from the packed head and stages at the plan's offsets: the
    squeeze from the head, each rank's slice chunk by chunk from its stage,
    the int32 partials summed and the reduce's zero-point term added once."""
    qmax, k2 = spec.act_qmax, spec.kernel ** 2
    head, stages = tfb.pack_head(spec, p, plan), tfb.pack_stages(spec, p, plan)
    assert head.numel() == plan.head_bytes and head.numel() % 16 == 0
    assert stages.numel() == plan.cluster * plan.max_chunks * plan.chunk_bytes
    assert plan.first_bytes % 16 == 0 and plan.rd_bytes % 16 == 0 and plan.w_stage % 16 == 0
    assert plan.w_stage >= max(plan.first_bytes, plan.off_slot + plan.rd_bytes)

    def vec(buf, at, n, dtype):
        return buf[at:at + 4 * n].clone().view(dtype)

    def mm(a, w):  # exact int32 product of uint8 codes and int8 weights
        return (a.reshape(-1, a.shape[-1]).to(torch.float64) @ w.to(torch.float64).t()
                ).to(torch.int32)

    cout, csq, ec_max = spec.cout, spec.c_sq, plan.e_chunk
    h = x
    if spec.has_squeeze:
        at = 12 * cout
        w = head[at + 12 * csq:].view(csq, plan.ld_sq)
        assert not w[:, spec.cin:].any()
        q_s = tfb.requant_epilogue(
            mm(x, w[:, :spec.cin].view(torch.int8)) + vec(head, at, csq, torch.int32),
            vec(head, at + 4 * csq, csq, torch.float32), vec(head, at + 8 * csq, csq, torch.float32),
            p.sq.out_mult, p.sq.out_zp, True, 0, qmax).reshape(x.shape[:3] + (csq,))
        h = torch.cat([tfb.requant_codes(q_s, p.sq.out_zp, p.cat_sq_s, p.cat_sq_mult, p.cat_zp, 0,
                                         qmax),
                       tfb.requant_codes(x, p.x_zp, p.cat_x_s, p.cat_x_mult, p.cat_zp, 0, qmax)],
                      dim=-1)
    ho, wo = spec.out_hw
    total = torch.zeros((x.shape[0] * ho * wo, cout), dtype=torch.int32)
    for r, (lo, hi) in enumerate(plan.e_slices(spec.c_e)):
        for j, c0 in enumerate(range(lo, hi, ec_max)):
            assert j < plan.max_chunks
            ec = min(ec_max, hi - c0)
            st = stages[(r * plan.max_chunks + j) * plan.chunk_bytes:][:plan.chunk_bytes]
            cx, cd = plan.off_cx, plan.off_cx + 12 * ec_max
            if spec.has_expand:
                w = st[plan.off_slot:plan.off_slot + ec * plan.ld_ex].view(ec, plan.ld_ex)
                assert not w[:, h.shape[-1]:].any()
                e = tfb.requant_epilogue(
                    mm(h, w[:, :h.shape[-1]].view(torch.int8)) + vec(st, cx, ec, torch.int32),
                    vec(st, cx + 4 * ec_max, ec, torch.float32),
                    vec(st, cx + 8 * ec_max, ec, torch.float32), p.ex.out_mult, p.ex.out_zp,
                    True, 0, qmax).reshape(x.shape[:3] + (ec,))
            else:
                e = x[..., c0:c0 + ec]
            taps = st[:k2 * plan.ld_dw].view(k2, plan.ld_dw)[:, :ec]
            taps = taps.clone().view(torch.int8)
            zt = vec(st, cd, ec, torch.int32)  # the kernel's form: -zp * sum of the taps
            assert torch.equal(zt, -p.dw_in_zp * taps.to(torch.int32).sum(dim=0))
            q_d = tfb.requant_epilogue(
                tfb.depthwise_acc(e, taps, spec.kernel, spec.stride, p.dw_in_zp),
                vec(st, cd + 4 * ec_max, ec, torch.float32),
                vec(st, cd + 8 * ec_max, ec, torch.float32), p.dw_mult, p.dw_zp, True, 0, qmax)
            w = st[plan.first_bytes:].view(cout, plan.ld_rd)
            assert not w[:, ec:tfb._pad32(ec)].any()
            total += mm(q_d, w[:, :ec].clone().view(torch.int8))
    q = tfb.requant_epilogue(total + vec(head, 0, cout, torch.int32),
                             vec(head, 4 * cout, cout, torch.float32),
                             vec(head, 8 * cout, cout, torch.float32), p.rd.out_mult, p.rd.out_zp,
                             False, 0, qmax).reshape(x.shape[0], ho, wo, cout)
    if spec.residual:
        q = tfb.qadd_codes(x, p.x_zp, p.x_scale, q, p.rd.out_zp, p.rd_s, p.add_mult, p.add_zp, 0,
                           qmax)
    return q


PACKED = [  # (spec, batch): clusters of 16, 8, 4, 2 and 1; one and two stages
    (dict(h=7, w=7, cin=192, cout=192, kernel=5, stride=1, has_squeeze=True, has_expand=True,
          c_sq=48, c_e=720, residual=True), 8),
    (dict(h=7, w=7, cin=192, cout=192, kernel=5, stride=1, has_squeeze=True, has_expand=True,
          c_sq=48, c_e=1440, residual=True, act_qmax=127), 128),
    (dict(h=14, w=14, cin=96, cout=192, kernel=5, stride=2, has_squeeze=True, has_expand=True,
          c_sq=48, c_e=864, residual=False), 2),
    (dict(h=14, w=14, cin=96, cout=96, kernel=3, stride=1, has_squeeze=True, has_expand=True,
          c_sq=24, c_e=360, residual=True), 1),
    (dict(h=28, w=28, cin=40, cout=40, kernel=3, stride=1, has_squeeze=True, has_expand=True,
          c_sq=16, c_e=168, residual=True), 1),
    (dict(h=56, w=56, cin=24, cout=40, kernel=5, stride=2, has_squeeze=False, has_expand=True,
          c_sq=0, c_e=144, residual=False), 40),
    (dict(h=32, w=32, cin=32, cout=16, kernel=3, stride=1, has_squeeze=False, has_expand=False,
          c_sq=0, c_e=32, residual=False), 2),
]


@pytest.mark.parametrize("case,batch", PACKED,
                         ids=[f"{c['h']}x{c['cin']}_e{c['c_e']}_b{b}" for c, b in PACKED])
def test_packed_weights_give_the_plain_block(case, batch):
    """The head and stages the kernel bulk-copies, read at the plan's offsets
    along its slices and chunks, compute the plain block bit for bit (on two
    images; the plan is the one for ``batch``)."""
    spec = tfb.FrostBlockSpec(**case)
    plan = tfb.plan_launch(spec, batch, SMS)
    x, p = tfb.random_block_case(spec, 2, seed=5)
    want = tfb.frost_block_int8_plain(x, p, spec)
    assert torch.equal(_packed_block(x, p, spec, plan), want)
    assert len(torch.unique(want)) > 16


def test_packed_cases_reach_every_cluster_size_and_both_stagings():
    plans = [tfb.plan_launch(tfb.FrostBlockSpec(**c), b, SMS) for c, b in PACKED]
    assert {pl.cluster for pl in plans} == {1, 2, 4, 8, 16}
    assert {pl.stages for pl in plans} == {1, 2}
