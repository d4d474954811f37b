"""PyTorch port, fused INT8 Frost block (frostnet_tpu_torch/ops/frost_block).

The plain version is held bit-exact against the JAX spec of the TPU kernel
(``reference_frost_block_int8``) on the five cases of
tests/test_pallas_frost_block.py, from the same ``random_block_case`` draws.
The CUDA kernel is held against the plain version on the card in
tests/test_torch_cuda.py and chip_smoke.py.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from frostnet_tpu.ops import pallas_frost_block as jfb
from frostnet_tpu_torch.models import create_model
from frostnet_tpu_torch.ops import frost_block as tfb
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


@pytest.mark.parametrize("backend", ["qnnpack", "fbgemm"])
def test_launch_plan_fits_every_block_of_the_model(backend):
    model = create_model("frostnet_quant_large_1_0", qconfig=get_qconfig(backend))
    specs = model.block_specs(224)
    assert len(specs) == 18
    for _, spec in specs:
        plan = tfb.plan_launch(spec)
        assert plan.smem <= tfb.SMEM_LIMIT
        assert plan.e_chunk % 8 == 0 and plan.ld_x % 4 == 0 and (plan.ld_x // 4) % 2 == 1
        ho, wo = spec.out_hw
        assert plan.tiles_h * plan.tile_h >= ho and plan.tiles_w * plan.tile_w >= wo


def test_plan_rejects_shapes_the_kernel_cannot_take():
    base = dict(h=14, w=14, cin=96, cout=96, kernel=5, stride=1, has_squeeze=True,
                has_expand=True, c_sq=24, c_e=360, residual=True)
    for bad in (dict(cin=90, cout=90), dict(kernel=7), dict(stride=2)):
        with pytest.raises(ValueError):
            tfb.plan_launch(tfb.FrostBlockSpec(**{**base, **bad}))
    huge = tfb.FrostBlockSpec(**{**base, "cin": 8192, "cout": 8192, "c_e": 8192})
    with pytest.raises(ValueError):
        tfb.plan_launch(huge)
