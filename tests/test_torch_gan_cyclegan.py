"""PyTorch port, CycleGAN training against the JAX package.

Small nets (two-block ``ResnetGenerator``s at ngf 8, ``basic`` PatchGANs
at ndf 8 without norm, as CycleGAN's, 32x32 ``SyntheticPairs``, batch 1),
both packages from one ``numpy_init((G_A, G_B, D_A, D_B), 0,
init="gan")``, float32, one QAdam over both generators (b1 0.5, GradBoost
noise off) and Adam on each D at lr 2e-4, the JAX steps jitted
(``frostnet_tpu.gan.models.make_cyclegan_steps``), each iteration
``g_step``, two ``ImagePool.query`` calls, both ``d_step``s:

* one FP32 iteration: every loss and both fakes within 1e-5 relative
  (measured 4.3e-7; the fakes 2.0e-6), the generators' BN statistics within 1e-5;
* ``set_warmup(False)`` and one QAT iteration: losses within
  ``QAT_LOSS_REL``, observers within ``QAT_OBS_REL`` of their range;
* hazards 3 (D's statistics, real then fake), 4 (each generator's state
  after its second apply) and 5 (one optimizer over both generators, in the
  JAX tree order), each pinned by name.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port import few_threads, jax_variables  # noqa: F401 - a fixture
from frostnet_tpu import optim as jopt
from frostnet_tpu.gan import models as jmodels
from frostnet_tpu.gan import networks as jnet
from frostnet_tpu.gan.image_pool import ImagePool as JaxPool
from frostnet_tpu.nn import FP32 as J_FP32, QAT as J_QAT
from frostnet_tpu_torch.gan import networks as tnet
from frostnet_tpu_torch.gan.data import SyntheticPairs
from frostnet_tpu_torch.gan.image_pool import ImagePool
from frostnet_tpu_torch.gan.models import (make_cyclegan_steps, make_joint_optimizer,
                                           make_net_state, tree_ordered_parameters)
from frostnet_tpu_torch.nn import FP32, QAT
from frostnet_tpu_torch.optim import get_optimizer, set_warmup
from frostnet_tpu_torch.quant import from_jax_variables, model_variables, numpy_init
from frostnet_tpu_torch.quant.export import flatten_variables

pytestmark = pytest.mark.usefixtures("few_threads")
NGF, NDF, BLOCKS, SIZE, LR = 8, 8, 2, 32, 2e-4
REL = 1e-5
# the QAT iteration against JAX (the port on 1, 2 and 8 CPU threads):
# losses measured 0.35% apart at worst, observers 1.9% of their range
QAT_LOSS_REL = 0.02
QAT_OBS_REL = 0.1
LOSSES = ("loss_G", "cyc_A", "cyc_B", "loss_D_A", "loss_D_B")


def _nets():
    return (tnet.ResnetGenerator(3, NGF, BLOCKS), tnet.ResnetGenerator(3, NGF, BLOCKS),
            tnet.define_d(NDF, norm="none"), tnet.define_d(NDF, norm="none"))


def _jax_state(tree, tx):
    v = jax_variables(tree)
    return jmodels.NetState(params=v["params"], batch_stats=v.get("batch_stats", {}),
                            quant=v.get("quant", {}), opt_state=tx.init(v["params"]), tx=tx)


def _flat(state):
    return flatten_variables(jax.tree.map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats, "quant": state.quant}))


def _mine(model):
    return {k: v.detach().numpy().copy() for k, v in model_variables(model).items()}


def _port_states(trees):
    nets = _nets()
    gA, gB = (make_net_state(n, None, 0, "cpu", t) for n, t in zip(nets[:2], trees[:2]))
    dA, dB = (make_net_state(n, get_optimizer("Adam", LR, b1=0.5), 0, "cpu", t)
              for n, t in zip(nets[2:], trees[2:]))
    joint = make_joint_optimizer(get_optimizer("QAdam", LR, b1=0.5, noise_decay=1.0),
                                 (gA.model, gB.model))
    return gA, gB, dA, dB, joint


@pytest.fixture(scope="module")
def runs():
    trees = numpy_init(_nets(), 0, init="gan")
    gA, gB, dA, dB, joint = _port_states(trees)
    g_tx = jopt.qadam(LR, b1=0.5, noise_decay=1.0)
    jA, jB = (_jax_state(t, g_tx) for t in trees[:2])
    jdA, jdB = (_jax_state(t, jopt.adam(LR, b1=0.5)) for t in trees[2:])
    jjoint = g_tx.init((jA.params, jB.params))
    jnets = (jnet.ResnetGenerator(3, NGF, BLOCKS), jnet.ResnetGenerator(3, NGF, BLOCKS),
             jnet.define_d(NDF, norm="none"), jnet.define_d(NDF, norm="none"))
    pools = (ImagePool(50, 0), ImagePool(50, 1), JaxPool(50, 0), JaxPool(50, 1))
    port, ref = [], []
    for k, (batch, mode, jmode) in enumerate(zip(SyntheticPairs(SIZE, 2, 1, seed=0),
                                                 (FP32, QAT), (J_FP32, J_QAT))):
        if k == 1:
            set_warmup(joint, False)
            jjoint = jopt.set_warmup(jjoint, False)
        g_step, d_step = make_cyclegan_steps(mode)
        fake_a, fake_b, m = g_step(gA, gB, dA, dB, batch, joint)
        m["loss_D_A"] = d_step(dA, batch["B"], pools[1].query(fake_b.numpy()))
        m["loss_D_B"] = d_step(dB, batch["A"], pools[0].query(fake_a.numpy()))
        port.append(({n: float(v) for n, v in m.items()}, fake_a.numpy(), fake_b.numpy(),
                     _mine(gA.model), _mine(gB.model)))
        jg_step, jd_step = jmodels.make_cyclegan_steps(*jnets, jmode)
        jb = {n: jnp.asarray(v) for n, v in batch.items()}
        jA, jB, jjoint, jfa, jfb, jm = jg_step(jA, jB, jdA, jdB, jb, jjoint)
        jdA, lda = jd_step(jdA, jb["B"], jnp.asarray(pools[3].query(np.asarray(jfb))))
        jdB, ldb = jd_step(jdB, jb["A"], jnp.asarray(pools[2].query(np.asarray(jfa))))
        jm = {n: float(v) for n, v in jm.items()}
        jm.update(loss_D_A=float(lda), loss_D_B=float(ldb))
        ref.append((jm, np.asarray(jfa), np.asarray(jfb), _flat(jA), _flat(jB)))
    return {"port": port, "jax": ref, "trees": trees}


def _rel(got, want):
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


def test_fp32_iteration_matches_jax(runs):
    (pm, pfa, pfb, pa, pb), (jm, jfa, jfb, ja, jb) = runs["port"][0], runs["jax"][0]
    for k in LOSSES:
        assert abs(pm[k] / jm[k] - 1) <= REL, (k, pm[k], jm[k])
    assert _rel(pfa, jfa) <= REL and _rel(pfb, jfb) <= REL
    for mine, want in ((pa, ja), (pb, jb)):
        for k in (k for k in want if k.startswith("batch_stats/")):
            np.testing.assert_allclose(mine[k], want[k], rtol=REL, atol=1e-7, err_msg=k)


def test_qat_iteration_in_bands(runs):
    (pm, _, _, pa, pb), (jm, _, _, ja, jb) = runs["port"][1], runs["jax"][1]
    for k in LOSSES:
        assert abs(pm[k] / jm[k] - 1) <= QAT_LOSS_REL, (k, pm[k], jm[k])
    for mine, want in ((pa, ja), (pb, jb)):
        keys = [k for k in want if k.endswith(".min_val")]
        assert keys
        for k in keys:
            hi = k[:-len(".min_val")] + ".max_val"
            span = float(want[hi] - want[k])
            err = max(abs(float(mine[k] - want[k])), abs(float(mine[hi] - want[hi]))) / span
            assert err <= QAT_OBS_REL, (k, err)


def test_hazard4_each_generator_keeps_its_second_apply_state(runs):
    """After ``g_step`` G_A holds the state of its second apply (``rec_b``),
    JAX's ``updA2``, not that of the identity pass that reads it: one more
    train forward of G_A on real_B from the kept state moves the BN
    statistics (FP32) and, in QAT, the observers."""
    for k, mode in enumerate((FP32, QAT)):
        _, _, _, pa, _ = runs["port"][k]
        _, _, _, ja, _ = runs["jax"][k]
        net = tnet.ResnetGenerator(3, NGF, BLOCKS)
        from_jax_variables(net, _tree(pa))
        batch = next(iter(SyntheticPairs(SIZE, 2, 1, seed=0))) if k == 0 else \
            list(SyntheticPairs(SIZE, 2, 1, seed=0))[1]
        with torch.no_grad():
            net(torch.as_tensor(batch["B"]), mode, train=True)  # the identity pass
        idt = _mine(net)
        moved = [k2 for k2 in ja if not k2.startswith("params/") and np.isfinite(pa[k2]).all()
                 and np.abs(idt[k2] - pa[k2]).max() > 1e-3 * max(np.abs(pa[k2]).max(), 1e-3)]
        assert moved, "the identity pass would have moved the state"
        if mode is FP32:
            for k2 in (k2 for k2 in ja if k2.startswith("batch_stats/")):
                np.testing.assert_allclose(pa[k2], ja[k2], rtol=REL, atol=1e-7, err_msg=k2)


def _tree(flat):
    from frostnet_tpu_torch.quant.export import unflatten_variables

    return unflatten_variables(flat)


def test_hazard3_cyclegan_d_statistics_step_real_then_fake():
    """CycleGAN's ``d_step`` steps D's statistics on the real batch, then on
    the fake (JAX's order; pix2pix's is the other), for D with BN."""
    d = tnet.define_d(NDF, norm="batch")
    tree = numpy_init(d, 3, init="gan")
    state = make_net_state(d, get_optimizer("Adam", LR, b1=0.5), 0, "cpu", tree)
    jd = jnet.define_d(NDF, norm="batch")
    js = _jax_state(tree, jopt.adam(LR, b1=0.5))
    rng = np.random.RandomState(1)
    real, fake = (rng.randn(1, SIZE, SIZE, 3).astype(np.float32) for _ in range(2))
    _, d_step = make_cyclegan_steps(FP32)
    loss = d_step(state, real, fake)
    _, jd_step = jmodels.make_cyclegan_steps(None, None, jd, jd, J_FP32)
    js, jloss = jd_step(js, jnp.asarray(real), jnp.asarray(fake))
    assert abs(float(loss) / float(jloss) - 1) <= REL
    mine, want = _mine(d), _flat(js)
    for k in (k for k in want if k.startswith("batch_stats/")):
        np.testing.assert_allclose(mine[k], want[k], rtol=REL, atol=1e-7, err_msg=k)
    other = tnet.define_d(NDF, norm="batch")
    from_jax_variables(other, tree)
    with torch.no_grad():
        other(torch.as_tensor(fake), train=True)
        other(torch.as_tensor(real), train=True)
    swapped = _mine(other)
    assert any(np.abs(swapped[k] - want[k]).max() > 1e-4 for k in want
               if k.startswith("batch_stats/") and k.endswith("/mean"))


def test_hazard5_one_qadam_over_both_generators_in_tree_order(monkeypatch):
    """The joint optimizer's flat vector is G_A's parameters then G_B's, each
    in the JAX tree order: with the same gradients and the same injected
    GradBoost draws (after ``set_warmup(False)``) every parameter equals the
    JAX ``qadam`` update of the ``(params_A, params_B)`` tree bit for bit."""
    nets = (tnet.ResnetGenerator(3, 4, 1), tnet.ResnetGenerator(3, 4, 1))
    trees = numpy_init(nets, 5, init="gan")
    for n, t in zip(nets, trees):
        from_jax_variables(n, t)
    joint = make_joint_optimizer(get_optimizer("QAdam", LR, b1=0.5, noise_decay=0.3), nets)
    params = [p for n in nets for p in tree_ordered_parameters(n)]
    assert len(joint.param_groups) == 1 and joint.param_groups[0]["params"] == params
    tx = jopt.qadam(LR, b1=0.5, noise_decay=0.3)
    jparams = tuple(jax_variables(t)["params"] for t in trees)
    jstate = tx.init(jparams)
    leaves = jax.tree.leaves(jparams)
    assert [tuple(p.shape) for p in params] == [tuple(x.shape) for x in leaves]
    draw = {}
    monkeypatch.setattr(jax.random, "laplace",
                        lambda key, shape, dtype=jnp.float32: next(draw["lap"]))
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p=0.5, shape=None: next(draw["coin"]))

    @jax.jit
    def update(ps, st, gs, laps, coins):  # the draws as runtime values, as in a step
        draw["lap"], draw["coin"] = iter(laps), iter(coins)
        u, st = tx.update(gs, st, ps)
        return optax.apply_updates(ps, u), st

    rng = np.random.RandomState(0)
    for step in range(3):
        grads = [(rng.randn(*x.shape) * rng.choice([1e-3, 0.1])).astype(np.float32)
                 for x in leaves]
        lap = [np.abs(rng.laplace(size=x.shape)).astype(np.float32) for x in leaves]
        coin = [rng.rand(*x.shape) < 0.5 for x in leaves]
        jparams, jstate = update(jparams, jstate, jax.tree.unflatten(
            jax.tree.structure(jparams), [jnp.asarray(g) for g in grads]), lap, coin)
        joint.noise_draws = lambda ps: ([torch.as_tensor(v) for v in lap],
                                        [torch.as_tensor(v.astype(np.float32)) for v in coin])
        for p, g in zip(params, grads):
            p.grad = torch.as_tensor(g)
        joint.step()
        for p, want in zip(params, jax.tree.leaves(jparams)):
            # a misplaced leaf would move by lr (2e-4); XLA contracts a few
            # of the Adam chain's products otherwise over the whole
            # generator tree than over one tree (0.5% of one leaf's elements
            # one rounding apart, 4.2e-7 relative, measured)
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(want), rtol=1e-6,
                                       atol=1e-12, err_msg=str(step))
        if step == 0:
            set_warmup(joint, False)
            jstate = jopt.set_warmup(jstate, False)
