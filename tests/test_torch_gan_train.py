"""PyTorch port, pix2pix training against the JAX package, and the GAN CLIs.

Small nets (a two-block ``ResnetGenerator`` at ngf 8, the ``basic``
PatchGAN at ndf 8 with BN, 32x32 ``SyntheticPairs``, batch 1), both
packages from one ``numpy_init((G, D), 0, init="gan")``, float32, QAdam (b1
0.5, GradBoost noise off) on G and Adam on D at lr 2e-4, the JAX steps
jitted (``frostnet_tpu.gan.models.make_pix2pix_steps``):

* one FP32 iteration (``d_step``, then ``g_step``): every loss within 1e-5
  relative (measured 4.1e-7), BN statistics of G and D within 1e-5;
* ``set_warmup(False)`` and two QAT iterations: losses within
  ``QAT_LOSS_REL`` and G's observers within ``QAT_OBS_REL`` of their range
  (QAT at random init is chaotic between the packages: one grid moved by an
  ulp at an observed extreme moves a block's codes);
* hazards 1-3 of the JAX steps, each pinned by name;
* the linear lr schedule, 0 ulp at every count;
* ``gan.train.main`` resumed with ``--continue_train`` bit-identical to an
  uninterrupted run (losses, every variable, every optimizer state);
* ``gan.test.main``'s export equal to JAX ``export_int8`` of the same
  variables, its gallery, and ``serve.main --workload gan`` on that
  artifact bit-equal to the tester's in-process ``freeze``.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import few_threads, jax_variables  # noqa: F401 - a fixture
from frostnet_tpu import optim as jopt
from frostnet_tpu.gan import models as jmodels
from frostnet_tpu.gan import networks as jnet
from frostnet_tpu.nn import FP32 as J_FP32, QAT as J_QAT
from frostnet_tpu_torch.gan import networks as tnet
from frostnet_tpu_torch.gan import test as gan_test
from frostnet_tpu_torch.gan import train as gan_train
from frostnet_tpu_torch.gan.data import SyntheticPairs
from frostnet_tpu_torch.gan.models import (discarded_updates, make_net_state,
                                           make_pix2pix_steps)
from frostnet_tpu_torch.nn import FP32, QAT
from frostnet_tpu_torch.optim import get_optimizer, set_warmup
from frostnet_tpu_torch.quant import model_variables, numpy_init
from frostnet_tpu_torch.quant.export import flatten_variables

pytestmark = pytest.mark.usefixtures("few_threads")
NGF, NDF, BLOCKS, SIZE, LR = 8, 8, 2, 32, 2e-4
REL = 1e-5
# QAT iterations against JAX: losses measured 0.86% apart at worst (the
# port on 1, 2 and 8 CPU threads), observers 0.40% of their range
QAT_LOSS_REL = 0.02
QAT_OBS_REL = 0.05
LOSSES = ("loss_D", "loss_G", "loss_G_GAN", "loss_G_L1")


def _nets():
    return tnet.ResnetGenerator(3, NGF, BLOCKS), tnet.define_d(NDF, input_nc=6)


def _port_states(trees, g_tx=None):
    g, d = _nets()
    g_tx = g_tx or get_optimizer("QAdam", LR, b1=0.5, noise_decay=1.0)
    return (make_net_state(g, g_tx, 0, "cpu", trees[0]),
            make_net_state(d, get_optimizer("Adam", LR, b1=0.5), 0, "cpu", trees[1]))


def _jax_state(tree, tx):
    v = jax_variables(tree)
    return jmodels.NetState(params=v["params"], batch_stats=v.get("batch_stats", {}),
                            quant=v.get("quant", {}), opt_state=tx.init(v["params"]), tx=tx)


def _flat(state):
    return flatten_variables(jax.tree.map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats, "quant": state.quant}))


def _mine(state):
    return {k: v.detach().numpy().copy() for k, v in model_variables(state.model).items()}


def _batches(n=3):
    return list(SyntheticPairs(SIZE, n, 1, seed=0))


@pytest.fixture(scope="module")
def runs():
    """Both packages through FP32, set_warmup(False), QAT, QAT: per
    iteration the metrics and G's and D's variables after it."""
    g0, d0 = _nets()
    trees = numpy_init((g0, d0), 0, init="gan")
    g, d = _port_states(trees)
    jg = _jax_state(trees[0], jopt.qadam(LR, b1=0.5, noise_decay=1.0))
    jd = _jax_state(trees[1], jopt.adam(LR, b1=0.5))
    jgen, jdis = jnet.ResnetGenerator(3, NGF, BLOCKS), jnet.define_d(NDF)
    port, ref = [], []
    for k, (batch, mode, jmode) in enumerate(zip(_batches(), (FP32, QAT, QAT),
                                                 (J_FP32, J_QAT, J_QAT))):
        if k == 1:
            set_warmup(g.optimizer, False)
            jg = jg.replace(opt_state=jopt.set_warmup(jg.opt_state, False))
        d_step, g_step = make_pix2pix_steps(mode)
        jd_step, jg_step = jmodels.make_pix2pix_steps(jgen, jdis, jmode)
        m = d_step(g, d, batch)
        m.update(g_step(g, d, batch))
        port.append(({k2: float(v) for k2, v in m.items()}, _mine(g), _mine(d)))
        jb = {k2: jnp.asarray(v) for k2, v in batch.items()}
        jd, md = jd_step(jg, jd, jb)
        jg, mg = jg_step(jg, jd, jb)
        ref.append(({k2: float(v) for k2, v in {**md, **mg}.items()}, _flat(jg), _flat(jd)))
    return {"port": port, "jax": ref, "trees": trees}


def test_fp32_iteration_matches_jax(runs):
    (pm, pg, pd), (jm, jg, jd) = runs["port"][0], runs["jax"][0]
    for k in LOSSES:
        assert abs(pm[k] / jm[k] - 1) <= REL, (k, pm[k], jm[k])
    for mine, want in ((pg, jg), (pd, jd)):
        for k in (k for k in want if k.startswith("batch_stats/")):
            np.testing.assert_allclose(mine[k], want[k], rtol=REL, atol=1e-7, err_msg=k)
        for k in (k for k in want if k.startswith("quant/")):  # FP32 observes nothing
            np.testing.assert_array_equal(mine[k], want[k], err_msg=k)
        for k in (k for k in want if k.startswith("params/")):
            # Adam's first step moves each weight by about lr; where a
            # gradient is ~0 its sign may differ between the packages
            assert np.abs(mine[k] - want[k]).max() <= 2.5 * LR, k
            assert np.median(np.abs(mine[k] - want[k])) <= 1e-7, k


def test_qat_iterations_in_bands(runs):
    for (pm, pg, _), (jm, jg, _) in zip(runs["port"][1:], runs["jax"][1:]):
        for k in LOSSES:
            assert abs(pm[k] / jm[k] - 1) <= QAT_LOSS_REL, (k, pm[k], jm[k])
        for k in (k for k in jg if k.endswith(".min_val")):
            hi = k[:-len(".min_val")] + ".max_val"
            span = float(jg[hi] - jg[k])
            err = max(abs(float(pg[k] - jg[k])), abs(float(pg[hi] - jg[hi]))) / span
            assert err <= QAT_OBS_REL, (k, err)


def _buffers(model):
    return [b.detach().clone() for b in model.buffers()]


def test_hazard1_d_step_runs_g_in_train_mode_and_drops_its_updates(runs):
    """pix2pix ``d_step`` runs G in train mode (batch statistics, observers
    stepped for that forward: the FP32 ``loss_D`` equals JAX's, and an eval
    G would give another), takes no gradient through G, and keeps none of
    G's updates: its BN statistics and observers are the same after."""
    g, d = _port_states(runs["trees"])
    batch = _batches(1)[0]
    for mode in (FP32, QAT):
        before = _buffers(g.model)
        d_step, _ = make_pix2pix_steps(mode)
        d_step(g, d, batch)
        for b, a in zip(before, g.model.buffers()):
            assert torch.equal(b, a)
        assert all(p.grad is None for p in g.model.parameters())
    # the FP32 loss_D of a fresh pair is JAX's (runs), and not that of an eval-mode G
    g, d = _port_states(runs["trees"])
    a, b = (torch.as_tensor(v) for v in (batch["A"], batch["B"]))
    with torch.no_grad():
        fake = g.model(a, FP32)
    loss = 0.5 * (tnet.gan_loss(d.model(torch.cat([a, fake], -1), train=True), False)
                  + tnet.gan_loss(d.model(torch.cat([a, b], -1), train=True), True))
    assert abs(float(loss) / runs["jax"][0][0]["loss_D"] - 1) > 1e-3


def test_hazard2_d_runs_in_eval_mode_inside_g_step(runs):
    """``g_step`` reads D in eval mode: running statistics, no BN update, no
    gradient into D; the FP32 loss_G_GAN equals JAX's and differs from a
    train-mode D's."""
    g, d = _port_states(runs["trees"])
    batch = _batches(1)[0]
    d_step, g_step = make_pix2pix_steps(FP32)
    d_step(g, d, batch)  # D's running statistics move off their init
    before = _buffers(d.model)
    with discarded_updates(g.model):
        a = torch.as_tensor(batch["A"])
        with torch.no_grad():
            fake = g.model(a, FP32, train=True)
            train_mode = float(tnet.gan_loss(d.model(torch.cat([a, fake], -1), train=True),
                                             True))
    for b, x in zip(before, d.model.buffers()):
        x.copy_(b)  # undo the train-mode forward's BN step
    grads = [p.grad.clone() for p in d.model.parameters()]  # d_step's own
    m = g_step(g, d, batch)
    for b, x in zip(before, d.model.buffers()):
        assert torch.equal(b, x)
    assert all(torch.equal(p.grad, w) for p, w in zip(d.model.parameters(), grads))
    assert abs(float(m["loss_G_GAN"]) / runs["jax"][0][0]["loss_G_GAN"] - 1) <= REL
    assert abs(train_mode / float(m["loss_G_GAN"]) - 1) > 1e-3


def test_hazard3_d_statistics_step_fake_then_real(runs):
    """D's BN statistics after ``d_step`` are JAX's (fake, then real); the
    other order gives others."""
    _, pg, pd = runs["port"][0]
    _, _, jd = runs["jax"][0]
    g, d = _port_states(runs["trees"])
    batch = _batches(1)[0]
    a, b = (torch.as_tensor(v) for v in (batch["A"], batch["B"]))
    with torch.no_grad(), discarded_updates(g.model):
        fake = g.model(a, FP32, train=True)
        d.model(torch.cat([a, b], -1), train=True)
        d.model(torch.cat([a, fake], -1), train=True)
    swapped = _mine(d)
    keys = [k for k in jd if k.startswith("batch_stats/") and k.endswith("/mean")]
    assert keys
    for k in keys:
        np.testing.assert_allclose(pd[k], jd[k], rtol=REL, atol=1e-7, err_msg=k)
    assert any(np.abs(swapped[k] - jd[k]).max() > 1e-4 for k in keys)


@pytest.mark.parametrize("decay,epochs,fp,spe", [(0, 2, 1, 3), (7, 3, 1, 5), (100, 2, 2, 4),
                                                 (3, 1, 0, 1)])
def test_gan_lr_schedule_zero_ulp(decay, epochs, fp, spe):
    from frostnet_tpu.gan.train import GANConfig as JaxConfig
    from frostnet_tpu.gan.train import _gan_lr_schedule as jax_schedule

    kw = dict(lr=2e-4, epochs=epochs, fp_epochs=fp, n_epochs_decay=decay)
    mine = gan_train._gan_lr_schedule(gan_train.GANConfig(**kw), spe)
    want = jax_schedule(JaxConfig(**kw), spe)
    if decay == 0:
        assert mine == want == 2e-4
        return
    counts = np.arange((fp + epochs + decay + 2) * spe, dtype=np.int32)
    got = np.asarray([mine(int(c)) for c in counts], np.float32)
    ref = np.asarray(jax.jit(jax.vmap(want))(jnp.asarray(counts)), np.float32)
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    assert got[0] == np.float32(2e-4) and got[-1] == 0


def _cfg(tmp_path, **kw):
    base = dict(model="pix2pix", netG="resnet_6blocks", ngf=NGF, ndf=NDF, crop_size=SIZE,
                steps_per_epoch=2, fp_epochs=1, epochs=2, save_epoch_freq=1, device="cpu",
                save_dir=str(tmp_path))
    base.update(kw)
    return gan_train.GANConfig(**base)


def _state_arrays(state):
    out = _mine(state)
    for i, (k, v) in enumerate(state.optimizer.state.items()):
        for n, t in v.items():
            if isinstance(t, torch.Tensor):
                out[f"opt/{i}/{n}"] = t.detach().numpy().copy()
    return out


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``gan.train.main`` (pix2pix, GradBoost noise on): one run of 2 QAT
    epochs, and one stopped after 1 and resumed with ``--continue_train``."""
    root = tmp_path_factory.mktemp("gan_train")
    whole = gan_train.main(_cfg(root / "whole"))
    first = gan_train.main(_cfg(root / "split", epochs=1))
    resumed = gan_train.main(_cfg(root / "split", epochs=2, continue_train=True))
    return {"root": root, "whole": whole, "first": first, "resumed": resumed}


def test_pix2pix_resume_bit_identical(trained):
    (gw,), (dw,), rw = trained["whole"]
    _, _, r1 = trained["first"]
    (gr,), (dr,), r2 = trained["resumed"]
    assert [h["tag"] for h in rw["history"]] == ["fp_warmup", "qat", "qat"]
    assert [(h["tag"], h["epoch"]) for h in r2["history"]] == [("qat", 1)]
    assert [h["losses"] for h in r1["history"] + r2["history"]] == \
        [h["losses"] for h in rw["history"]]
    assert set(rw["history"][-1]["losses"]) == {"loss_D", "loss_G", "loss_G_GAN", "loss_G_L1"}
    for a, b in ((gw, gr), (dw, dr)):
        x, y = _state_arrays(a), _state_arrays(b)
        assert sorted(x) == sorted(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    assert gr.optimizer.generator is not None  # the noise phase's generator, restored
    with open(trained["root"] / "split" / "gan_meta.json") as f:
        assert json.load(f) == {"qat_epoch": 2}
    assert os.path.exists(trained["root"] / "split" / "metrics.jsonl")


def test_tester_export_equals_jax_and_serves_bit_equal(trained, tmp_path):
    """``gan.test.main`` on the trained ``latest_G``: its artifact equals JAX
    ``export_int8`` of the same variables, the gallery is written, and
    ``serve.main --workload gan`` on the artifact equals the in-process
    ``freeze`` of the restored generator bit for bit."""
    from frostnet_tpu.quant import export_int8 as jax_export_int8
    from frostnet_tpu_torch import serve
    from frostnet_tpu_torch.quant import freeze

    ckpt = str(trained["root"] / "whole" / "latest_G")
    art = str(tmp_path / "netG_int8.npz")
    out = gan_test.main(gan_test.build_parser().parse_args(
        ["--checkpoint", ckpt, "--netG", "resnet_6blocks", "--ngf", str(NGF), "--crop_size",
         str(SIZE), "--num_test", "2", "--results_dir", str(tmp_path / "res"),
         "--export_int8", art, "--device", "cpu"]))
    assert len(out["int8"]) == 2 and all(np.isfinite(o).all() for o in out["int8"])
    assert max(out["delta"]) < 0.5 and out["artifact_bytes"] > 0
    web = tmp_path / "res" / "web"
    assert os.path.exists(web / "index.html")
    assert sorted(os.listdir(web / "images")) == sorted(
        f"img{i:04d}_{n}.png" for i in range(2)
        for n in ("real_A", "fake_B_qat", "fake_B_int8", "real_B"))
    (g,), _, _ = trained["whole"]
    want = str(tmp_path / "jax_int8.npz")
    jax_export_int8(jax_variables({k: v for k, v in _jax_tree(g.model).items()}), want)
    with np.load(art) as a, np.load(want) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            if k != "__meta__":
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    logits = str(tmp_path / "served.npy")
    serve.main(serve.build_parser().parse_args(
        ["--workload", "gan", "--model", "resnet_6blocks", "--ngf", str(NGF), "--artifact", art,
         "--image_size", str(SIZE), "--batch_size", "2", "--iters", "1", "--device", "cpu",
         "--save_logits", logits]))
    net = tnet.define_g(ngf=NGF, netG="resnet_6blocks")
    from frostnet_tpu_torch.utils.checkpoint import restore_model_variables
    restore_model_variables(ckpt, make_net_state(net, None, 0, "cpu"))
    x = np.random.RandomState(0).randn(2, SIZE, SIZE, 3).astype(np.float32)
    np.testing.assert_array_equal(np.load(logits), freeze(net, "cpu", SIZE)(x).numpy())


def _jax_tree(model):
    from frostnet_tpu_torch.quant.export import unflatten_variables

    return unflatten_variables({k: v.detach().numpy() for k, v in model_variables(model).items()})


def test_cycle_gan_cli_and_errors(tmp_path):
    gan_train.cli(["--model", "cycle_gan", "--netG", "resnet_6blocks", "--ngf", "4", "--ndf",
                   "4", "--crop_size", "32", "--steps_per_epoch", "1", "--fp_epochs", "1",
                   "--epochs", "1", "--pool_size", "2", "--device", "cpu", "--save_dir",
                   str(tmp_path)])
    for name in ("latest_G_A", "latest_G_B", "latest_D_A", "latest_D_B", "latest_opt_G"):
        assert os.path.exists(tmp_path / name / "state.pt"), name
    with pytest.raises(ValueError, match="unknown model"):
        gan_train.main(gan_train.GANConfig(model="unit", device="cpu",
                                           save_dir=str(tmp_path / "x")))
