"""Data parallelism of the segmentation, detection and GAN trainers and of
the segmentation evaluator (``parallel/``).

* A 2-rank gloo run on the CPU (a FileStore, one process a rank; the
  settings of ``_torch_port.TRAINER_RUNS``: one FP32 and one QAT step each)
  of ``segmentation.train.main``, ``detection.train.main`` and
  ``gan.train.main`` (pix2pix and CycleGAN at batch 2, and pix2pix at batch
  1, where JAX's mesh takes one device), then ``segmentation.evaluate.main``
  on the seg run's checkpoint. The ranks end bit-identical; rank 0 alone
  writes (the save directory holds what the one-process run's does, its
  log a line a record); the run stays within the bands of
  ``chip_smoke.py`` (those ``test_torch_seg_train`` holds the one-process
  step to against JAX's) of the one-process trainer on the same global
  batches; the idle rank of batch 1 writes nothing and the other runs the
  one-process run bit for bit; the evaluator's dual mIoU and confusion
  matrix equal the one-process evaluation's bit for bit. Rank 0's run is
  also held against JAX's jitted single-device steps on the same global
  batches from the same variables (``_torch_port.jax_trainer_steps``), in
  the bands the trainer's own tests hold its one-process step to against
  JAX (``test_torch_{seg,det}_train``: chip_smoke's; ``test_torch_gan_train``
  and ``test_torch_gan_cyclegan``: theirs).
* The global normalizers, on two replicas in two threads: a seg batch
  whose rows hold different counts of ignored pixels and a detection batch
  whose rows hold different counts of positives give the one-process
  gradient (the mean over the ranks) to float-sum order, and the mean of
  the ranks' own means misses it.
* The CycleGAN pool over two replicas returns JAX's pool's answer for the
  global batch, query after query.
* The GAN steps with ``gan_mode="wgangp"`` under a mesh take no double
  backward (no gradient penalty), and ``GlobalBatchNorm`` refuses one.
"""
import dataclasses
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
from torch.distributed import ReduceOp

from _torch_port import TRAINER_RUNS, run_trainer, seg_eval_args
from chip_smoke import (BN_MEAN_MEDIAN, BN_VAR_MEDIAN, FP32_LOSS_REL, OBS_MEDIAN, OBS_WORST,
                        QAT_LOSS_REL)
from frostnet_tpu.gan.image_pool import ImagePool as JaxImagePool
from frostnet_tpu_torch.detection.anchors import CONFIGS, make_priors
from frostnet_tpu_torch.detection.train import multibox_step_loss
from frostnet_tpu_torch.gan import define_d, define_g, image_pool
from frostnet_tpu_torch.gan.models import make_net_state, make_pix2pix_steps
from frostnet_tpu_torch.gan.train import pooled
from frostnet_tpu_torch.nn import FP32
from frostnet_tpu_torch.nn.conv import GlobalBatchNorm
from frostnet_tpu_torch.optim import get_optimizer
from frostnet_tpu_torch.parallel import Mesh, shard_rows
from frostnet_tpu_torch.segmentation.data import CITYSCAPES_CLASS_WEIGHTS
from frostnet_tpu_torch.segmentation.train import seg_loss, seg_step_loss

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
RUNS = ("seg", "det", "pix2pix", "cyclegan")
GRAD_REL = 1e-6  # the two-rank gradient against one process: float-sum order


@pytest.fixture(scope="module")
def trainer_procs(tmp_path_factory):
    """Start the two ranks and, beside them, a process a trainer of
    ``RUNS`` for its one-process run and JAX's steps on its global batches
    (subprocesses); ``trainer_run`` collects them."""
    tmp = tmp_path_factory.mktemp("trainers")
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    head = (f"import sys; sys.path[:0] = [{os.path.join(ROOT, 'tests')!r}, {ROOT!r}]; "
            "from _torch_port import trainer_reference_worker, trainer_worker; ")
    calls = [f"trainer_worker({r}, {WORLD}, {str(tmp / 'store')!r}, {str(tmp / 'dp')!r})"
             for r in range(WORLD)]
    calls += [f"trainer_reference_worker({kind!r}, {str(tmp)!r})" for kind in RUNS]
    procs = [subprocess.Popen([sys.executable, "-c", head + call], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for call in calls]
    yield tmp, procs
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def trainer_run(trainer_procs):
    """The ranks' records, the one-process runs of the same trainers (one
    thread, as each rank has) and JAX's steps on their global batches."""
    tmp, procs = trainer_procs
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = {kind: run_trainer(kind, str(tmp / "one" / kind))
               for kind in TRAINER_RUNS if kind not in RUNS}
    finally:
        torch.set_num_threads(threads)
    logs = []
    for p in procs:
        out, _ = p.communicate(timeout=900)
        logs.append(out)
        assert p.returncode == 0, out[-6000:]
    one.update({kind: dict(np.load(tmp / f"one-{kind}.npz")) for kind in RUNS})
    jax_runs = {kind: dict(np.load(tmp / f"jax-{kind}.npz")) for kind in RUNS}
    from frostnet_tpu_torch.segmentation import evaluate

    seg_eval = evaluate.main(seg_eval_args(str(tmp / "dp" / "seg")))
    ranks = {kind: [dict(np.load(tmp / "dp" / f"{kind}-{r}.npz"))
                    if (tmp / "dp" / f"{kind}-{r}.npz").exists() else None
                    for r in range(WORLD)] for kind in TRAINER_RUNS}
    evals = [dict(np.load(tmp / "dp" / f"seg_eval-{r}.npz")) for r in range(WORLD)]
    return dict(tmp=tmp, one=one, jax=jax_runs, ranks=ranks, logs=logs[:WORLD],
                seg_eval=seg_eval, evals=evals)


@pytest.mark.parametrize("kind", RUNS)
def test_trainer_ranks_bit_identical(trainer_run, kind):
    a, b = trainer_run["ranks"][kind]
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("kind", RUNS)
def test_trainer_writes_from_rank_zero(trainer_run, kind):
    """The save directory holds what the one-process run's does, and the
    metric log as many records: one rank wrote them."""
    tmp = trainer_run["tmp"]
    dp, one = tmp / "dp" / kind, tmp / "one" / kind
    assert sorted(os.listdir(dp)) == sorted(os.listdir(one))
    logs = [d / "metrics.jsonl" for d in (dp, one)]
    lines = [len(f.read_text().splitlines()) for f in logs]
    assert lines[0] == lines[1] > 0, lines


def _band_report(mine, ref):
    """(observer |diff| / range, BN |d mean| / std, |d var| / var) over
    every observer and BN of the runs' variables."""
    obs, means, variances = [], [], []
    for k in ref:
        if k.endswith(".min_val") and np.isfinite(ref[k]).all():
            hi = k.replace(".min_val", ".max_val")
            span = max(float(np.max(ref[hi] - ref[k])), 1e-6)
            obs.append(max(float(np.max(np.abs(mine[k] - ref[k]))),
                           float(np.max(np.abs(mine[hi] - ref[hi])))) / span)
        elif k.endswith("/mean"):
            var = ref[k[:-len("mean")] + "var"]
            means.append(float(np.max(np.abs(mine[k] - ref[k]) / np.sqrt(var))))
        elif k.endswith("/var"):
            variances.append(float(np.max(np.abs(mine[k] - ref[k]) / ref[k])))
    return obs, means, variances


@pytest.mark.parametrize("kind", RUNS)
def test_trainer_within_bands_of_one_process(trainer_run, kind):
    """The two ranks against the one-process trainer on the same global
    batches, in chip_smoke's bands: the first (FP32) step's loss, the later
    losses, the observers and the BN statistics."""
    mine, ref = trainer_run["ranks"][kind][0], trainer_run["one"][kind]
    assert sorted(mine) == sorted(ref)
    rel = {k: abs(float(mine[k]) - float(ref[k])) / abs(float(ref[k])) for k in ref
           if k.startswith(("fp32/", "qat/"))}
    # the first step from the same weights in the FP32 band, every later one
    # (carrying the first's float-sum differences) in the QAT band
    assert rel.pop("fp32/0") <= FP32_LOSS_REL and rel and max(rel.values()) <= QAT_LOSS_REL, rel
    obs, means, variances = _band_report(mine, ref)
    if obs:
        assert np.median(obs) <= OBS_MEDIAN and max(obs) <= OBS_WORST, (np.median(obs),
                                                                        max(obs))
    assert means and np.median(means) <= BN_MEAN_MEDIAN, np.median(means)
    assert np.median(variances) <= BN_VAR_MEDIAN, np.median(variances)


def _gan_bands(kind):
    """(FP32 loss, QAT loss, each observer's |diff| / range) of the GAN
    trainer's tests against JAX."""
    import test_torch_gan_cyclegan as cyc
    import test_torch_gan_train as p2p

    mod = p2p if kind == "pix2pix" else cyc
    return mod.REL, mod.QAT_LOSS_REL, mod.QAT_OBS_REL


@pytest.mark.parametrize("kind", RUNS)
def test_trainer_within_bands_of_jax(trainer_run, kind):
    """Rank 0 against JAX's jitted single-device steps on the global
    batches: seg and det in chip_smoke's bands (the first step's loss, the
    later ones, the observers and BN statistics after the run), as
    test_torch_seg_train and test_torch_det_train hold the one-process
    step; the GANs in the bands of their trainer tests (every FP32
    iteration loss, every QAT one, each observer)."""
    mine, ref = trainer_run["ranks"][kind][0], trainer_run["jax"][kind]
    losses = [k for k in ref if k.startswith(("fp32/", "qat/"))]
    assert losses and set(losses) == {k for k in mine if k.startswith(("fp32/", "qat/"))}
    assert set(ref) - set(losses) <= set(mine)
    rel = {k: abs(float(mine[k]) - float(ref[k])) / abs(float(ref[k])) for k in losses}
    if kind in ("seg", "det"):
        assert rel.pop("fp32/0") <= FP32_LOSS_REL and max(rel.values()) <= QAT_LOSS_REL, rel
        obs, means, variances = _band_report(mine, ref)
        assert obs and np.median(obs) <= OBS_MEDIAN and max(obs) <= OBS_WORST, (
            np.median(obs), max(obs))
        assert means and np.median(means) <= BN_MEAN_MEDIAN, np.median(means)
        assert np.median(variances) <= BN_VAR_MEDIAN, np.median(variances)
        return
    fp32_band, qat_band, obs_band = _gan_bands(kind)
    assert max(v for k, v in rel.items() if k.startswith("fp32/")) <= fp32_band, rel
    assert max(v for k, v in rel.items() if k.startswith("qat/")) <= qat_band, rel
    obs, _, _ = _band_report(mine, ref)
    assert obs and max(obs) <= obs_band, max(obs)


def test_gan_batch_one_leaves_a_rank_idle(trainer_run):
    """Batch 1 on two ranks: JAX's mesh takes one device; rank 1 writes
    nothing and waits, rank 0 runs the one-process run bit for bit."""
    r0, r1 = trainer_run["ranks"]["gan_idle"]
    assert r1 is None
    one = trainer_run["one"]["gan_idle"]
    assert sorted(r0) == sorted(one)
    for k in one:
        np.testing.assert_array_equal(r0[k], one[k], err_msg=k)
    assert "mesh {'dp': 1, 'mp': 1}" in trainer_run["logs"][0]


def test_seg_evaluator_on_two_ranks_equals_one(trainer_run):
    want = trainer_run["seg_eval"]
    for rec in trainer_run["evals"]:
        assert float(rec["qat"]) == want["qat"] and float(rec["int8"]) == want["int8"]
        np.testing.assert_array_equal(rec["cm"], want["int8_eval"]["cm"])
    assert want["int8_eval"]["cm"].sum() > 0


# ---------------------------------------------------------------------------
# Two replicas on two threads of this process
# ---------------------------------------------------------------------------

class _Exchange:
    """All-reduce and all-gather between the threads of this process (one a
    replica), in rank order."""

    def __init__(self, n):
        self.slots, self.barrier = [None] * n, threading.Barrier(n)

    def _share(self, rank, t):
        self.slots[rank] = t.detach().clone()
        self.barrier.wait()
        parts = [s.clone() for s in self.slots]
        self.barrier.wait()
        return parts

    def all_reduce(self, rank, t, op):
        parts = self._share(rank, t)
        out = parts[0]
        for v in parts[1:]:
            out = out + v if op == ReduceOp.SUM else torch.maximum(out, v)
        return t.copy_(out)


@dataclasses.dataclass(frozen=True)
class _ThreadMesh(Mesh):
    exchange: object = None

    def all_reduce(self, t, op=ReduceOp.SUM):
        return self.exchange.all_reduce(self.rank, t, op)

    def dp_gather(self, rows):
        return torch.cat(self.exchange._share(self.rank, rows))


def _on_threads(fn, n=WORLD):
    """fn(mesh) on n threads, one replica each; their results in rank order."""
    ex, out, errors = _Exchange(n), [None] * n, []

    def run(r):
        try:
            out[r] = fn(_ThreadMesh(devices=tuple(range(n)), group="threads", rank=r,
                                    exchange=ex))
        except Exception as e:  # surfaced below
            errors.append(e)
            ex.barrier.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    if errors:
        raise errors[0]
    return out


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _seg_batch():
    """Logits and labels whose first two rows hold far more ignored pixels
    than the last two (the ranks' weight sums differ)."""
    rng = np.random.RandomState(5)
    logits = torch.tensor(rng.randn(4, 6, 7, 19).astype(np.float32))
    labels = rng.randint(0, 19, (4, 6, 7))
    labels[:2][rng.rand(2, 6, 7) < 0.8] = 255
    labels[2:][rng.rand(2, 6, 7) < 0.05] = 255
    return logits, torch.tensor(labels.astype(np.int64))


def _det_batch():
    """Predictions and targets whose first two images hold one box each and
    the last two five (the ranks' positives differ)."""
    rng = np.random.RandomState(6)
    priors = torch.as_tensor(make_priors(CONFIGS["voc"]))
    p = priors.shape[0]
    lo = rng.uniform(0.0, 0.5, (4, 5, 2))
    boxes = np.concatenate([lo, lo + rng.uniform(0.2, 0.5, (4, 5, 2))], -1).astype(np.float32)
    valid = np.zeros((4, 5), bool)
    valid[:2, 0] = True
    valid[2:] = True
    labels = rng.randint(0, 20, (4, 5)).astype(np.int64)
    loc = torch.tensor(rng.randn(4, p, 4).astype(np.float32) * 0.5)
    conf = torch.tensor(rng.randn(4, p, 21).astype(np.float32))
    return (loc, conf), (torch.tensor(boxes), torch.tensor(labels), torch.tensor(valid), priors)


def _grads(preds, fn, rows):
    leaves = [t[rows].clone().requires_grad_(True) for t in preds]
    loss, total = fn(leaves)
    loss.backward()
    return [t.grad for t in leaves], total


@pytest.mark.parametrize("kind", ["seg", "det"])
def test_global_normalizer_gives_the_one_process_gradient(kind):
    """The ranks' gradients, averaged as ``all_reduce_gradients`` averages
    them (each rank's block times 1/dp), equal the one-process gradient of
    the global loss; each rank normalizing by its own count (the mean of
    the ranks' means) does not."""
    if kind == "seg":
        preds, target = _seg_batch()
        preds = [preds]
        weights = torch.as_tensor(np.asarray(CITYSCAPES_CLASS_WEIGHTS, np.float32))

        def loss_fn(rows, mesh=None, own=False):
            def f(leaves):
                if own:  # this rank's own weighted mean
                    loss = seg_loss(leaves[0], target[rows], weights, 255, 19)
                    return loss, loss.detach()
                return seg_step_loss(leaves[0], target[rows], weights, 255, 19, "ce", mesh)
            return f
    else:
        preds, target = _det_batch()

        def loss_fn(rows, mesh=None, own=False):
            def f(leaves):
                boxes, labels, valid, priors = target
                out = multibox_step_loss(*leaves, boxes[rows], labels[rows], valid[rows],
                                         priors, None if own else mesh)
                return out[0], out[1]
            return f

    every = slice(0, 4)
    want, want_loss = _grads(preds, loss_fn(every), every)

    def rank(mesh, own=False):
        rows = shard_rows(4, WORLD, mesh.rank)
        return _grads(preds, loss_fn(rows, mesh, own), rows)

    got = _on_threads(rank)
    for i, w in enumerate(want):
        mean = torch.cat([g[0][i] for g in got]) / WORLD
        assert _rel(mean, w) <= GRAD_REL, (kind, _rel(mean, w))
    for _, total in got:
        assert abs(float(total) - float(want_loss.detach())) <= GRAD_REL * abs(float(want_loss.detach()))
    own = _on_threads(lambda mesh: rank(mesh, own=True))
    for i, w in enumerate(want):
        mean = torch.cat([g[0][i] for g in own]) / WORLD
        assert _rel(mean, w) > 100 * GRAD_REL, (kind, "the mean of means should miss")


def test_cyclegan_pool_on_two_ranks_is_jax_pool_on_the_global_batch():
    rng = np.random.RandomState(7)
    batches = [rng.randn(4, 5, 5, 3).astype(np.float32) for _ in range(6)]
    jpool = JaxImagePool(3, seed=11)
    want = [jpool.query(b) for b in batches]

    def rank(mesh):
        pool = image_pool.ImagePool(3, seed=11)
        rows = shard_rows(4, WORLD, mesh.rank)
        return [pooled(pool, torch.as_tensor(b[rows]), mesh) for b in batches]

    got = _on_threads(rank)
    for q, w in enumerate(want):
        np.testing.assert_array_equal(np.concatenate([g[q] for g in got]), w, err_msg=str(q))


def test_wgangp_steps_take_no_double_backward(monkeypatch):
    """pix2pix's steps with ``gan_mode="wgangp"`` under a mesh (its D's BN
    on the global route) run without a gradient penalty; a double backward
    through ``GlobalBatchNorm`` raises rather than differentiating a
    collective it cannot."""
    from frostnet_tpu_torch.gan import networks

    def refuse(*args, **kwargs):
        raise AssertionError("a GAN step took a gradient penalty")

    monkeypatch.setattr(networks, "gradient_penalty", refuse)
    rng = np.random.RandomState(8)
    batch = {k: rng.randn(2, 32, 32, 3).astype(np.float32) for k in ("A", "B")}

    def rank(mesh):
        g = make_net_state(define_g(ngf=4, netG="resnet_6blocks"), get_optimizer("Adam", 2e-4),
                           0, "cpu")
        d = make_net_state(define_d(ndf=4, netD="basic", norm="batch", input_nc=6),
                           get_optimizer("Adam", 2e-4), 0, "cpu")
        d_step, g_step = make_pix2pix_steps(FP32, "wgangp", 100.0, mesh)
        rows = shard_rows(2, WORLD, mesh.rank)
        mine = {k: v[rows] for k, v in batch.items()}
        return float(d_step(g, d, mine)["loss_D"]), float(g_step(g, d, mine)["loss_G"])

    a, b = _on_threads(rank)
    assert a == b and all(np.isfinite(a))
    y = torch.randn(4, 3, 3, 2, requires_grad=True)
    gamma, beta = torch.ones(2, requires_grad=True), torch.zeros(2, requires_grad=True)

    def penalty(mesh):
        out = GlobalBatchNorm.apply(y[shard_rows(4, WORLD, mesh.rank)], gamma, beta,
                                    torch.zeros(2), torch.ones(2), 0.1, 1e-5, mesh)
        (g,) = torch.autograd.grad((out ** 3).sum(), y, create_graph=True)
        with pytest.raises(RuntimeError, match="once_differentiable|differentiate twice"):
            g.sum().backward()
        return True

    assert _on_threads(penalty) == [True, True]


@pytest.mark.parametrize("world", range(1, 5))
def test_dp_mesh_under_a_process_group_equals_jax(world, monkeypatch):
    """``make_dp_mesh`` under a process group of ``world`` ranks (the mesh
    arithmetic; ``dist.new_group`` recorded, no processes) against JAX's
    ``make_dp_mesh`` over as many devices, batches 1-9: the same dp, the
    mesh on the first dp ranks (a group of its own where it is not the
    world), the others idle, each member's rows JAX's shard of its device."""
    import jax

    from frostnet_tpu import parallel as jax_parallel
    from frostnet_tpu_torch.parallel import mesh as pmesh

    monkeypatch.setattr(pmesh.dist, "new_group", lambda ranks, **kw: tuple(ranks))
    for b in range(1, 10):
        jmesh = jax_parallel.make_dp_mesh(b, jax.devices()[:world])
        dp = jmesh.shape["dp"]
        shards = {s.device: s.index[0].indices(b)[:2] for s in
                  jax_parallel.shard_batch({"x": np.arange(b)}, jmesh)["x"].addressable_shards}
        for r in range(world):
            monkeypatch.setattr(pmesh, "_world", lambda r=r: (tuple(range(world)), "WORLD", r))
            mesh = pmesh.make_dp_mesh(b)
            assert mesh.dp == dp and mesh.shape == dict(jmesh.shape), (b, world)
            assert mesh.member == (r < dp) and mesh.end_group == tuple(range(world))
            if not mesh.member:
                assert mesh.group is None
                continue
            assert mesh.group == ("WORLD" if dp == world else tuple(range(dp)))
            rows = shard_rows(b, mesh.dp, mesh.dp_index)
            assert shards[jax.devices()[r]] == (rows.start, rows.stop), (b, world, r)
