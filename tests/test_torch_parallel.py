"""Data parallelism of the port (``frostnet_tpu_torch/parallel``, ``serve --dp``)
against the JAX package and against the port in one process.

* ``make_dp_mesh`` and the row blocks each replica takes equal JAX's
  ``make_dp_mesh`` and ``shard_batch`` for batches 1-9 over 1-8 devices.
* A 2-rank gloo run (a FileStore, no TCP rendezvous) of
  ``frostnet_quant_small_0_35`` at 32x32 on a global batch of 8 through one
  FP32 and one QAT step (``tests/test_torch_train_step.py``'s settings): the
  ranks end bit-identical to each other, and agree with the one-process
  step and with JAX's jitted single-device step on the global batch (what
  GSPMD computes on a dp mesh) within ``test_torch_train_step``'s bands;
  then ``classification.main`` on the two ranks: one checkpoint, from rank
  0, and the all-reduced evaluation equal on both.
* The global-batch BN (forward, running statistics, backward), the
  observers' data-parallel route and dropout's global mask, with two
  replicas in two threads of this process.
* ``serve`` with two replicas on ``[cpu, cpu]``: bit-equal to one.
"""
import dataclasses
import importlib
import os
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch
from torch.distributed import ReduceOp

from _torch_port import train_batch
from frostnet_tpu import parallel as jax_parallel
from frostnet_tpu_torch import serve
from frostnet_tpu_torch.models import create_model
from frostnet_tpu_torch.models.frostnet import dropout
from frostnet_tpu_torch.nn import FP32, QAT
from frostnet_tpu_torch.nn.conv import GlobalBatchNorm
from frostnet_tpu_torch.ops.fake_quant import fake_quant_observe
from frostnet_tpu_torch.optim import get_optimizer, grouped_weight_decay
from frostnet_tpu_torch.parallel import (Mesh, data_parallel, make_dp_mesh, make_mesh,
                                         multihost, shard_rows)
from frostnet_tpu_torch.quant import QNNPACK, export_int8, model_variables, numpy_init
from frostnet_tpu_torch.quant.export import flatten_variables
from frostnet_tpu_torch.train import create_train_state, make_train_step, recalibrate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL, SIZE, BATCH, CLASSES, WORLD = "frostnet_quant_small_0_35", 32, 8, 10, 2
STEPS = ("FP32", "QAT")


@pytest.mark.parametrize("n", range(1, 9))
def test_dp_mesh_and_rows_equal_jax(n, dp_procs):
    devices = jax.devices()[:n]
    for b in range(1, 10):
        jmesh = jax_parallel.make_dp_mesh(b, devices)
        mesh = make_dp_mesh(b, [torch.device("cpu")] * n)
        assert mesh.dp == jmesh.shape["dp"] and mesh.shape == dict(jmesh.shape), (b, n)
        x = jax_parallel.shard_batch({"x": np.arange(b)}, jmesh)["x"]
        order = list(jmesh.devices.reshape(-1))
        for shard in x.addressable_shards:
            i = order.index(shard.device)
            rows = shard_rows(b, mesh.dp, i)
            assert shard.index[0].indices(b)[:2] == (rows.start, rows.stop), (b, n, i)


def test_mesh_refusals_and_multihost_without_a_group(monkeypatch):
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize("cpu") is False and multihost.is_primary()
    assert multihost.local_batch_slice(8) == slice(0, 8)
    assert multihost.local_device("cpu") == torch.device("cpu")
    assert multihost.choose_backend("cpu")[0] == "gloo"
    mesh = make_mesh()
    assert mesh.dp == 1 and not mesh.distributed and mesh.shape == {"dp": 1, "mp": 1}
    with pytest.raises(ValueError, match=r"dp\*mp = 0\*2 != 1"):
        make_mesh(mp=2)  # one process holds no dp x 2 mesh
    with pytest.raises(ValueError, match="does not split"):
        shard_rows(7, 2, 0)


class _Exchange:
    """All-reduce between the threads of this process (one a replica): each
    rank's tensor, reduced in rank order."""

    def __init__(self, n):
        self.slots, self.barrier = [None] * n, threading.Barrier(n)

    def all_reduce(self, rank, t, op):
        self.slots[rank] = t.detach().clone()
        self.barrier.wait()
        out = self.slots[0].clone()
        for v in self.slots[1:]:
            out = out + v if op == ReduceOp.SUM else torch.maximum(out, v)
        self.barrier.wait()
        return t.copy_(out)


@dataclasses.dataclass(frozen=True)
class _ThreadMesh(Mesh):
    exchange: object = None

    def all_reduce(self, t, op=ReduceOp.SUM):
        return self.exchange.all_reduce(self.rank, t, op)


def _on_threads(fn, n=WORLD):
    """fn(mesh) on n threads, one replica each; their results in rank order."""
    ex, out = _Exchange(n), [None] * n

    def run(r):
        out[r] = fn(_ThreadMesh(devices=tuple(range(n)), group="threads", rank=r, exchange=ex))

    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert all(o is not None for o in out)
    return out


def test_global_batch_norm_equals_one_process_bn():
    rng = np.random.RandomState(0)
    y = torch.tensor(rng.randn(8, 3, 5, 6).astype(np.float32) * 2 + 1)
    g = torch.tensor(rng.randn(8, 3, 5, 6).astype(np.float32))
    gamma0 = torch.tensor(rng.rand(6).astype(np.float32) + 0.5)
    beta0 = torch.tensor(rng.randn(6).astype(np.float32))
    stats0 = (torch.tensor(rng.randn(6).astype(np.float32)),
              torch.tensor(rng.rand(6).astype(np.float32) + 0.5))

    def bn(y, mesh, rows):
        """BN of ``y[rows]``; the loss is the mean over those rows, so the
        gradient is the replicas' mean, as in the train step."""
        x = y[rows].clone().requires_grad_(True)
        gamma, beta = gamma0.clone().requires_grad_(True), beta0.clone().requires_grad_(True)
        mean, var = stats0[0].clone(), stats0[1].clone()
        if mesh is None:
            out = torch.nn.functional.batch_norm(x.permute(0, 3, 1, 2), mean, var, gamma, beta,
                                                 True, 0.1, 1e-5).permute(0, 2, 3, 1)
        else:
            out = GlobalBatchNorm.apply(x, gamma, beta, mean, var, 0.1, 1e-5, mesh)
        ((out * g[rows]).sum() / len(x)).backward()
        return out.detach(), mean, var, x.grad, gamma.grad, beta.grad

    want = bn(y, None, slice(0, 8))
    got = _on_threads(lambda mesh: bn(y, mesh, shard_rows(8, WORLD, mesh.rank)))
    tol = dict(rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(torch.cat([r[0] for r in got]), want[0], **tol)
    for r in got:  # the running statistics, with the global n / (n - 1)
        torch.testing.assert_close(r[1], want[1], **tol)
        torch.testing.assert_close(r[2], want[2], **tol)
    # each rank's input gradient is WORLD times its rows' share of the
    # global loss's; gamma's and beta's average to the global ones
    torch.testing.assert_close(torch.cat([r[3] for r in got]) / WORLD, want[3], **tol)
    for i in (4, 5):
        torch.testing.assert_close((got[0][i] + got[1][i]) / WORLD, want[i], **tol)


@pytest.mark.parametrize("fresh", [True, False], ids=["snap", "ema"])
def test_observer_route_observes_the_global_batch(fresh):
    """The fake-quant site under a mesh (the plain versions on the CPU): each
    rank steps its observer on the global min and max, as the one-process
    site does on the whole batch, bit for bit."""
    spec = QNNPACK.activation
    x = torch.tensor(np.random.RandomState(1).randn(8, 4, 4, 16).astype(np.float32))
    x[5, 0, 0, 0] = 7.5  # the global max lies in rank 1's rows
    state0 = (torch.tensor(float("inf") if fresh else -1.0),
              torch.tensor(float("-inf") if fresh else 2.0))

    def site(mesh, rows):
        mn, mx = state0[0].clone(), state0[1].clone()
        y, mask, qp = fake_quant_observe(x[rows], mn, mx, spec, mesh=mesh)
        return y, mask, qp, mn, mx

    want = site(None, slice(0, 8))
    got = _on_threads(lambda mesh: site(mesh, shard_rows(8, WORLD, mesh.rank)))
    assert torch.equal(torch.cat([r[0] for r in got]), want[0])
    assert torch.equal(torch.cat([r[1] for r in got]), want[1])
    for r in got:
        for a, b in zip(r[2:], want[2:]):
            assert torch.equal(a, b)


def test_dropout_draws_the_global_mask():
    x = torch.tensor(np.random.RandomState(2).randn(8, 1, 1, 32).astype(np.float32))
    want = dropout(x, 0.3, torch.Generator().manual_seed(5))
    for r in range(WORLD):
        mesh = Mesh(devices=tuple(range(WORLD)), group="fake", rank=r)
        rows = shard_rows(8, WORLD, r)
        with data_parallel(mesh):
            got = dropout(x[rows], 0.3, torch.Generator().manual_seed(5))
        assert torch.equal(got, want[rows])


@pytest.fixture(scope="module")
def int8_artifact(tmp_path_factory):
    """The port's export of a calibrated small FrostNet."""
    model = create_model(MODEL, num_classes=CLASSES)
    state = create_train_state(model, None, seed=3, device="cpu")
    batches = [train_batch(k, 4, SIZE, CLASSES) for k in range(2)]
    recalibrate(state, batches, mode=QAT)
    path = str(tmp_path_factory.mktemp("serve_dp") / "tiny_int8.npz")
    export_int8(state.model, path)
    return path


@pytest.mark.parametrize("batch", [8, 7])
def test_serve_on_two_replicas_equals_one(int8_artifact, batch):
    """Batch 8 splits 4 + 4; batch 7 goes over its largest divisor that
    fits two replicas, 1 (JAX's rule), on the first."""
    images = np.random.RandomState(batch).randn(batch, SIZE, SIZE, 3).astype(np.float32)
    kw = dict(num_classes=CLASSES, artifact=int8_artifact, image_size=SIZE, fuse_int8=True)
    want = serve.Int8Predictor(MODEL, device="cpu", **kw)(images)
    pred = serve.Int8Predictor(MODEL, devices=["cpu", "cpu"], **kw)
    assert len(pred.devices) == 2 and pred.model is not None
    assert torch.equal(pred(images), want)
    out = f"{int8_artifact}.{batch}.npy"
    report = serve.main(serve.build_parser().parse_args(
        ["--model", MODEL, "--artifact", int8_artifact, "--num_classes", str(CLASSES),
         "--image_size", str(SIZE), "--batch_size", str(batch), "--iters", "1", "--dp", "2",
         "--device", "cpu", "--save_logits", out]))
    assert report["dp"] == 2
    one = serve.Int8Predictor(MODEL, device="cpu", **dict(kw, fuse_int8=False))
    np.testing.assert_array_equal(np.load(out), one(next(serve._batches(
        serve.build_parser().parse_args(["--batch_size", str(batch), "--image_size",
                                         str(SIZE)])))).numpy())


@pytest.fixture(scope="module")
def dp_procs(tmp_path_factory):
    """Start the 2-rank run and JAX's two steps (subprocesses, side by side):
    the first test of the file asks for them, so they run while the others
    do; ``dp_run`` collects them."""
    tmp = tmp_path_factory.mktemp("dp")
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="2")
    args = (MODEL, SIZE, BATCH, CLASSES, 0.04)
    head = (f"import sys; sys.path[:0] = [{os.path.join(ROOT, 'tests')!r}, {ROOT!r}]; "
            "from _torch_port import dp_worker, jax_dp_reference; ")
    calls = [f"dp_worker({r}, {WORLD}, {str(tmp / 'store')!r}, {str(tmp / 'out')!r}, "
             f"*{args!r}, {STEPS!r}, {str(tmp / 'main')!r})" for r in range(WORLD)]
    calls += [f"jax_dp_reference({str(tmp / 'jax')!r}, *{args!r}, {part!r})" for part in STEPS]
    procs = [subprocess.Popen([sys.executable, "-c", head + c], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in calls]
    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # the cores go to the subprocesses meanwhile
    yield tmp, procs
    torch.set_num_threads(threads)
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def dp_run(dp_procs):
    """The ranks' and JAX's records, and the one-process port steps, all
    from ``numpy_init(seed 0)`` on the same global batches."""
    tmp, procs = dp_procs
    # the bands of the one-process step against JAX's; imported here, while
    # the subprocesses run (the module pulls in the JAX models)
    bands = importlib.import_module("test_torch_train_step")
    tx = get_optimizer("QSGD", 0.04, weight_decay=grouped_weight_decay(4e-5), noise_decay=1.0)
    state = create_train_state(create_model(MODEL, num_classes=CLASSES, drop_rate=0.0), tx,
                               seed=0, device="cpu")
    one = {}
    for k, name in enumerate(STEPS):
        if name == "QAT":
            state.start_qat()
        m = make_train_step({"FP32": FP32, "QAT": QAT}[name], num_classes=CLASSES)(
            state, train_batch(k, BATCH, SIZE, CLASSES))
        one.update({f"metrics/{k}/{n}": float(v) for n, v in m.items()})
        one.update({f"step{k}/{n}": v.detach().numpy().copy()
                    for n, v in model_variables(state.model).items()})
    logs = []
    for i, p in enumerate(procs):  # the ranks, then JAX's steps (tracing takes longer)
        out, _ = p.communicate(timeout=120 if i < WORLD else 300)
        logs.append(out)
        assert p.returncode == 0, out
    jax_rec = {**np.load(f"{tmp}/jax.FP32.npz"), **np.load(f"{tmp}/jax.QAT.npz")}
    ranks = [dict(np.load(f"{tmp}/out-{r}.npz")) for r in range(WORLD)]
    return dict(ranks=ranks, one_process=one, jax=jax_rec, main=tmp / "main", logs=logs,
                bands=bands)


def _rank_step(rec, k):
    """(variables, metrics) of step ``k`` in a run's record."""
    return ({n[len(f"step{k}/"):]: v for n, v in rec.items() if n.startswith(f"step{k}/")},
            {n.split("/")[-1]: float(v) for n, v in rec.items()
             if n.startswith(f"metrics/{k}/")})


def test_ranks_stay_bit_identical(dp_run):
    a, b = dp_run["ranks"]
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("reference", ["one_process", "jax"])
def test_dp_steps_within_bands(dp_run, reference):
    """The two ranks' run against the global batch's step in one process
    (the port's, or JAX's jitted one) in test_torch_train_step's bands."""
    b = dp_run["bands"]
    (f0, m0), (f1, m1) = (_rank_step(dp_run[reference], k) for k in range(2))
    flats, metrics = (f0, f1), (m0, m1)
    (fp32, fp32_m), (qat, qat_m) = (_rank_step(dp_run["ranks"][0], k) for k in range(2))
    assert abs(fp32_m["loss"] - metrics[0]["loss"]) <= b.FP32_LOSS_REL * metrics[0]["loss"]
    assert fp32_m["top1"] == metrics[0]["top1"] and fp32_m["top5"] == metrics[0]["top5"]
    assert abs(qat_m["loss"] - metrics[1]["loss"]) <= b.QAT_LOSS_REL * metrics[1]["loss"]
    assert b._bn_errors(fp32, flats[0]).max() <= b.FP32_STAT
    assert np.median(b._bn_errors(qat, flats[1])[:, 0]) <= b.QAT_BN_MEDIAN
    rel = []
    for k in qat:
        if k.endswith(".min_val"):
            hi = k.replace(".min_val", ".max_val")
            span = max(float(flats[1][hi] - flats[1][k]), 1e-6)
            rel.append(max(abs(float(qat[k] - flats[1][k])),
                           abs(float(qat[hi] - flats[1][hi]))) / span)
    assert rel and np.median(rel) <= b.QAT_OBS_MEDIAN and max(rel) <= b.QAT_OBS_WORST, rel
    # the FP32 step's update: the global batch's gradient, to float32 rounding
    init = flatten_variables(numpy_init(create_model(MODEL, num_classes=CLASSES), 0))
    du = np.concatenate([(fp32[k] - init[k]).ravel() for k in init if k.startswith("params/")])
    dw = np.concatenate([(flats[0][k] - init[k]).ravel() for k in init
                         if k.startswith("params/")])
    assert np.linalg.norm(du - dw) <= 1e-3 * np.linalg.norm(dw)


def test_trainer_main_on_two_ranks(dp_run):
    """classification.main under two ranks: the checkpoint and its meta
    from rank 0 only, the evaluation's all-reduced counts on both."""
    main = dp_run["main"]
    assert (main / "checkpoint").exists() and (main / "checkpoint_meta.json").exists()
    results = [dict(np.load(f"{main}/result-{r}.npz")) for r in range(WORLD)]
    for k in results[0]:
        np.testing.assert_array_equal(results[0][k], results[1][k], err_msg=k)
    # each rank evaluates its own rows: equal results are the all-reduced ones
    assert results[0]["step"] == 2 and np.isfinite(results[0]["int8_loss"])
    assert "[multihost] 2 ranks, backend gloo" in dp_run["logs"][0]
