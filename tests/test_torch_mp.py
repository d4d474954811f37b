"""Tensor parallelism (``mp``) of the port (``parallel.shard_params_for_mp``,
the sharded forward of ``nn/conv.py``) against the port on one process and
against JAX's ``mp`` step, at ``tests/test_multihost.py::_mp_run``'s
settings (FrostNet ``tiny``, 16x16, a batch of 8, QSGD 1e-3) from a warm
QAT state.

* The mesh's rank order is JAX's ``reshape(dp, mp)``; the parameters
  ``shard_params_for_mp`` shards, and each rank's block, are JAX's.
* gloo runs on the CPU (a FileStore), one process a rank: mp 2 (dp 1) and
  dp 2 x mp 2. Each takes one QAT step and a QAT_FROZEN forward in two
  cases: "noisy" (JAX's settings: dropout 0.2, GradBoost noise on; the
  mask and the noise drawn for the full tensors, the rank's block kept),
  "quiet" (neither) and "fbgemm" ("noisy" with per-channel weight
  observers: a block's channels, or each channel reduced over ``mp``). The ranks of one dp index end bit-identical, and
  every rank holds the same full variables (``gather_mp``); the loss, the
  logits and every leaf agree with the one-process step within JAX's own
  bands (``test_mp2_matches_mp1_numerics``: loss rtol 1e-6, logits atol
  1e-5, each leaf atol 1e-4 of max(|leaf|, 1)).
* The "quiet" mp 2 step agrees with JAX's mp 2 step on two CPU devices in
  the same bands.
* ``classification.main --mp 2`` runs as JAX's trainer does: the
  parameters replicated, both ranks on the same rows, one checkpoint.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from _torch_port import (MP_CASES, jax_variables, mp_model, mp_step, mp_warm_path,
                         mp_warm_tree)
from frostnet_tpu import parallel as jax_parallel
from frostnet_tpu_torch.optim import get_optimizer
from frostnet_tpu_torch.parallel import DEFAULT_MP_RULES, Mesh, shard_params_for_mp
from frostnet_tpu_torch.quant import numpy_init
from frostnet_tpu_torch.quant.export import flatten_variables, from_jax_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYOUTS = {"mp2": (2, 2), "dp2xmp2": (4, 2)}  # name -> (world, mp)
LOSS_RTOL, LOGITS_ATOL, LEAF_ATOL = 1e-6, 1e-5, 1e-4


@pytest.fixture(scope="module")
def mp_procs(tmp_path_factory):
    """The warm state, then every layout's ranks and JAX's mp 2 step in
    subprocesses, side by side; ``mp_run`` collects them."""
    tmp = tmp_path_factory.mktemp("mp")
    warm = str(tmp)
    for backend in sorted({c[3] for c in MP_CASES}):
        mp_warm_tree(mp_warm_path(warm, backend), backend)
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    head = (f"import sys; sys.path[:0] = [{os.path.join(ROOT, 'tests')!r}, {ROOT!r}]; "
            "from _torch_port import mp_worker, jax_mp_reference; ")
    calls = [f"jax_mp_reference({str(tmp / 'jax.npz')!r}, {warm!r}, 2)"]
    for name, (world, mp) in LAYOUTS.items():
        main = str(tmp / "main") if name == "mp2" else None
        calls += [f"mp_worker({r}, {world}, {mp}, {str(tmp / (name + '.store'))!r}, "
                  f"{str(tmp / name)!r}, {warm!r}, {main!r})" for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-c", head + c], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in calls]
    yield tmp, warm, procs
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def mp_run(mp_procs):
    tmp, warm, procs = mp_procs
    one = {name: mp_step(mp_warm_path(warm, backend), drop, noise, backend=backend)
           for name, drop, noise, backend in MP_CASES}
    for p in procs[1:] + procs[:1]:  # the ranks first, JAX's compile takes longest
        out, _ = p.communicate(timeout=600)
        assert p.returncode == 0, out[-4000:]
    ranks = {name: [dict(np.load(f"{tmp}/{name}-{r}.npz")) for r in range(world)]
             for name, (world, _) in LAYOUTS.items()}
    return dict(one=one, ranks=ranks, jax=dict(np.load(f"{tmp}/jax.npz")), main=tmp / "main")


@pytest.mark.parametrize("dp,mp", [(1, 2), (2, 2), (4, 2), (2, 4), (1, 4)])
def test_mesh_rank_order_is_jax_reshape(dp, mp):
    jmesh = jax_parallel.make_mesh(dp=dp, mp=mp, devices=jax.devices()[:dp * mp])
    grid = np.vectorize(lambda d: d.id)(jmesh.devices)
    for r in range(dp * mp):
        mesh = Mesh(devices=tuple(range(dp * mp)), mp=mp, rank=r)
        assert mesh.shape == dict(jmesh.shape)
        assert grid[mesh.dp_index, mesh.mp_index] == jax.devices()[r].id


@pytest.mark.parametrize("rank", [0, 1])
def test_shard_params_for_mp_shards_what_jax_shards(rank):
    """The paths sharded and this rank's block of each, against JAX's
    ``shard_params_for_mp`` on a (1, 2) mesh of the same variables."""
    model = mp_model(0.2)
    tree = numpy_init(model, 0)
    from_jax_variables(model, tree)
    jmesh = jax_parallel.make_mesh(dp=1, mp=2, devices=jax.devices()[:2])
    jparams = jax_parallel.shard_params_for_mp(jax_variables(tree)["params"], jmesh)
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        if any(s is not None for s in leaf.sharding.spec):
            key = "params/" + "/".join(str(getattr(k, "key", k)) for k in path)
            shard = next(s for s in leaf.addressable_shards if s.device == jax.devices()[rank])
            want[key] = np.asarray(shard.data)
    mesh = Mesh(devices=(0, 1), mp=2, rank=rank)
    got = ["params/" + p for p in shard_params_for_mp(model, mesh)]
    assert sorted(got) == sorted(want) and len(got) == 16, got
    flat = {k: v for k, v in flatten_variables(tree).items()}
    for name, p in model.named_parameters():
        key = "params/" + name.replace(".", "/")
        if key in want:
            np.testing.assert_array_equal(p.detach().numpy(), want[key], err_msg=key)
            assert p.mp_block[0] == flat[key].shape
        else:
            np.testing.assert_array_equal(p.detach().numpy(), flat[key], err_msg=key)
    assert len(DEFAULT_MP_RULES) == 5


def test_gradboost_draws_a_block_of_the_full_draw():
    """A sharded parameter's noise is its block of the full parameter's
    draw: the unsharded step's noise on those elements."""
    full = torch.nn.Parameter(torch.zeros(3, 3, 4, 10))
    block = torch.nn.Parameter(torch.zeros(3, 3, 4, 5))
    block.mp_block = (tuple(full.shape), 3, 5, 5)
    want = get_optimizer("QSGD", 1e-3, seed=3)([full])._draws([full])
    got = get_optimizer("QSGD", 1e-3, seed=3)([block])._draws([block])
    for w, g in zip(want, got):
        assert torch.equal(g[0], w[0][..., 5:])


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_mp_ranks_bit_identical(mp_run, layout):
    ranks = mp_run["ranks"][layout]
    _, mp = LAYOUTS[layout]
    for r, rec in enumerate(ranks[1:], 1):
        for k in ranks[0]:
            if k.endswith("/logits") and r // mp != 0:
                continue  # another dp index holds other rows
            np.testing.assert_array_equal(rec[k], ranks[0][k], err_msg=f"rank {r} {k}")


def _within_jax_bands(loss, logits, flat, rec, name):
    assert np.isclose(loss, float(rec[f"{name}/loss"]), rtol=LOSS_RTOL), (loss, rec[f"{name}/loss"])
    np.testing.assert_allclose(rec[f"{name}/logits"], logits, atol=LOGITS_ATOL)
    keys = [k for k in rec if k.startswith(f"{name}/") and k.count("/") > 1]
    assert sorted(k[len(name) + 1:] for k in keys) == sorted(flat)
    for k, a in flat.items():
        scale = max(float(np.abs(a).max()), 1.0)
        np.testing.assert_allclose(a / scale, rec[f"{name}/{k}"] / scale, atol=LEAF_ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("case", [c[0] for c in MP_CASES])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_mp_step_matches_one_process(mp_run, layout, case):
    ranks = mp_run["ranks"][layout]
    world, mp = LAYOUTS[layout]
    rec = dict(ranks[0])
    rec[f"{case}/logits"] = np.concatenate([ranks[r][f"{case}/logits"]
                                            for r in range(0, world, mp)])
    _within_jax_bands(*mp_run["one"][case], rec, case)


def test_mp2_step_matches_jax_mp2(mp_run):
    """The port's mp 2 ranks against JAX's mp 2 step (GSPMD on two CPU
    devices) from the same warm state."""
    rec = mp_run["ranks"]["mp2"][0]
    j = mp_run["jax"]
    flat = {k[len("quiet/"):]: v for k, v in rec.items()
            if k.startswith("quiet/") and k.count("/") > 1}
    _within_jax_bands(float(rec["quiet/loss"]), rec["quiet/logits"], flat, j, "quiet")


def test_classification_main_mp2_replicates(mp_run):
    """``classification.main --mp 2``: JAX's trainer's mesh, the parameters
    replicated; both ranks train the same rows and end equal; rank 0
    writes the checkpoint."""
    main = mp_run["main"]
    assert (main / "checkpoint").exists() and (main / "checkpoint_meta.json").exists()
    a, b = (dict(np.load(f"{main}/result-{r}.npz")) for r in range(2))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a["step"] == 2 and np.isfinite(a["int8_loss"])
