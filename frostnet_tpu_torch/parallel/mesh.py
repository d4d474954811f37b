"""Meshes, batch sharding and the global batch's statistics
(``frostnet_tpu/parallel/mesh.py``).

JAX's trainers run one program over a ``('dp', 'mp')`` mesh: a batch is
sharded over ``dp`` on its leading axis and GSPMD computes what the
single-device program computes on the global batch. The port runs one
process a replica (``torchrun``, ``multihost.initialize``): each holds the
whole state, takes its contiguous block of each batch's rows
(:func:`shard_rows`, the block ``shard_batch`` gives a JAX shard), and
inside :func:`data_parallel` the places where a step reads the batch as a
whole ask the mesh for the global value:

* the BN layers' batch mean and variance (two all-reduces, and one in the
  backward for its two sums; ``nn/conv.py``), and the running variance's
  ``n / (n - 1)`` with the global ``n``;
* the activation observers' batch min and max (one all-reduce of
  ``(-min, max)``; ``ops/fake_quant.py``). Weight sites observe the
  replicated weights, the same on every rank, and skip it;
* dropout's mask, drawn for the global batch, this rank's rows kept
  (``models/frostnet.py::dropout``);
* the gradient, one all-reduce of the flat vector, the mean over ranks
  (:func:`all_reduce_gradients`), before the optimizer step;
* the step's metrics (one all-reduce, the mean over ranks).

torch's DDP default (per-replica BN statistics) computes another function,
so the port does not use it. A mesh of one replica has no collectives: the
layers run as in one process.

``serve --dp`` uses a mesh of devices in one process instead: a frozen
model on each, a request batch split over them (``serve.py``).

Model parallelism (``mp > 1``, ``shard_params_for_mp``) is not ported.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

MP_NOT_PORTED = ("model parallelism (mp > 1) is not ported yet (ROADMAP.md, Queue A "
                 "item 6.5b)")

# JAX's tensor-parallel rules (param-path regex -> the axis sharded over
# 'mp'); kept for the mp item, which is not ported
DEFAULT_MP_RULES: Tuple[Tuple[str, int], ...] = (
    (r".*last_layer.*kernel", 3),
    (r".*classifier.*kernel", 2),
    (r".*layer\d+_\d+/conv1/kernel", 3),
    (r".*layer\d+_\d+/conv2/kernel", 3),
    (r".*layer\d+_\d+/reduce_conv/kernel", 2),
)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``dp x mp`` mesh. ``devices`` has one entry a replica: the ranks
    of ``group`` (this process is ``rank``) when the replicas are
    processes, or ``torch.device``s of one process (``serve --dp``)."""

    devices: tuple
    mp: int = 1
    group: Optional[object] = None  # a torch.distributed process group
    rank: int = 0

    @property
    def dp(self) -> int:
        return len(self.devices) // self.mp

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "mp": self.mp}

    @property
    def distributed(self) -> bool:
        """Replicas in other processes, to reach by collectives."""
        return self.group is not None and self.dp > 1

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``t`` reduced over the replicas, in place (a no-op in one process)."""
        if self.distributed:
            dist.all_reduce(t, op=op, group=self.group)
        return t


_ACTIVE: Optional[Mesh] = None


def _world() -> Tuple[tuple, Optional[object], int]:
    """(ranks, group, rank) of the process group, or one replica."""
    if dist.is_available() and dist.is_initialized():
        return tuple(range(dist.get_world_size())), dist.group.WORLD, dist.get_rank()
    return (0,), None, 0


def make_mesh(dp: Optional[int] = None, mp: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """A ``('dp', 'mp')`` mesh, by default over every rank of the process
    group (one replica without one). ``mp > 1`` raises."""
    if mp != 1:
        raise NotImplementedError(MP_NOT_PORTED)
    ranks, group, rank = _world()
    if devices is None:
        devices = ranks
    elif not all(isinstance(d, torch.device) for d in devices):
        raise TypeError("devices are torch.device objects of this process; the ranks of a "
                        "process group are the default")
    else:
        group, rank = None, 0
    devices = tuple(devices)
    if dp is None:
        dp = len(devices) // mp
    if dp * mp != len(devices):
        raise ValueError(f"dp*mp = {dp}*{mp} != {len(devices)} devices")
    return Mesh(devices=devices, mp=mp, group=group, rank=rank)


def make_dp_mesh(batch_size: int, devices: Optional[Sequence] = None) -> Mesh:
    """A pure-dp mesh whose size divides ``batch_size``: the LARGEST divisor
    of the batch that fits the devices (batch 6 on 8 devices takes 6;
    batch 1 one), as torch's DataParallel scatters a small batch over fewer
    cards. A process group's mesh spans all ranks, so there the batch must
    divide over them."""
    b = max(int(batch_size), 1)
    if devices is None:
        ranks, _, _ = _world()
        if b % len(ranks):
            raise ValueError(f"a batch of {b} does not split over {len(ranks)} ranks")
        return make_mesh()
    devices = list(devices)
    dp = next(d for d in range(min(b, len(devices)), 0, -1) if b % d == 0)
    return make_mesh(dp=dp, devices=devices[:dp])


def shard_rows(batch_size: int, dp: int, index: int) -> slice:
    """Replica ``index``'s contiguous block of a batch split over ``dp``
    replicas (the block JAX's ``shard_batch`` places on shard ``index``)."""
    if batch_size % dp:
        raise ValueError(f"a batch of {batch_size} does not split over {dp} replicas")
    per = batch_size // dp
    return slice(index * per, (index + 1) * per)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of a global ``batch`` (arrays or tensors)."""
    rows = shard_rows(len(next(iter(batch.values()))), mesh.dp, mesh.rank)
    return {k: v[rows] for k, v in batch.items()}


class RankRows:
    """This rank's rows of every batch a dataset yields (global batches, as
    the Python loaders make them; the native loaders split themselves)."""

    def __init__(self, dataset, mesh: Mesh):
        self.dataset, self.mesh = dataset, mesh

    def __len__(self):
        return len(self.dataset)

    def __iter__(self):
        return (shard_batch(b, self.mesh) for b in self.dataset)


def replicate(tree, mesh: Mesh):
    """Rank 0's parameters and buffers of a module (or the tensors of a
    dict) broadcast into every rank's copy, in place; returns ``tree``."""
    if mesh.distributed:
        tensors = (list(tree.parameters()) + list(tree.buffers())
                   if isinstance(tree, torch.nn.Module) else list(tree.values()))
        with torch.no_grad():
            for t in tensors:
                dist.broadcast(t.data, src=0, group=mesh.group)
    return tree


def cross_replica_mean(tree, mesh: Optional[Mesh]):
    """The mean over the replicas of a tensor or a dict of tensors (one
    all-reduce)."""
    if mesh is None or not mesh.distributed:
        return tree
    if isinstance(tree, torch.Tensor):
        return mesh.all_reduce(tree).div_(mesh.dp)
    keys = list(tree)
    flat = mesh.all_reduce(torch.stack([tree[k].to(torch.float32) for k in keys]))
    flat.div_(mesh.dp)
    return dict(zip(keys, flat.unbind()))


def all_reduce_gradients(params, mesh: Mesh) -> None:
    """Replace each parameter's gradient by its mean over the replicas: one
    all-reduce of the flat float32 vector (the optimizers flatten it too)."""
    if not mesh.distributed:
        return
    params = [p for p in params if p.grad is not None]
    flat = torch.cat([p.grad.reshape(-1).to(torch.float32) for p in params])
    mesh.all_reduce(flat).div_(mesh.dp)
    for p, g in zip(params, torch.split(flat, [p.numel() for p in params])):
        p.grad.copy_(g.view_as(p.grad))


def shard_params_for_mp(params, mesh: Mesh, rules=DEFAULT_MP_RULES):
    """Tensor-parallel sharding of the wide channel dims: not ported."""
    raise NotImplementedError(MP_NOT_PORTED)


@contextlib.contextmanager
def data_parallel(mesh: Optional[Mesh]):
    """Within, the BN layers, the observers and dropout compute the global
    batch's values over ``mesh`` (nothing changes for one replica)."""
    global _ACTIVE
    saved, _ACTIVE = _ACTIVE, (mesh if mesh is not None and mesh.distributed else None)
    try:
        yield
    finally:
        _ACTIVE = saved


def active_mesh() -> Optional[Mesh]:
    """The mesh of the enclosing :func:`data_parallel` with more than one
    replica, else None."""
    return _ACTIVE
