"""Meshes, batch sharding, the global batch's statistics and tensor
parallelism (``frostnet_tpu/parallel/mesh.py``).

JAX's trainers run one program over a ``('dp', 'mp')`` mesh: a batch is
sharded over ``dp`` on its leading axis and GSPMD computes what the
single-device program computes on the global batch. The port runs one
process a mesh member (``torchrun``, ``multihost.initialize``), rank ``r``
at ``(r // mp, r % mp)`` as JAX's ``reshape(dp, mp)`` places devices. Each
takes its contiguous block of each batch's rows (:func:`shard_rows`, the
block ``shard_batch`` gives a JAX shard; the ranks of one ``dp`` index
take the same rows), and inside :func:`data_parallel` the places where a
step reads the batch as a whole ask the mesh for the global value:

* the BN layers' batch mean and variance (two all-reduces over ``dp``, and
  one in the backward for its two sums; ``nn/conv.py``), and the running
  variance's ``n / (n - 1)`` with the global ``n``;
* the activation observers' batch min and max (one all-reduce of
  ``(-min, max)`` over every rank of the mesh; ``ops/fake_quant.py``).
  Weight sites observe the replicated weights, the same on every rank, and
  skip it;
* dropout's mask, drawn for the global batch, this rank's rows kept
  (``models/frostnet.py::dropout``);
* the gradient, one all-reduce of the flat vector over ``dp``, the mean
  (:func:`all_reduce_gradients`), before the optimizer step. A loss whose
  normalizer is a global count (the segmentation CE's class weights, the
  MultiBox loss's positives) divides this rank's sum by the all-reduced
  count and multiplies by ``dp`` (:func:`global_normalizer`), so that the
  mean is the global loss's gradient;
* the step's metrics (one all-reduce, the mean over ``dp``).

torch's DDP default (per-replica BN statistics) computes another function,
so the port does not use it. A mesh of one member has no collectives: the
layers run as in one process.

:func:`make_dp_mesh` follows JAX under a process group too: the mesh takes
the largest divisor of the batch that fits the ranks, and the ranks beyond
it take no part (``Mesh.member`` is False): they wait for the run's end
(``multihost.wait_for_end``) and write nothing.

Tensor parallelism (``mp > 1``): :func:`shard_params_for_mp` keeps each
rank's block of the kernels :data:`DEFAULT_MP_RULES` names, where the dim
divides ``mp`` (JAX's guard), and the layers then compute JAX's
single-device function on the blocks (``nn/conv.py``): a map sharded by
out-channel stays local through its BN and its depthwise, the consumer of
in-channel-sharded weights sums its partial outputs over ``mp``
(:func:`mp_sum`) before its BN and its observer, and the observers of a
sharded weight take min and max over ``mp``. Autograd's side is Megatron's:
a replicated tensor entering the sharded region sums its gradient over
``mp`` (:func:`mp_enter`, :func:`mp_slice`), the partial sum passes it
through. A sharded parameter's gradient is all-reduced over ``dp`` only.
:func:`gather_mp` puts the full parameters and BN statistics back, for a
checkpoint that does not depend on ``mp``. JAX's trainer builds a ``dp x
mp`` mesh for ``--mp`` and replicates the parameters (only
``test_mp2_matches_mp1_numerics`` and ``scripts/scaling_analysis.py`` shard
them); ``classification.main --mp`` does the same.

``serve --dp`` uses a mesh of devices in one process instead: a frozen
model on each, a request batch split over them (``serve.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import re
import threading
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# JAX's tensor-parallel rules (param-path regex -> the HWIO axis sharded
# over 'mp': 3 the out-channels, 2 the in-channels)
DEFAULT_MP_RULES: Tuple[Tuple[str, int], ...] = (
    (r".*last_layer.*kernel", 3),
    (r".*classifier.*kernel", 2),
    (r".*layer\d+_\d+/conv1/kernel", 3),
    (r".*layer\d+_\d+/conv2/kernel", 3),
    (r".*layer\d+_\d+/reduce_conv/kernel", 2),
)

# how long the ranks beyond a dp mesh wait for the run's end
END_TIMEOUT = datetime.timedelta(days=30)


@dataclasses.dataclass(frozen=True)
class Ranks:
    """A set of ranks to reduce over: ``size`` ranks of ``group``."""

    group: Optional[object]
    size: int

    @property
    def distributed(self) -> bool:
        return self.group is not None and self.size > 1

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``t`` reduced over the ranks, in place (a no-op for one)."""
        if self.distributed:
            dist.all_reduce(t, op=op, group=self.group)
        return t


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``dp x mp`` mesh. ``devices`` has one entry a member: the ranks of
    ``group`` (this process is ``rank``, at ``(rank // mp, rank % mp)``)
    when the members are processes, or ``torch.device``s of one process
    (``serve --dp``). ``dp_group`` holds the ranks of this rank's ``mp``
    index, ``mp_group`` those of its ``dp`` index; ``end_group`` every rank
    of the process group, the mesh's and the idle ones. ``member`` is False
    on a rank beyond the mesh."""

    devices: tuple
    mp: int = 1
    group: Optional[object] = None  # a torch.distributed process group
    rank: int = 0
    dp_group: Optional[object] = None
    mp_group: Optional[object] = None
    end_group: Optional[object] = None
    member: bool = True

    @property
    def dp(self) -> int:
        return len(self.devices) // self.mp

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "mp": self.mp}

    @property
    def dp_index(self) -> int:
        return self.rank // self.mp

    @property
    def mp_index(self) -> int:
        return self.rank % self.mp

    @property
    def distributed(self) -> bool:
        """Replicas in other processes, to reach by collectives over ``dp``."""
        return self.group is not None and self.dp > 1

    @property
    def sharded(self) -> bool:
        """Other processes on the ``mp`` axis."""
        return self.group is not None and self.mp > 1

    @property
    def processes(self) -> bool:
        """Other processes in the mesh, on either axis."""
        return self.group is not None and len(self.devices) > 1

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``t`` reduced over the ``dp`` replicas, in place (a no-op for one)."""
        if self.distributed:
            dist.all_reduce(t, op=op, group=self.dp_group if self.mp > 1 else self.group)
        return t

    def mp_ranks(self) -> Ranks:
        """The ranks of this rank's ``dp`` index (the blocks of a sharded tensor)."""
        return Ranks(self.mp_group, self.mp if self.sharded else 1)

    def observer_ranks(self):
        """Where an activation observer reduces: every rank of the mesh (rows
        over ``dp``, channels over ``mp``; min and max are idempotent on the
        replicated copies). The mesh itself when ``mp`` is 1."""
        return self if self.mp == 1 else Ranks(self.group, len(self.devices))

    def mp_gather(self, block: torch.Tensor, dim: int) -> torch.Tensor:
        """The full tensor of the ``mp`` ranks' blocks along ``dim``, in rank
        order."""
        return _gather(block, dim, self.mp_group, self.mp) if self.sharded else block

    def dp_gather(self, rows: torch.Tensor) -> torch.Tensor:
        """The global batch of the ``dp`` replicas' rows, in row order."""
        if not self.distributed:
            return rows
        return _gather(rows, 0, self.dp_group if self.mp > 1 else self.group, self.dp)

    def mp_block(self, size: int) -> Tuple[int, int]:
        """(start, length) of this rank's block of a dim of ``size``."""
        n = size // self.mp
        return self.mp_index * n, n


def _gather(block: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """An all-gather of ``block`` over the ``n`` ranks of ``group``,
    concatenated along ``dim`` (host copies through gloo, which gathers CPU
    tensors; device tensors through NCCL)."""
    nccl = dist.get_backend(group) == "nccl"
    part = (block.detach() if nccl else block.detach().cpu()).contiguous()
    parts = [torch.empty_like(part) for _ in range(n)]
    dist.all_gather(parts, part, group=group)
    return torch.cat(parts, dim).to(block.device)


_ACTIVE = threading.local()  # .mesh: the enclosing data_parallel's, in this thread


def _world() -> Tuple[tuple, Optional[object], int]:
    """(ranks, group, rank) of the process group, or one member."""
    if dist.is_available() and dist.is_initialized():
        return tuple(range(dist.get_world_size())), dist.group.WORLD, dist.get_rank()
    return (0,), None, 0


def _process_mesh(dp: int, mp: int) -> Mesh:
    """A mesh over ranks ``0 .. dp * mp - 1`` of the process group. Every
    rank creates every group, as ``dist.new_group`` asks, in one order."""
    ranks, world, rank = _world()
    n = dp * mp
    if n > len(ranks):
        raise ValueError(f"dp*mp = {dp}*{mp} > {len(ranks)} ranks")
    if world is None:
        return Mesh(devices=ranks, mp=mp)
    end = dist.new_group(list(ranks), timeout=END_TIMEOUT)
    group = world if n == len(ranks) else dist.new_group(list(range(n)))
    dp_groups = ([dist.new_group([d * mp + m for d in range(dp)]) for m in range(mp)]
                 if mp > 1 and dp > 1 else [])
    mp_groups = ([dist.new_group([d * mp + m for m in range(mp)]) for d in range(dp)]
                 if mp > 1 else [])
    member = rank < n
    return Mesh(devices=tuple(range(n)), mp=mp, group=group if member else None,
                rank=rank if member else 0,
                dp_group=dp_groups[rank % mp] if member and dp_groups else None,
                mp_group=mp_groups[rank // mp] if member and mp_groups else None,
                end_group=end, member=member)


def make_mesh(dp: Optional[int] = None, mp: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """A ``('dp', 'mp')`` mesh, by default over every rank of the process
    group (one member without one); rank ``r`` sits at ``(r // mp, r % mp)``,
    JAX's ``reshape(dp, mp)`` order."""
    ranks, _, _ = _world()
    if devices is not None and not all(isinstance(d, torch.device) for d in devices):
        raise TypeError("devices are torch.device objects of this process; the ranks of a "
                        "process group are the default")
    n = len(ranks) if devices is None else len(devices)
    if dp is None:
        dp = n // mp
    if dp * mp != n:
        raise ValueError(f"dp*mp = {dp}*{mp} != {n} devices")
    if devices is None:
        return _process_mesh(dp, mp)
    return Mesh(devices=tuple(devices), mp=mp)


def make_dp_mesh(batch_size: int, devices: Optional[Sequence] = None) -> Mesh:
    """A pure-dp mesh whose size divides ``batch_size``: the LARGEST divisor
    of the batch that fits the devices (batch 6 on 8 devices takes 6;
    batch 1 one), as torch's DataParallel scatters a small batch over fewer
    cards. Under a process group the mesh takes the first ``dp`` ranks; the
    others get a mesh with ``member`` False and take no part."""
    b = max(int(batch_size), 1)
    n = len(_world()[0]) if devices is None else len(devices)
    dp = next(d for d in range(min(b, n), 0, -1) if b % d == 0)
    if devices is None:
        return _process_mesh(dp, 1)
    return make_mesh(dp=dp, devices=list(devices)[:dp])


def shard_rows(batch_size: int, dp: int, index: int) -> slice:
    """Replica ``index``'s contiguous block of a batch split over ``dp``
    replicas (the block JAX's ``shard_batch`` places on shard ``index``)."""
    if batch_size % dp:
        raise ValueError(f"a batch of {batch_size} does not split over {dp} replicas")
    per = batch_size // dp
    return slice(index * per, (index + 1) * per)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of a global ``batch`` (arrays or tensors)."""
    rows = shard_rows(len(next(iter(batch.values()))), mesh.dp, mesh.dp_index)
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


def rank_rows(dataset, mesh: Optional[Mesh]):
    """``dataset``, or this rank's rows of it under a data-parallel mesh."""
    return RankRows(dataset, mesh) if mesh is not None and mesh.distributed else dataset


def replicate(tree, mesh: Mesh):
    """Rank 0's parameters and buffers of a module (or the tensors of a
    dict) broadcast into every rank's copy, in place; returns ``tree``."""
    if mesh.processes:
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
    """Replace each parameter's gradient by its mean over the ``dp``
    replicas: one all-reduce of the flat float32 vector (the optimizers
    flatten it too). With ``mp > 1`` the ranks of an ``mp`` group first
    take the first one's gradients of the replicated parameters (one
    broadcast): each rank computed them from the same values, but a
    nondeterministic kernel (cuDNN's weight gradients) may round them
    otherwise, and the replicas must stay equal."""
    params = [p for p in params if p.grad is not None]
    if mesh.sharded:
        _set_grads([p for p in params if getattr(p, "mp_block", None) is None],
                   lambda flat: dist.broadcast(flat, src=mesh.dp_index * mesh.mp,
                                               group=mesh.mp_group))
    if mesh.distributed:
        _set_grads(params, lambda flat: mesh.all_reduce(flat).div_(mesh.dp))


def _set_grads(params, reduce) -> None:
    """``reduce`` (in place) the flat float32 vector of ``params``'
    gradients, and write it back."""
    if not params:
        return
    flat = torch.cat([p.grad.reshape(-1).to(torch.float32) for p in params])
    reduce(flat)
    for p, g in zip(params, torch.split(flat, [p.numel() for p in params])):
        p.grad.copy_(g.view_as(p.grad))


def global_normalizer(count: torch.Tensor, mesh: Optional[Mesh]) -> Tuple[torch.Tensor, float]:
    """(the global batch's ``count``, the factor of this rank's loss) for a
    loss ``sum / count`` over the global batch: the detached count summed
    over ``dp`` and ``dp`` itself, so that this rank's ``dp * sum / count``
    averages over the replicas (:func:`all_reduce_gradients`) to the global
    loss's gradient. ``(count, 1)`` outside a data-parallel mesh."""
    if mesh is None or not mesh.distributed:
        return count, 1.0
    total = count.detach().to(torch.float32).clone()
    return mesh.all_reduce(total), float(mesh.dp)


class _MpEnter(torch.autograd.Function):
    """Identity; the gradient summed over ``mp`` (Megatron's ``f``)."""

    @staticmethod
    def forward(ctx, x, ranks: Ranks):
        ctx.ranks = ranks
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduced(g, ctx.ranks), None


class _MpSum(torch.autograd.Function):
    """Partial sums added over ``mp``; the gradient passes (Megatron's ``g``)."""

    @staticmethod
    def forward(ctx, y, ranks: Ranks):
        return _reduced(y, ranks)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _MpSlice(torch.autograd.Function):
    """This rank's block of a replicated tensor along ``dim``; the gradient,
    zero outside the block, summed over ``mp`` (the full gradient)."""

    @staticmethod
    def forward(ctx, t, dim: int, start: int, length: int, ranks: Ranks):
        ctx.meta = (t.shape, dim, start, length, ranks)
        return t.narrow(dim, start, length).clone()

    @staticmethod
    def backward(ctx, g):
        shape, dim, start, length, ranks = ctx.meta
        full = g.new_zeros(shape)
        full.narrow(dim, start, length).copy_(g)
        return _reduced(full, ranks), None, None, None, None


def _reduced(t: torch.Tensor, ranks: Ranks) -> torch.Tensor:
    """A float32 sum of ``t`` over ``ranks`` (gloo adds float32), in ``t``'s
    dtype."""
    out = t.to(torch.float32).contiguous().clone()
    return ranks.all_reduce(out).to(t.dtype)


def mp_enter(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _MpEnter.apply(x, mesh.mp_ranks())


def mp_sum(y: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _MpSum.apply(y, mesh.mp_ranks())


def mp_slice(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    start, length = mesh.mp_block(t.shape[dim])
    return _MpSlice.apply(t, dim % t.ndim, start, length, mesh.mp_ranks())


def shard_params_for_mp(model: torch.nn.Module, mesh: Mesh, rules=DEFAULT_MP_RULES):
    """Keep this rank's block of every kernel a rule matches, where its dim
    divides ``mp`` (JAX's guard); everything else stays replicated. The
    layer owning the kernel then runs the tensor-parallel forward
    (``QConvBNAct.shard_for_mp``). Call it before the first optimizer step.
    Returns the sharded parameters' paths."""
    sharded = []
    if mesh.mp <= 1:
        return sharded
    for name, p in list(model.named_parameters()):
        path = name.replace(".", "/")
        for pat, axis in rules:
            if re.fullmatch(pat, path):
                if p.ndim > axis and p.shape[axis] % mesh.mp == 0:
                    owner = model.get_submodule(name.rsplit(".", 1)[0])
                    owner.shard_for_mp(mesh, axis)
                    sharded.append(path)
                break
    return sharded


def _sharded_layers(model: torch.nn.Module):
    return [m for m in model.modules() if getattr(m, "mp_layer", None) is not None]


@contextlib.contextmanager
def gather_mp(model: torch.nn.Module):
    """Within, every sharded kernel holds the full tensor and every sharded
    BN its full running statistics, the same on every rank (a checkpoint
    written here does not depend on ``mp``); the blocks return on exit."""
    saved = []
    with torch.no_grad():
        for m in _sharded_layers(model):
            saved.append((m, m.kernel.data))
            mesh, axis = m.mp_layer
            m.kernel.data = mesh.mp_gather(m.kernel.data, axis)
            m.sync_mp_statistics()
    try:
        yield model
    finally:
        for m, block in saved:
            m.kernel.data = block


@contextlib.contextmanager
def data_parallel(mesh: Optional[Mesh]):
    """Within (in this thread), the BN layers, the observers and dropout
    compute the global batch's values over ``mesh`` (nothing changes for one
    member)."""
    saved = getattr(_ACTIVE, "mesh", None)
    _ACTIVE.mesh = mesh if mesh is not None and mesh.processes else None
    try:
        yield
    finally:
        _ACTIVE.mesh = saved


def active_mesh() -> Optional[Mesh]:
    """The mesh of the enclosing :func:`data_parallel` with more than one
    process, else None."""
    return getattr(_ACTIVE, "mesh", None)
