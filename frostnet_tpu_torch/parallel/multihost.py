"""Process-group initialization (``frostnet_tpu/parallel/multihost.py``).

JAX spans hosts with ``jax.distributed.initialize``; the port runs one
process a replica under ``torchrun``, which sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``.
:func:`initialize` starts ``torch.distributed`` from them, and is a no-op
without them, as JAX's is without ``JAX_COORDINATOR_ADDRESS``.

The backend is chosen, not fallen back to: NCCL when each rank of a host
has its own card; gloo when the ranks run on the CPU or share a card (NCCL
refuses two ranks on one device). The choice and its reason are logged
once.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def _env_int(name: str, default: Optional[int] = None) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else default


def local_rank() -> int:
    return _env_int("LOCAL_RANK", 0)


def choose_backend(device: str = "cuda", local: Optional[int] = None) -> tuple:
    """(backend, reason) for ``local`` ranks a host (torchrun's
    ``LOCAL_WORLD_SIZE`` by default) on ``device`` ("cuda" or "cpu")."""
    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        return "gloo", "the ranks run on the CPU"
    local = local or _env_int("LOCAL_WORLD_SIZE", _env_int("WORLD_SIZE", 1))
    cards = torch.cuda.device_count()
    if cards < local:
        return "gloo", (f"{local} ranks share {cards} card(s) on this host; NCCL refuses two "
                        "ranks on one device")
    return "nccl", f"{local} ranks on this host, each its own card"


def initialize(device: str = "cuda", init_method: Optional[str] = None,
               rank: Optional[int] = None, world_size: Optional[int] = None) -> bool:
    """``torch.distributed.init_process_group`` with torchrun's environment
    as the defaults (``init_method`` ``env://``: ``MASTER_ADDR`` and
    ``MASTER_PORT``). A no-op without ``RANK`` and ``WORLD_SIZE`` (or the
    arguments), or when the group exists. Returns whether a group is up."""
    if dist.is_initialized():
        return True
    rank = rank if rank is not None else _env_int("RANK")
    world_size = world_size if world_size is not None else _env_int("WORLD_SIZE")
    if rank is None or world_size is None:
        return False
    backend, reason = choose_backend(device, _env_int("LOCAL_WORLD_SIZE", world_size))
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size)
    if rank == 0:
        print(f"[multihost] {world_size} ranks, backend {backend}: {reason}", flush=True)
    return True


def local_device(device: str = "cuda") -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` (ranks beyond the host's
    cards share them in turn), or the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda" or not dist.is_initialized():
        return dev
    return torch.device("cuda", local_rank() % max(torch.cuda.device_count(), 1))


def is_primary() -> bool:
    """True on the rank that writes checkpoints and logs (rank 0), and in
    one process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def local_batch_slice(global_batch: int) -> slice:
    """This process's slice of a globally indexed host batch."""
    if not dist.is_initialized():
        return slice(0, global_batch)
    per = global_batch // dist.get_world_size()
    i = dist.get_rank()
    return slice(i * per, (i + 1) * per)


def wait_for_end(mesh) -> None:
    """Every rank of the process group meets here at the end of a run: the
    mesh's ranks after their last write, the ranks beyond a ``make_dp_mesh``
    mesh (``mesh.member`` False) right away, so that they exit 0 with the
    run (a barrier of ``mesh.end_group``; a no-op without a group)."""
    if getattr(mesh, "end_group", None) is not None:
        dist.barrier(group=mesh.end_group)
