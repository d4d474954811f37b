"""Data parallelism over ``torch.distributed`` (``frostnet_tpu/parallel``).

JAX's trainers run one program over a ``('dp', 'mp')`` mesh of chips; the
port runs one process a replica (``torchrun``), each holding the whole
state and its block of each batch's rows, and makes the global batch's
statistics explicit (``mesh.py``). ``serve --dp`` replicates a frozen model
over the cards of one process (``serve.py``).
"""
from .mesh import (
    DEFAULT_MP_RULES,
    Mesh,
    RankRows,
    active_mesh,
    all_reduce_gradients,
    cross_replica_mean,
    data_parallel,
    make_dp_mesh,
    make_mesh,
    replicate,
    shard_batch,
    shard_params_for_mp,
    shard_rows,
)
from . import multihost

__all__ = [
    "make_dp_mesh",
    "make_mesh",
    "shard_batch",
    "replicate",
    "shard_params_for_mp",
    "DEFAULT_MP_RULES",
    "cross_replica_mean",
    "multihost",
]
