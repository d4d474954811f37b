"""Data and tensor parallelism over ``torch.distributed`` (``frostnet_tpu/parallel``).

JAX's trainers run one program over a ``('dp', 'mp')`` mesh of chips; the
port runs one process a mesh member (``torchrun``), each holding its block
of each batch's rows and the whole state, or under ``shard_params_for_mp``
its block of the wide kernels, and makes the global batch's statistics and
the tensor-parallel sums explicit (``mesh.py``). ``serve --dp`` replicates
a frozen model over the cards of one process (``serve.py``).
"""
from .mesh import (
    DEFAULT_MP_RULES,
    Mesh,
    RankRows,
    active_mesh,
    all_reduce_gradients,
    cross_replica_mean,
    data_parallel,
    gather_mp,
    global_normalizer,
    make_dp_mesh,
    make_mesh,
    rank_rows,
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
    "gather_mp",
    "DEFAULT_MP_RULES",
    "cross_replica_mean",
    "global_normalizer",
    "multihost",
]
