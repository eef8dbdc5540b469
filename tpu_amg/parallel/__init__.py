"""Multi-chip/multi-host distribution over `jax.sharding` meshes.

The reference's only parallelism is a shared-memory rayon pool
(SURVEY.md §2.1); the equivalent here is SPMD over a device mesh:
each level's ELL matrix is row-partitioned (P('x', None)), vectors are
row-sharded (P('x')), and XLA inserts the collectives (the gather of
x[cols] becomes an all-gather; CG dot products become psums).
A manual shard_map halo-exchange SpMV (`halo_spmv`) covers the
bandwidth-optimal path for banded orderings.
"""

from tpu_amg.parallel.dist import (
    make_solver_mesh,
    pad_ell_identity,
    shard_ell,
    shard_operator,
    shard_multigrid,
    replicate,
    try_shard_halo,
)
from tpu_amg.parallel.halo import HaloDIA, HaloELL, halo_spmv

__all__ = [
    "make_solver_mesh",
    "pad_ell_identity",
    "shard_ell",
    "shard_operator",
    "shard_multigrid",
    "replicate",
    "try_shard_halo",
    "HaloDIA",
    "HaloELL",
    "halo_spmv",
]
