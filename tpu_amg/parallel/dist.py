"""Row-partitioned sharding of ELL operators and multigrid hierarchies.

Idiomatic pjit design ("pick a mesh, annotate shardings, let XLA insert
collectives"): the ELL ``data``/``cols`` arrays are sharded over rows,
vectors over their single axis; every solver/cycle in this library is
already pure jnp, so running it under jit on sharded inputs partitions
the row-local work and inserts all-gathers for the x[cols] gathers and
psums for dot products.  Coarse levels below a size threshold are
replicated (the reference's single-node analog is the ParSpmm wrap
threshold, multigrid.rs:152-159).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpu_amg.linop import SparseOperator
from tpu_amg.parallel.halo import HaloDIA, HaloELL
from tpu_amg.parallel.multihost import global_put
from tpu_amg.preconditioners.block_smoother import BlockSmoother
from tpu_amg.preconditioners.multigrid import Level, Multigrid
from tpu_amg.sparse.dia import DIA
from tpu_amg.sparse.ell import ELL


def make_solver_mesh(n_devices: Optional[int] = None, axis: str = "x") -> Mesh:
    """1-D mesh over the first ``n_devices`` devices."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return jax.make_mesh((len(devices),), (axis,), devices=devices)


def pad_ell_identity(ell: ELL, multiple: int) -> ELL:
    """Extend a square ELL matrix with identity rows so nrows % multiple
    == 0; solutions of the padded system restrict to the original."""
    n = ell.nrows
    n_pad = ((n + multiple - 1) // multiple) * multiple
    if n_pad == n:
        return ell
    extra = n_pad - n
    data = jnp.zeros((n_pad, ell.k), dtype=ell.dtype)
    data = data.at[:n].set(ell.data)
    data = data.at[n:, 0].set(1.0)
    cols = jnp.zeros((n_pad, ell.k), dtype=ell.cols.dtype)
    cols = cols.at[:n].set(ell.cols)
    cols = cols.at[n:, 0].set(n + jnp.arange(extra, dtype=ell.cols.dtype))
    return ELL(
        data=data,
        cols=cols,
        shape=(n_pad, n_pad),
        nnz=ell.nnz + extra,
        block_size=1,
    )


def _axis_size(mesh: Mesh, axis) -> int:
    if isinstance(axis, (tuple, list)):
        size = 1
        for a in axis:
            size *= mesh.shape[a]
        return size
    return mesh.shape[axis]


def shard_ell(ell: ELL, mesh: Mesh, axis="x") -> ELL:
    """Row-shard data/cols over the mesh axis (P(axis, None)).

    ``axis`` may be a single mesh-axis name or a tuple of names — the
    tuple form shards rows over the *product* of those axes (full-mesh
    fine levels), while a sub-tuple shards over a sub-mesh and
    replicates across the rest: the analog of coarse-grid
    redistribution as levels shrink (SURVEY.md §5).
    """
    if not hasattr(ell, "cols"):
        raise TypeError(
            "shard_ell requires the ELL format (build the operator with "
            "prefer_dia=False for the distributed path)"
        )
    n_dev = _axis_size(mesh, axis)
    if ell.nrows % n_dev != 0:
        raise ValueError(
            f"nrows {ell.nrows} not divisible by {n_dev} devices; use "
            "pad_ell_identity first"
        )
    spec_axis = tuple(axis) if isinstance(axis, (tuple, list)) else axis
    sharding = NamedSharding(mesh, P(spec_axis, None))
    return dataclasses.replace(
        ell,
        data=global_put(ell.data, sharding),
        cols=global_put(ell.cols, sharding),
    )


def replicate(tree, mesh: Mesh):
    """Replicate every array of a pytree across the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(
        lambda x: global_put(x, sharding)
        if isinstance(x, jax.Array)
        else x,
        tree,
    )


def try_shard_halo(mat, mesh: Mesh, axis="x"):
    """Halo-sharded version of an ELL/DIA matrix, or None when the band
    assumption (or divisibility) fails — callers fall back to the
    all-gather path.  This is what makes ppermute halo exchange the
    *production* distributed SpMV rather than a standalone benchmark:
    DIA becomes HaloDIA (sharded slice-FMAs), ELL becomes HaloELL (local
    gather over the halo buffer).
    """
    if isinstance(axis, (tuple, list)):
        if len(axis) != 1:
            return None
        axis = axis[0]
    try:
        if isinstance(mat, DIA):
            return HaloDIA.from_dia(mat, mesh, axis)
        if isinstance(mat, ELL):
            return HaloELL.from_ell(mat, mesh, axis)
    except ValueError:
        return None
    return None


def shard_operator(
    op: SparseOperator, mesh: Mesh, axis="x", use_halo: bool = True
) -> SparseOperator:
    """Row-shard a square sparse operator (and its transpose if present).

    Banded ELL/DIA matrices get the ppermute halo-exchange form
    (parallel/halo.py); others fall back to the row-sharded all-gather
    gather path."""
    ell = None
    if use_halo:
        ell = try_shard_halo(op.ell, mesh, axis)
    if ell is None:
        ell = shard_ell(op.ell, mesh, axis)
    ell_t = None
    if op.ell_t is not None:
        if use_halo:
            ell_t = try_shard_halo(op.ell_t, mesh, axis)
        if ell_t is None:
            ell_t = shard_ell(op.ell_t, mesh, axis)
    return SparseOperator(ell=ell, ell_t=ell_t)


def _shard_block_bucket(b, mesh: Mesh, axis: str):
    """Shard one BlockBucket's per-aggregate batch dimension."""
    n_dev = mesh.shape[axis]
    n_aggs = b.inv_blocks.shape[0]
    if n_aggs % n_dev != 0:
        # pad with identity blocks acting on dof 0 with zero mask
        pad = ((n_aggs + n_dev - 1) // n_dev) * n_dev - n_aggs
        eye = jnp.broadcast_to(
            jnp.eye(b.inv_blocks.shape[1], dtype=b.inv_blocks.dtype),
            (pad,) + b.inv_blocks.shape[1:],
        )
        b = dataclasses.replace(
            b,
            inv_blocks=jnp.concatenate([b.inv_blocks, eye]),
            idx=jnp.concatenate(
                [b.idx, jnp.zeros((pad,) + b.idx.shape[1:], b.idx.dtype)]
            ),
            mask=jnp.concatenate(
                [b.mask, jnp.zeros((pad,) + b.mask.shape[1:], b.mask.dtype)]
            ),
        )
    s3 = NamedSharding(mesh, P(axis, None, None))
    s2 = NamedSharding(mesh, P(axis, None))
    return dataclasses.replace(
        b,
        inv_blocks=global_put(b.inv_blocks, s3),
        idx=global_put(b.idx, s2),
        mask=global_put(b.mask, s2),
    )


def _shard_block_smoother(
    bs: BlockSmoother, mesh: Mesh, axis: str
) -> BlockSmoother:
    """Shard every bucket's per-aggregate batch dimension."""
    return dataclasses.replace(
        bs,
        buckets=tuple(
            _shard_block_bucket(b, mesh, axis) for b in bs.buckets
        ),
    )


def _as_ell_operator(op):
    """Normalize single-chip fast formats back to ELL for sharding.

    BandedDense (dense slabs) and R-as-Pᵀ TransposeOperator views
    are single-chip layouts; the distributed path re-derives the CSR and
    shards it as (halo) ELL."""
    from tpu_amg.linop import TransposeOperator
    from tpu_amg.sparse.banded import BandedDense, BandedStack

    banded = (BandedDense, BandedStack)
    if isinstance(op, TransposeOperator):
        base = op.base
        if isinstance(base, SparseOperator) and isinstance(base.ell, banded):
            return SparseOperator(
                ell=ELL.from_csr(
                    base.ell.to_csr().transpose(), dtype=base.ell.dtype
                )
            )
        return op
    if isinstance(op, SparseOperator) and isinstance(op.ell, banded):
        return SparseOperator(
            ell=ELL.from_csr(op.ell.to_csr(), dtype=op.ell.dtype)
        )
    return op


def shard_multigrid(
    mg: Multigrid,
    mesh: Mesh,
    axis: str = "x",
    replicate_below: int = 4096,
    use_halo: bool = True,
) -> Multigrid:
    """Shard fine levels over the mesh; replicate small coarse levels.

    A level is sharded when its dimension is divisible by the mesh size
    and at least ``replicate_below``; everything else (including the
    coarse solver) is replicated — the multi-device analog of the
    reference's coarse-grid handling (multigrid.rs:152-159).

    With ``use_halo`` (default), banded level operators and grid
    transfers become ppermute halo-exchange forms (HaloDIA/HaloELL) —
    only the halo slab crosses between devices per SpMV instead of a
    full all-gather of the vector.
    """
    n_dev = mesh.shape[axis]
    new_levels = []
    for level in mg.levels:
        n = level.a.shape[0]
        a = None
        if (
            isinstance(level.a, SparseOperator)
            and n >= replicate_below
            and n % n_dev == 0
        ):
            h = try_shard_halo(level.a.ell, mesh, axis) if use_halo else None
            if h is not None:
                a = SparseOperator(ell=h)
            elif isinstance(level.a.ell, ELL):
                a = SparseOperator(ell=shard_ell(level.a.ell, mesh, axis))
            # non-banded DIA/BSR levels: fall through to replication
        if a is None:
            new_levels.append(replicate(level, mesh))
            continue
        smoother = (
            _shard_block_smoother(level.smoother, mesh, axis)
            if isinstance(level.smoother, BlockSmoother)
            else replicate(level.smoother, mesh)
        )
        r = (
            shard_ell_rect(level.r, mesh, axis, use_halo=use_halo)
            if level.r is not None
            else None
        )
        p = (
            shard_ell_rect(level.p, mesh, axis, use_halo=use_halo)
            if level.p is not None
            else None
        )
        new_levels.append(Level(a=a, smoother=smoother, r=r, p=p))
    coarse = replicate(mg.coarse_solver, mesh)
    return dataclasses.replace(
        mg, levels=tuple(new_levels), coarse_solver=coarse
    )


def shard_ell_rect(
    op: SparseOperator, mesh: Mesh, axis: str = "x", use_halo: bool = True
):
    """Shard a rectangular transfer operator: halo form when both dims
    divide evenly and the band holds, row-sharded when rows divide,
    otherwise replicated."""
    op = _as_ell_operator(op)
    n_dev = mesh.shape[axis]
    ell = try_shard_halo(op.ell, mesh, axis) if use_halo else None
    if ell is None:
        if isinstance(op.ell, ELL) and op.ell.nrows % n_dev == 0:
            ell = shard_ell(op.ell, mesh, axis)
        else:
            ell = replicate(op.ell, mesh)
    ell_t = replicate(op.ell_t, mesh) if op.ell_t is not None else None
    return SparseOperator(ell=ell, ell_t=ell_t)


def shard_vector(x, mesh: Mesh, axis="x"):
    spec_axis = tuple(axis) if isinstance(axis, (tuple, list)) else axis
    spec = P(spec_axis) if x.ndim == 1 else P(spec_axis, None)
    return global_put(x, NamedSharding(mesh, spec))
