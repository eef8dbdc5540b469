"""Halo-exchange SpMV via shard_map + ppermute — the production
distributed compute path.

The bandwidth-optimal distributed SpMV for banded orderings (structured
grids, BFS/RCM-ordered FEM meshes): instead of all-gathering the whole
vector (the default XLA lowering of ``x[cols]`` on a sharded x), each
device exchanges only a fixed-width halo slab with its ring neighbors
(``jax.lax.ppermute``), then computes from the local
[left-halo | own | right-halo] buffer.

This is the BASELINE.json north-star communication pattern ("halo vector
entries exchanged via collective-permute overlapped with local SpMV");
XLA overlaps the two ppermutes with the interior compute automatically
since they have no data dependence.

Two operator layouts, both drop-in replacements for their single-device
formats inside :class:`~tpu_amg.linop.SparseOperator` (the mesh is
carried statically, so ``op.mv(x)`` needs no extra arguments and the
multigrid cycle / CG loop are unchanged):

- :class:`HaloELL` — arbitrary banded sparsity, local gather-FMA.
  Supports rectangular operators (grid transfers R and P): row-shard d
  owns rows [d·n_loc_rows, (d+1)·n_loc_rows) and the aligned column
  window [d·n_loc_cols, (d+1)·n_loc_cols); all columns must fall within
  ``halo`` entries of that window (aggregates are numbered by first
  fine node — partition.py — so coarse orderings inherit the band).
- :class:`HaloDIA` — diagonal-structured matrices; the local compute is
  a gather-free slice-FMA per diagonal (the distributed analog of
  sparse/dia.py, the reference par_spmm.rs:98-132 role).

Setup verifies the band assumption and raises ``ValueError`` otherwise;
callers (parallel/dist.py) fall back to the all-gather path.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpu_amg.sparse.dia import DIA
from tpu_amg.sparse.ell import ELL


def _ring_exchange(x, halo: int, axis: str, n_devices: int):
    """[left-halo | x | right-halo] buffer via two ppermutes.

    The ring wraps around; the wrapped slabs at the global ends are never
    read (the band check in ``from_*`` guarantees no row references
    columns past the global edges), so their garbage values are harmless.
    """
    if halo == 0 or n_devices == 1:
        pad = [(halo, halo)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, pad) if halo else x
    perm_right = [(i, (i + 1) % n_devices) for i in range(n_devices)]
    perm_left = [(i, (i - 1) % n_devices) for i in range(n_devices)]
    left = jax.lax.ppermute(x[-halo:], axis, perm_right)
    right = jax.lax.ppermute(x[:halo], axis, perm_left)
    return jnp.concatenate([left, x, right], axis=0)


def _check_divisible(nrows: int, ncols: int, n_dev: int):
    if nrows % n_dev or ncols % n_dev:
        raise ValueError(
            f"shape ({nrows}, {ncols}) not divisible by {n_dev} devices"
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class HaloELL:
    """Row-partitioned (possibly rectangular) ELL with shard-local
    column indices.

    ``cols_local[r, k] = cols[r, k] - shard(r)·n_loc_cols + halo``
    indexes the per-shard buffer [left-halo | local x | right-halo].
    """

    data: jax.Array  # (nrows, K), sharded P(axis, None)
    cols_local: jax.Array  # (nrows, K) int32, sharded P(axis, None)
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))
    halo: int = dataclasses.field(metadata=dict(static=True))
    axis: str = dataclasses.field(metadata=dict(static=True))
    mesh: Mesh = dataclasses.field(metadata=dict(static=True))
    block_size: int = dataclasses.field(default=1, metadata=dict(static=True))

    @property
    def nrows(self):
        return self.shape[0]

    @property
    def ncols(self):
        return self.shape[1]

    @property
    def n_devices(self):
        return self.mesh.shape[self.axis]

    @property
    def n_loc_rows(self):
        return self.shape[0] // self.n_devices

    @property
    def n_loc_cols(self):
        return self.shape[1] // self.n_devices

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def k(self):
        return self.data.shape[1]

    @staticmethod
    def from_ell(
        ell: ELL, mesh: Mesh, axis: str = "x", halo: int | None = None
    ) -> "HaloELL":
        """Convert a (host or device) ELL matrix; raises ``ValueError``
        if any column falls outside the halo band."""
        n_dev = mesh.shape[axis]
        nrows, ncols = ell.shape
        _check_divisible(nrows, ncols, n_dev)
        n_loc_rows = nrows // n_dev
        n_loc_cols = ncols // n_dev
        cols = np.asarray(ell.cols)
        data = np.asarray(ell.data)
        rows = np.arange(nrows)[:, None]
        col_window_start = (rows // n_loc_rows) * n_loc_cols
        offset = cols - col_window_start  # want [-halo, n_loc_cols + halo)
        valid = data != 0
        lo = offset[valid].min(initial=0)
        hi = offset[valid].max(initial=0) - (n_loc_cols - 1)
        needed = int(max(-lo, hi, 0))
        if halo is None:
            halo = needed
        if needed > halo or halo > n_loc_cols:
            raise ValueError(
                f"band assumption violated: needs halo {needed}, "
                f"local column window {n_loc_cols}"
            )
        # padded (zero-data) entries may point anywhere; clamp them into
        # the local window so the buffer gather stays in bounds
        offset = np.where(valid, offset, 0)
        cols_local = (offset + halo).astype(np.int32)
        from tpu_amg.parallel.multihost import global_put

        sharding = NamedSharding(mesh, P(axis, None))
        return HaloELL(
            data=global_put(jnp.asarray(data, ell.dtype), sharding),
            cols_local=global_put(jnp.asarray(cols_local), sharding),
            shape=ell.shape,
            nnz=ell.nnz,
            halo=halo,
            axis=axis,
            mesh=mesh,
            block_size=ell.block_size,
        )

    def mv(self, x: jax.Array) -> jax.Array:
        return halo_spmv(self, x)

    def mm(self, xs: jax.Array) -> jax.Array:
        return halo_spmv(self, xs)

    def __call__(self, x):
        return halo_spmv(self, x)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class HaloDIA:
    """Column-sharded DIA (square): per-shard slice-FMA over the halo
    buffer — zero gathers, the distributed fast path for
    diagonal-structured levels."""

    data: jax.Array  # (n_diags, n), sharded P(None, axis)
    offsets: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))
    halo: int = dataclasses.field(metadata=dict(static=True))
    axis: str = dataclasses.field(metadata=dict(static=True))
    mesh: Mesh = dataclasses.field(metadata=dict(static=True))
    block_size: int = dataclasses.field(default=1, metadata=dict(static=True))

    @property
    def nrows(self):
        return self.shape[0]

    @property
    def ncols(self):
        return self.shape[1]

    @property
    def n_devices(self):
        return self.mesh.shape[self.axis]

    @property
    def n_loc_rows(self):
        return self.shape[0] // self.n_devices

    n_loc_cols = n_loc_rows

    @property
    def dtype(self):
        return self.data.dtype

    @staticmethod
    def from_dia(dia: DIA, mesh: Mesh, axis: str = "x") -> "HaloDIA":
        n_dev = mesh.shape[axis]
        n = dia.nrows
        _check_divisible(n, n, n_dev)
        n_loc = n // n_dev
        halo = max(max(abs(o) for o in dia.offsets), 0) if dia.offsets else 0
        if halo > n_loc:
            raise ValueError(
                f"band assumption violated: diagonal offset {halo} exceeds "
                f"local window {n_loc}"
            )
        from tpu_amg.parallel.multihost import global_put

        sharding = NamedSharding(mesh, P(None, axis))
        return HaloDIA(
            data=global_put(dia.data, sharding),
            offsets=dia.offsets,
            shape=dia.shape,
            nnz=dia.nnz,
            halo=halo,
            axis=axis,
            mesh=mesh,
            block_size=dia.block_size,
        )

    def mv(self, x: jax.Array) -> jax.Array:
        return halo_spmv(self, x)

    def mm(self, xs: jax.Array) -> jax.Array:
        return halo_spmv(self, xs)

    def __call__(self, x):
        return halo_spmv(self, x)


def _ell_shard(data, cols_local, x, *, halo, axis, n_devices):
    """Per-shard HaloELL body: ring halo exchange + local gather-FMA."""
    xbuf = _ring_exchange(x, halo, axis, n_devices)
    gathered = jnp.take(xbuf, cols_local, axis=0)
    if x.ndim == 1:
        return jnp.sum(data * gathered, axis=1)
    return jnp.einsum("rk,rkm->rm", data, gathered, precision=jax.lax.Precision.HIGHEST)


def _dia_shard(data, x, *, offsets, halo, axis, n_devices, n_loc):
    """Per-shard HaloDIA body: ring halo exchange + slice-FMA per
    diagonal (no gathers; mirrors sparse/dia.py mv)."""
    xbuf = _ring_exchange(x, halo, axis, n_devices)
    acc = jnp.zeros(
        (n_loc,) + x.shape[1:], dtype=jnp.result_type(data.dtype, x.dtype)
    )
    for d, off in enumerate(offsets):
        start = halo + off
        seg = jax.lax.slice_in_dim(xbuf, start, start + n_loc)
        dk = data[d] if x.ndim == 1 else data[d][:, None]
        acc = acc + dk * seg
    return acc


@jax.jit
def halo_spmv(h, x: jax.Array) -> jax.Array:
    """y = A @ x with x row-sharded over ``h.axis`` on ``h.mesh``."""
    vec_spec = P(h.axis) if x.ndim == 1 else P(h.axis, None)
    if isinstance(h, HaloDIA):
        body = partial(
            _dia_shard,
            offsets=h.offsets,
            halo=h.halo,
            axis=h.axis,
            n_devices=h.n_devices,
            n_loc=h.n_loc_rows,
        )
        return jax.shard_map(
            body,
            mesh=h.mesh,
            in_specs=(P(None, h.axis), vec_spec),
            out_specs=vec_spec,
        )(h.data, x)
    body = partial(
        _ell_shard, halo=h.halo, axis=h.axis, n_devices=h.n_devices
    )
    return jax.shard_map(
        body,
        mesh=h.mesh,
        in_specs=(P(h.axis, None), P(h.axis, None), vec_spec),
        out_specs=vec_spec,
    )(h.data, h.cols_local, x)
