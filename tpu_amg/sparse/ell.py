"""ELL (padded-row) sparse format — the general device compute path.

The reference's only performance-critical kernel is a rayon-parallel
blocked-CSR SpMM (reference par_spmm.rs:98-132).  Irregular CSR row
loops defeat XLA's tiling; instead we pad every row to a fixed width K
(max nnz/row, rounded up to a lane-friendly multiple), giving SpMV/SpMM
static shapes:

    y[i] = sum_k data[i, k] * x[cols[i, k]]

which XLA compiles to a row-gather + FMA + row-reduction, entirely
memory-bound and vectorizable.  FEM matrices have bounded
nnz/row (the same assumption the reference makes, core.rs:47-55), so the
padding overhead is small (typically < 2x, often ~1.1x).

Padded slots store ``col = 0, val = 0`` so gathers stay in-bounds and
contribute nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _row_gather(x: jax.Array, idx: jax.Array, extra_dims: int) -> jax.Array:
    """x[idx] with explicit output sharding when idx is sharded.

    JAX's sharding-in-types cannot infer the gather output sharding when
    the indices are partitioned (the distributed row-sharded SpMV path);
    the natural choice is idx's own spec extended with replicated trailing
    dims — the gather of x then lowers to an all-gather of x across devices
    followed by a shard-local gather.  Callers must be inside a
    ``jax.set_mesh`` context for distributed use.
    """
    idx_spec = tuple(jax.typeof(idx).sharding.spec)
    x_spec = tuple(jax.typeof(x).sharding.spec)
    if all(s is None for s in idx_spec + x_spec):
        return jnp.take(x, idx, axis=0)
    from jax.sharding import PartitionSpec as P

    # result layout: idx dims then x's trailing dims; row-sharding follows
    # idx (x is all-gathered when its rows are sharded)
    out_spec = P(*(idx_spec + x_spec[1:]))
    return x.at[idx].get(out_sharding=out_spec)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ELL:
    """Padded-row sparse matrix, jit-ready pytree.

    Attributes:
      data: (nrows, K) values, padded with 0.
      cols: (nrows, K) int32 column indices, padded with 0.
      shape: static (nrows, ncols).
      nnz: static true nonzero count (for complexity stats / rooflines).
      block_size: static block-size metadata (reference core.rs:22-36).
    """

    data: jax.Array
    cols: jax.Array
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))
    block_size: int = dataclasses.field(default=1, metadata=dict(static=True))

    # ------------------------------------------------------------------
    @staticmethod
    def from_csr(csr, dtype=jnp.float64, pad_to: int = 1) -> "ELL":
        """Convert host CSR → device ELL. ``pad_to`` rounds K up."""
        nrows, ncols = csr.shape
        row_nnz = csr.row_nnz()
        k = _round_up(max(int(row_nnz.max(initial=0)), 1), pad_to)
        data = np.zeros((nrows, k))
        cols = np.zeros((nrows, k), dtype=np.int32)
        # scatter each row's entries into its padded slots
        offs = np.arange(len(csr.data)) - np.repeat(csr.indptr[:-1], row_nnz)
        rows = np.repeat(np.arange(nrows), row_nnz)
        data[rows, offs] = csr.data
        cols[rows, offs] = csr.indices
        return ELL(
            data=jnp.asarray(data, dtype=dtype),
            cols=jnp.asarray(cols),
            shape=(nrows, ncols),
            nnz=csr.nnz,
            block_size=csr.block_size,
        )

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    @property
    def k(self) -> int:
        return self.data.shape[1]

    @property
    def dtype(self):
        return self.data.dtype

    def astype(self, dtype) -> "ELL":
        return dataclasses.replace(self, data=self.data.astype(dtype))

    def to_csr(self):
        """Host CSR from the padded device layout (zero slots dropped);
        the bridge back to construction-time algorithms (sharding,
        SpGEMM) that need the raw sparsity."""
        import numpy as np

        from tpu_amg.sparse.csr import CSR

        data = np.asarray(self.data, dtype=np.float64)
        cols = np.asarray(self.cols, dtype=np.int64)
        rows = np.broadcast_to(
            np.arange(self.nrows, dtype=np.int64)[:, None], cols.shape
        )
        keep = data != 0
        return CSR.from_coo(
            rows[keep], cols[keep], data[keep], self.shape
        ).with_block_size(self.block_size)

    # ------------------------------------------------------------------
    # compute path
    # ------------------------------------------------------------------
    def mv(self, x: jax.Array) -> jax.Array:
        """SpMV: y = A @ x for x of shape (ncols,).

        One (nrows, K) gather + FMA + row-sum; XLA fuses these into a
        single memory-bound loop (the replacement for the reference's
        ParSpmmOp::apply, par_spmm.rs:98-132).
        """
        gathered = _row_gather(x, self.cols, 0)  # (nrows, K)
        return jnp.sum(self.data * gathered, axis=1)

    def mm(self, xs: jax.Array) -> jax.Array:
        """SpMM: Y = A @ X for X of shape (ncols, m).

        Scans over the K padded diagonals so the live intermediate is
        O(nrows * m), never O(nrows * K * m).  Each step is a row-gather
        of X (whole (m,)-rows move together) plus an
        FMA.  This is the hot op of adaptive setup (smoothing 32-64
        near-null candidates at once; reference adaptivity.rs:307-390).
        """
        if xs.ndim == 1:
            return self.mv(xs)
        m = xs.shape[1]
        acc0 = jnp.zeros((self.nrows, m), dtype=jnp.result_type(self.dtype, xs.dtype))
        # the scan carry must match the (sharded) step output: rows
        # follow the matrix sharding, columns follow xs's column sharding
        row_spec = jax.typeof(self.cols).sharding.spec[0]
        col_spec = tuple(jax.typeof(xs).sharding.spec)[1:]
        if row_spec is not None or any(s is not None for s in col_spec):
            from jax.sharding import PartitionSpec as P

            acc0 = jax.sharding.reshard(acc0, P(row_spec, *col_spec))

        def step(acc, dk_ck):
            dk, ck = dk_ck
            acc = acc + dk[:, None] * _row_gather(xs, ck, 1)
            return acc, None

        acc, _ = jax.lax.scan(step, acc0, (self.data.T, self.cols.T))
        return acc

    def __call__(self, x: jax.Array) -> jax.Array:
        return self.mm(x) if x.ndim > 1 else self.mv(x)

    def diagonal(self) -> jax.Array:
        """Diagonal of a square ELL matrix."""
        row_ids = jnp.arange(self.nrows)[:, None]
        hit = (self.cols == row_ids) & (self.data != 0)
        # padded slots have col 0 but val 0, so (data!=0) masks row-0 fakes;
        # a genuinely stored zero diagonal reads back as 0 anyway.
        return jnp.sum(jnp.where(hit, self.data, 0.0), axis=1)

    def abs_row_sums(self) -> jax.Array:
        """l1 row norms (l1-smoother diagonal, reference smoothers.rs:63-76)."""
        return jnp.sum(jnp.abs(self.data), axis=1)

    def row_sums(self) -> jax.Array:
        return jnp.sum(self.data, axis=1)

    def __repr__(self):
        return (
            f"ELL(shape={self.shape}, nnz={self.nnz}, k={self.data.shape[1]}, "
            f"dtype={self.data.dtype}, block_size={self.block_size})"
        )
