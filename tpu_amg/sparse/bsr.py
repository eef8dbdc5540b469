"""BSR (block-sparse row) format — device path for block-structured levels.

SA coarse operators are genuinely block-dense: P carries a dense
candidate-dimension column block per aggregate, so A_c = Pᵀ A P has
cd×cd dense blocks (reference interpolation/mod.rs:763-808).  Gathering
whole blocks cuts the gather count by bs× versus scalar ELL, and turns
each block product into a small dense contraction.

Layout: block-row-padded (ELL-of-blocks):
  data: (n_brows, K, bs, bs), cols: (n_brows, K) block-column ids
  (padded slots: col 0, zero block).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tpu_amg.sparse.csr import CSR


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BSR:
    data: jax.Array  # (n_brows, K, bs, bs)
    cols: jax.Array  # (n_brows, K) int32 block-col ids
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))
    block_size: int = dataclasses.field(metadata=dict(static=True))

    @property
    def nrows(self):
        return self.shape[0]

    @property
    def ncols(self):
        return self.shape[1]

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def k(self):
        return self.data.shape[1]

    # ------------------------------------------------------------------
    @staticmethod
    def from_csr(csr: CSR, block_size: int = None, dtype=jnp.float64) -> "BSR":
        bs = block_size or csr.block_size
        nr, nc = csr.shape
        if nr % bs or nc % bs:
            raise ValueError(f"dims {csr.shape} not divisible by bs={bs}")
        rows, cols, vals = csr.coo()
        br, bc = rows // bs, cols // bs
        # unique block pairs, then per-block scatter
        key = br * (nc // bs) + bc
        uniq, inv = np.unique(key, return_inverse=True)
        ubr = (uniq // (nc // bs)).astype(np.int64)
        ubc = (uniq % (nc // bs)).astype(np.int64)
        # per-block-row slot assignment
        n_brows = nr // bs
        counts = np.bincount(ubr, minlength=n_brows)
        kmax = max(int(counts.max(initial=0)), 1)
        slot_of_block = np.zeros(len(uniq), dtype=np.int64)
        order = np.argsort(ubr, kind="stable")
        starts = np.zeros(n_brows + 1, dtype=np.int64)
        np.cumsum(counts, out=starts[1:])
        slot_of_block[order] = np.arange(len(uniq)) - starts[ubr[order]]
        data = np.zeros((n_brows, kmax, bs, bs))
        colsb = np.zeros((n_brows, kmax), dtype=np.int32)
        colsb[ubr, slot_of_block] = ubc
        data[ubr[inv], slot_of_block[inv], rows % bs, cols % bs] = vals
        return BSR(
            data=jnp.asarray(data, dtype=dtype),
            cols=jnp.asarray(colsb),
            shape=csr.shape,
            nnz=csr.nnz,
            block_size=bs,
        )

    # ------------------------------------------------------------------
    def mv(self, x: jax.Array) -> jax.Array:
        from tpu_amg.sparse.ell import _row_gather

        bs = self.block_size
        xb = x.reshape(self.ncols // bs, bs)
        g = _row_gather(xb, self.cols, 1)  # (n_brows, K, bs)
        y = jnp.einsum(
            "nkij,nkj->ni", self.data, g,
            preferred_element_type=jnp.result_type(self.dtype, x.dtype),
            precision=jax.lax.Precision.HIGHEST,
        )
        return y.reshape(-1)

    def mm(self, xs: jax.Array) -> jax.Array:
        if xs.ndim == 1:
            return self.mv(xs)
        from tpu_amg.sparse.ell import _row_gather

        bs = self.block_size
        m = xs.shape[1]
        xb = xs.reshape(self.ncols // bs, bs, m)
        g = _row_gather(xb, self.cols, 2)  # (n_brows, K, bs, m)
        y = jnp.einsum(
            "nkij,nkjm->nim", self.data, g,
            preferred_element_type=jnp.result_type(self.dtype, xs.dtype),
            precision=jax.lax.Precision.HIGHEST,
        )
        return y.reshape(self.nrows, m)

    def __call__(self, x):
        return self.mm(x) if x.ndim > 1 else self.mv(x)

    def diagonal(self) -> jax.Array:
        bs = self.block_size
        brow_ids = jnp.arange(self.nrows // bs)[:, None]
        hit = self.cols == brow_ids  # (n_brows, K)
        diag_blocks = jnp.einsum(
            "nk,nkij->nij", hit.astype(self.dtype), self.data,
            precision=jax.lax.Precision.HIGHEST,
        )
        return jnp.diagonal(diag_blocks, axis1=1, axis2=2).reshape(-1)

    def abs_row_sums(self) -> jax.Array:
        return jnp.sum(jnp.abs(self.data), axis=(1, 3)).reshape(-1)

    def row_sums(self) -> jax.Array:
        return jnp.sum(self.data, axis=(1, 3)).reshape(-1)
