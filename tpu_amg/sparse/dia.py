"""DIA (diagonal) sparse format — the bandwidth-optimal SpMV path.

For matrices whose nonzeros fall on a small number of (off-)diagonals —
structured-grid stencils (1/2/3-D Poisson, anisotropic diffusion on
tensor grids) and their near-structured FEM cousins — storing per-diagonal
value vectors eliminates the ELL column-index stream entirely:

    y = Σ_d  data_d ⊙ shift(x, offset_d)

Each shift is a contiguous slice (implemented as jnp.roll whose
wrapped-around lanes are annihilated by structural zeros in ``data_d``),
so the SpMV is pure stream + FMA with ~2x less memory traffic than
ELL (no cols array, no gather).  This is the device analog of the
reference's observation that its matrices are "near-diagonally clustered"
(reference core.rs:47-55) — but exploited for bandwidth instead of
cache locality.

Use :func:`try_from_csr` — it returns None when the matrix has too many
distinct diagonals to profit (fall back to ELL).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tpu_amg.sparse.csr import CSR


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DIA:
    """Diagonal-format sparse matrix (square).

    data[d, i] = A[i, i + offsets[d]] (0 when out of range / not stored).
    """

    data: jax.Array  # (n_diags, n)
    offsets: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))
    block_size: int = dataclasses.field(default=1, metadata=dict(static=True))

    @property
    def nrows(self):
        return self.shape[0]

    @property
    def ncols(self):
        return self.shape[1]

    @property
    def dtype(self):
        return self.data.dtype

    def astype(self, dtype) -> "DIA":
        return dataclasses.replace(self, data=self.data.astype(dtype))

    # ------------------------------------------------------------------
    @staticmethod
    def from_csr(csr: CSR, dtype=jnp.float64) -> "DIA":
        dia = try_from_csr(csr, dtype=dtype, max_diags=None)
        assert dia is not None
        return dia

    @property
    def _pad(self):
        """(left, right) zero-padding so every shifted read is a static
        in-bounds slice (no roll, no wraparound copies)."""
        lo = max(-min(self.offsets), 0)
        hi = max(max(self.offsets), 0)
        return lo, hi

    def mv(self, x: jax.Array) -> jax.Array:
        """y = A @ x as one padded copy of x plus a fused
        slice-multiply-accumulate per diagonal.

        Static slices of the padded vector fuse into the FMA loop under
        XLA (unlike jnp.roll, which materializes a shifted copy per
        diagonal), so the pass stays memory-bound at ~(values + x + y)
        traffic.
        """
        lo, hi = self._pad
        xp = jnp.pad(x, (lo, hi))
        acc = jnp.zeros(self.nrows, dtype=jnp.result_type(self.dtype, x.dtype))
        for d, off in enumerate(self.offsets):
            start = lo + off
            acc = acc + self.data[d] * jax.lax.slice_in_dim(
                xp, start, start + self.nrows
            )
        return acc

    def mm(self, xs: jax.Array) -> jax.Array:
        if xs.ndim == 1:
            return self.mv(xs)
        lo, hi = self._pad
        xp = jnp.pad(xs, ((lo, hi), (0, 0)))
        acc = jnp.zeros(
            (self.nrows, xs.shape[1]),
            dtype=jnp.result_type(self.dtype, xs.dtype),
        )
        for d, off in enumerate(self.offsets):
            start = lo + off
            acc = acc + self.data[d][:, None] * jax.lax.slice_in_dim(
                xp, start, start + self.nrows
            )
        return acc

    def __call__(self, x):
        return self.mm(x) if x.ndim > 1 else self.mv(x)

    def diagonal(self) -> jax.Array:
        if 0 in self.offsets:
            return self.data[self.offsets.index(0)]
        return jnp.zeros(self.nrows, dtype=self.dtype)

    def abs_row_sums(self) -> jax.Array:
        return jnp.sum(jnp.abs(self.data), axis=0)

    def row_sums(self) -> jax.Array:
        return jnp.sum(self.data, axis=0)


def try_from_csr(
    csr: CSR, dtype=jnp.float64, max_diags: Optional[int] = 32
) -> Optional[DIA]:
    """Convert when the matrix has ≤ max_diags distinct diagonals
    (and is square); otherwise return None."""
    if not csr.is_square:
        return None
    rows, cols, vals = csr.coo()
    offs = cols - rows
    uniq = np.unique(offs)
    if max_diags is not None and len(uniq) > max_diags:
        return None
    n = csr.nrows
    data = np.zeros((len(uniq), n))
    d_idx = np.searchsorted(uniq, offs)
    data[d_idx, rows] = vals
    return DIA(
        data=jnp.asarray(data, dtype=dtype),
        offsets=tuple(int(o) for o in uniq),
        shape=csr.shape,
        nnz=csr.nnz,
        block_size=csr.block_size,
    )
