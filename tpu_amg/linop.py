"""Matrix-free linear-operator protocol (pytree-based).

The reference writes everything against faer's ``LinOp`` / ``BiLinOp`` /
``Precond`` / ``BiPrecond`` trait objects (reference utils.rs:553-633,
multigrid.rs:426-518, smoothers.rs:129-212).  The JAX-native analog is an
immutable pytree with ``mv`` (matvec) / ``mm`` (matmat) / ``rmv``
(transpose-matvec) methods: operators nest freely, pass through ``jit``
boundaries as arguments, and differentiate/vmap like any other pytree.

All operators in this library are real; symmetric operators implement
``rmv = mv`` (the reference's ``conj_apply = apply`` pattern,
par_spmm.rs:135-159).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tpu_amg.sparse.csr import CSR
from tpu_amg.sparse.ell import ELL

# f32 products on a GPU default to TF32 (~3 decimal digits); every matrix
# product in the package asks for full precision explicitly.
HIGHEST = jax.lax.Precision.HIGHEST


class LinearOperator:
    """Mixin/protocol: subclasses provide ``shape``, ``mv``; get the rest."""

    shape: Tuple[int, int]

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    def mv(self, x):  # pragma: no cover - abstract
        raise NotImplementedError

    def mm(self, xs):
        """Matmat; default maps mv over columns. Override when a fused
        multi-vector path exists (e.g. ELL SpMM)."""
        return jax.vmap(self.mv, in_axes=1, out_axes=1)(xs)

    def rmv(self, x):
        """Transpose matvec. Default: operator is symmetric."""
        return self.mv(x)

    def rmm(self, xs):
        return jax.vmap(self.rmv, in_axes=1, out_axes=1)(xs)

    def __call__(self, x):
        return self.mm(x) if x.ndim > 1 else self.mv(x)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SparseOperator(LinearOperator):
    """Square/rectangular sparse operator over a device-format matrix.

    Role of the reference's ``SparseMatOp``/``ParSpmmOp`` (core.rs:56-101,
    par_spmm.rs:135-159).  For rectangular operators used in both
    directions (P and R), ``ell_t`` holds the materialized transpose —
    mirroring the reference, which materializes R = Pᵀ
    (interpolation/mod.rs:824-827).
    """

    ell: ELL
    ell_t: ELL | None = None

    @property
    def shape(self):
        return self.ell.shape

    @property
    def block_size(self):
        return self.ell.block_size

    def mv(self, x):
        return self.ell.mv(x)

    def mm(self, xs):
        return self.ell.mm(xs)

    def rmv(self, x):
        if self.ell_t is not None:
            return self.ell_t.mv(x)
        if hasattr(self.ell, "rmv"):  # BandedDense: native transpose apply
            return self.ell.rmv(x)
        if self.shape[0] != self.shape[1]:
            raise ValueError("rmv on rectangular SparseOperator without ell_t")
        return self.ell.mv(x)

    def rmm(self, xs):
        if self.ell_t is not None:
            return self.ell_t.mm(xs)
        if hasattr(self.ell, "rmm"):
            return self.ell.rmm(xs)
        if self.shape[0] != self.shape[1]:
            raise ValueError("rmm on rectangular SparseOperator without ell_t")
        return self.ell.mm(xs)

    @staticmethod
    def from_csr(
        csr: CSR,
        dtype=jnp.float64,
        with_transpose: bool = False,
        prefer_dia: bool = True,
        dia_max_diags: int = 32,
        dia_max_density: float = 3.0,
    ):
        """Build the operator in the device format :func:`_pick_format`
        chooses.  ``dia_max_diags`` / ``dia_max_density`` widen the DIA
        envelope (Galerkin coarse operators of structured grids reach
        ~125 diagonals and stay slice-FMAs rather than gathers)."""
        mat = _pick_format(
            csr, dtype, prefer_dia, dia_max_diags, dia_max_density
        )
        ell_t = None
        if with_transpose:
            ell_t = _pick_format(
                csr.transpose(), dtype, prefer_dia, dia_max_diags,
                dia_max_density,
            )
        return SparseOperator(ell=mat, ell_t=ell_t)


def _pick_format(
    csr: CSR,
    dtype,
    prefer_dia: bool,
    dia_max_diags: int,
    dia_max_density: float,
):
    """Device-format dispatch (the reference's ``dyn_op`` analog,
    core.rs:88-92).  The decision depends on the matrix alone, never on
    the platform:

    1. DIA slice-FMA for diagonal-structured square matrices (no
       gathers, one fused loop over the diagonals);
    2. BandedDense slabs for dense-row window-contained operators and
       for gather-hostile ones whose hub rows would pad ELL to several
       times their nnz (smoothed-SA transfers: R rows hold 100s-1000s
       of entries and are ~dense within their column window);
    3. BSR block gathers for block-structured square levels;
    4. ELL gather for everything else.
    """
    if prefer_dia and csr.is_square:
        from tpu_amg.sparse.dia import try_from_csr

        dia = try_from_csr(csr, dtype=dtype, max_diags=dia_max_diags)
        if dia is not None and len(
            dia.offsets
        ) * csr.nrows <= dia_max_density * max(csr.nnz, 1):
            return dia

    mean_nnz = csr.nnz / max(csr.nrows, 1)
    ell_padded = int(csr.row_nnz().max(initial=0)) * csr.nrows if csr.nnz else 0
    gather_hostile = (
        csr.nnz > 0 and ell_padded > 3.0 * csr.nnz and mean_nnz >= 2.0
    )
    if (mean_nnz >= 24.0 or gather_hostile) and csr.nnz > 0:
        from tpu_amg.sparse.banded import BandedDense, BandedUnsupported

        # generous inflation cap (padded slabs still stream contiguously,
        # where the ELL alternative pads every row to the hub row); the
        # absolute byte cap keeps huge levels within device memory
        max_inf = min(
            16.0, (1 << 30) / max(csr.nnz * jnp.dtype(dtype).itemsize, 1)
        )
        # dense rows get their own window (a tile straddling two
        # far-apart aggregates would otherwise blow the block budget —
        # the slab width is the worst tile's, so retry with smaller
        # tiles when the first attempt inflates past the cap);
        # sparser rows share tiles to amortize the window gather
        rpt = int(max(1, min(16, 1024 // max(mean_nnz, 1))))
        err = None
        rb16 = BandedDense._row_blocks16(csr)  # shared across retries
        for rpt_try in dict.fromkeys((rpt, max(rpt // 2, 1), 1)):
            try:
                return BandedDense.from_csr(
                    csr, dtype=dtype, max_inflation=max_inf,
                    rows_per_tile=rpt_try, _rb16=rb16,
                )
            except BandedUnsupported as e:
                err = e
        # heterogeneous rows (hub rows set every tile's slab width):
        # row-bucketed stack of parts
        try:
            return BandedDense.stack_from_csr(
                csr, dtype=dtype, max_inflation=max_inf, _rb16=rb16
            )
        except BandedUnsupported as e:
            err = e
        import logging

        logging.getLogger(__name__).info(
            "BandedDense rejected for %s (nnz/row %.0f): %s",
            csr.shape, mean_nnz, err,
        )

    if csr.block_size > 1 and csr.is_square:
        from tpu_amg.sparse.bsr import BSR

        return BSR.from_csr(csr, dtype=dtype)
    return ELL.from_csr(csr, dtype=dtype)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DenseOperator(LinearOperator):
    mat: jax.Array

    @property
    def shape(self):
        return self.mat.shape

    def mv(self, x):
        return jnp.matmul(self.mat, x, precision=HIGHEST)

    def mm(self, xs):
        return jnp.matmul(self.mat, xs, precision=HIGHEST)

    def rmv(self, x):
        return jnp.matmul(self.mat.T, x, precision=HIGHEST)

    def rmm(self, xs):
        return jnp.matmul(self.mat.T, xs, precision=HIGHEST)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DiagonalOperator(LinearOperator):
    """diag(d) — the diagonal smoothers' M⁻¹ (reference smoothers.rs:88-127)."""

    diag: jax.Array

    @property
    def shape(self):
        return (self.diag.shape[0], self.diag.shape[0])

    def mv(self, x):
        return self.diag * x

    def mm(self, xs):
        return self.diag[:, None] * xs


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ScaledIdentity(LinearOperator):
    scale: jax.Array
    n: int = dataclasses.field(metadata=dict(static=True))

    @property
    def shape(self):
        return (self.n, self.n)

    def mv(self, x):
        return self.scale * x

    def mm(self, xs):
        return self.scale * xs


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TransposeOperator(LinearOperator):
    """Aᵀ as an operator view — used for restrictions applied through
    the prolongation's storage (R = Pᵀ, interpolation/mod.rs:824-827)
    when R's own rows are too wide for any gather-free format."""

    base: LinearOperator

    @property
    def shape(self):
        return (self.base.shape[1], self.base.shape[0])

    @property
    def block_size(self):
        return getattr(self.base, "block_size", 1)

    def mv(self, x):
        return self.base.rmv(x)

    def mm(self, xs):
        return self.base.rmm(xs)

    def rmv(self, x):
        return self.base.mv(x)

    def rmm(self, xs):
        return self.base.mm(xs)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ComposedOperator(LinearOperator):
    """B ∘ A: y = B(A(x)). rmv = Aᵀ Bᵀ."""

    a: LinearOperator
    b: LinearOperator

    @property
    def shape(self):
        return (self.b.shape[0], self.a.shape[1])

    def mv(self, x):
        return self.b.mv(self.a.mv(x))

    def mm(self, xs):
        return self.b.mm(self.a.mm(xs))

    def rmv(self, x):
        return self.a.rmv(self.b.rmv(x))

    def rmm(self, xs):
        return self.a.rmm(self.b.rmm(xs))


def aslinearoperator(x, dtype=jnp.float64) -> LinearOperator:
    if isinstance(x, LinearOperator):
        return x
    if isinstance(x, ELL):
        return SparseOperator(ell=x)
    if isinstance(x, CSR):
        return SparseOperator.from_csr(x, dtype=dtype)
    if isinstance(x, (np.ndarray, jax.Array)):
        return DenseOperator(mat=jnp.asarray(x, dtype=dtype))
    raise TypeError(f"cannot convert {type(x)} to LinearOperator")
