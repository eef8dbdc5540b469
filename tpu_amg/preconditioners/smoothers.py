"""Diagonal smoothers and k-step relaxation operators.

Mirrors reference src/preconditioners/smoothers.rs, with the formulas
preserved exactly (SURVEY.md Appendix A):

- l1:     dᵢ = Σⱼ |aᵢⱼ|,                        M = diag(1/d)   (smoothers.rs:63-76)
- l2:     dᵢ = Σⱼ |aᵢⱼ|·√(aᵢᵢ)/√(aⱼⱼ),          M = diag(1/d)   (smoothers.rs:43-61)
- jacobi: M = diag(ω/aᵢᵢ)                                        (smoothers.rs:78-86)

All builders run on-device over the ELL layout (one gather + row
reduction), so rebuilding smoothers per level is cheap.

``KStepSmoother`` is the corrected Richardson analog of the reference's
``StationaryIteration`` (smoothers.rs:129-171 — whose apply substitutes x
for b after the first sweep; see SURVEY.md Appendix B).  ``ErrorPropagator``
is the reference's adaptivity.rs:168-241 operator E = (I − M A)ᵏ.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from tpu_amg.linop import DiagonalOperator, LinearOperator
from tpu_amg.sparse.ell import ELL


def _as_matrix(a):
    """Accept ELL, DIA, or a SparseOperator wrapping either."""
    if hasattr(a, "ell"):
        return a.ell
    if hasattr(a, "abs_row_sums"):
        return a
    raise TypeError(f"expected ELL/DIA or SparseOperator, got {type(a)}")


def l1_inverse_diag(a) -> jax.Array:
    """1 / Σⱼ|aᵢⱼ| (reference new_l1, smoothers.rs:63-76)."""
    mat = _as_matrix(a)
    return 1.0 / mat.abs_row_sums()


def l2_inverse_diag(a) -> jax.Array:
    """1 / Σⱼ(|aᵢⱼ|·√(aᵢᵢ)/√(aⱼⱼ)) (reference new_l2, smoothers.rs:43-61)."""
    mat = _as_matrix(a)
    diag_sqrt = jnp.sqrt(mat.diagonal())
    if hasattr(mat, "cols"):  # ELL
        scale = diag_sqrt[:, None] / jnp.take(diag_sqrt, mat.cols, axis=0)
        d = jnp.sum(jnp.abs(mat.data) * scale, axis=1)
    else:  # DIA: column index of diagonal d at row i is i + offset_d
        lo, hi = mat._pad
        dpad = jnp.pad(diag_sqrt, (lo, hi), constant_values=1.0)
        n = mat.nrows
        d = jnp.zeros(n, dtype=mat.dtype)
        for k, off in enumerate(mat.offsets):
            start = lo + off
            d = d + jnp.abs(mat.data[k]) * (
                diag_sqrt / jax.lax.slice_in_dim(dpad, start, start + n)
            )
    return 1.0 / d


def jacobi_inverse_diag(a, omega: float = 1.0) -> jax.Array:
    """ω / aᵢᵢ (reference new_jacobi, smoothers.rs:78-86)."""
    mat = _as_matrix(a)
    return omega / mat.diagonal()


def build_smoother(kind: str, a, omega: float = 1.0) -> DiagonalOperator:
    """Reference ``SmootherKind::build`` (smoothers.rs:23-33).

    kind in {"l1", "l2", "jacobi"}; Gauss-Seidel variants are
    unimplemented in the reference too (smoothers.rs:26-27) — here the
    equivalent role is filled by BlockSmoother / Chebyshev.
    """
    if kind == "l1":
        return DiagonalOperator(diag=l1_inverse_diag(a))
    if kind == "l2":
        return DiagonalOperator(diag=l2_inverse_diag(a))
    if kind == "jacobi":
        return DiagonalOperator(diag=jacobi_inverse_diag(a, omega))
    raise ValueError(f"unknown smoother kind {kind!r}")


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class KStepSmoother(LinearOperator):
    """k-step preconditioned Richardson from zero initial guess, as an
    operator: x = Σ_{j<k} M (I − A M)ʲ b.

    Symmetric when A and M are (used as a symmetric preconditioner in
    PCG; reference StationaryIteration fills this role).
    """

    a: LinearOperator
    m: LinearOperator
    iters: int = dataclasses.field(metadata=dict(static=True))

    @property
    def shape(self):
        return self.a.shape

    def _run(self, b):
        x = self.m(b)
        for _ in range(self.iters - 1):
            x = x + self.m(b - self.a(x))
        return x

    def mv(self, x):
        return self._run(x)

    def mm(self, xs):
        return self._run(xs)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ErrorPropagator(LinearOperator):
    """E = (I − M A)ᵏ; rmv applies Eᵀ = (I − A M)ᵏ.

    Reference ``ErrorPropogator`` (adaptivity.rs:168-241): the operator
    whose dominant invariant subspace is the near-null space that
    adaptive AMG hunts for.
    """

    a: LinearOperator
    m: LinearOperator
    iters: int = dataclasses.field(default=1, metadata=dict(static=True))

    @property
    def shape(self):
        return self.a.shape

    def _fwd(self, x):
        for _ in range(self.iters):
            x = x - self.m(self.a(x))
        return x

    def _bwd(self, x):
        for _ in range(self.iters):
            x = x - self.a(self.m(x))
        return x

    def mv(self, x):
        return self._fwd(x)

    def mm(self, xs):
        return self._fwd(xs)

    def rmv(self, x):
        return self._bwd(x)

    def rmm(self, xs):
        return self._bwd(xs)
