"""Chebyshev polynomial smoother.

The reference leaves Gauss-Seidel unimplemented (smoothers.rs:26-27) and
relies on diagonal/block smoothers; on a device the natural heavy-duty
smoother is a Chebyshev polynomial in D⁻¹A: it needs only SpMVs and
AXPYs (no triangular solves, no sequential dependencies), making it both
bandwidth-optimal per sweep and identical in parallel and serial — the
standard choice for parallel AMG (see PAPERS.md, "Optimal Polynomial
Smoothers for Parallel AMG").

This implements the classic three-term recurrence targeting the upper
part [λ_max/ratio, λ_max] of the spectrum of D⁻¹A (hypre/PyAMG
convention), with λ_max estimated by power iteration at build time.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from tpu_amg.linop import LinearOperator


def estimate_lambda_max(a: LinearOperator, d_inv, key=None, iters: int = 20):
    """Power-iteration estimate of λ_max(D⁻¹A) (scaled by 1.05 safety)."""
    key = key if key is not None else jax.random.PRNGKey(7)
    n = a.shape[0]
    v = jax.random.normal(key, (n,), dtype=d_inv.dtype)

    def body(_, v):
        w = d_inv * a.mv(v)
        return w / jnp.linalg.norm(w)

    v = jax.lax.fori_loop(0, iters, body, v)
    hi = jax.lax.Precision.HIGHEST
    lam = jnp.vdot(v, d_inv * a.mv(v), precision=hi) / jnp.vdot(
        v, v, precision=hi
    )
    return 1.05 * lam


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ChebyshevSmoother(LinearOperator):
    """Degree-k Chebyshev smoother as a preconditioner application
    x = p(D⁻¹A) D⁻¹ b targeting [λ_max/ratio, λ_max].

    Symmetric whenever A and D are (polynomial in a self-adjoint
    operator w.r.t. the D-inner product).
    """

    a: LinearOperator
    d_inv: jax.Array
    lam_max: jax.Array
    lam_min: jax.Array
    degree: int = dataclasses.field(default=3, metadata=dict(static=True))

    @property
    def shape(self):
        return self.a.shape

    @staticmethod
    def build(
        a: LinearOperator,
        d_inv,
        degree: int = 3,
        ratio: float = 30.0,
        key=None,
    ) -> "ChebyshevSmoother":
        lam_max = estimate_lambda_max(a, d_inv, key)
        return ChebyshevSmoother(
            a=a,
            d_inv=jnp.asarray(d_inv),
            lam_max=lam_max,
            lam_min=lam_max / ratio,
            degree=degree,
        )

    def _apply(self, b):
        """Three-term Chebyshev recurrence (PyAMG/hypre formulation)."""
        theta = 0.5 * (self.lam_max + self.lam_min)
        delta = 0.5 * (self.lam_max - self.lam_min)
        sigma = theta / delta
        rho = 1.0 / sigma

        dinv = self.d_inv
        if b.ndim > 1:
            dinv = self.d_inv[:, None]
        # x_1 = (1/theta) D^-1 b
        x = (dinv * b) / theta
        d = x  # correction term
        for _ in range(self.degree - 1):
            rho_new = 1.0 / (2.0 * sigma - rho)
            r = b - self.a(x)
            d = rho_new * rho * d + (2.0 * rho_new / delta) * (dinv * r)
            x = x + d
            rho = rho_new
        return x

    def mv(self, x):
        return self._apply(x)

    def mm(self, xs):
        return self._apply(xs)
