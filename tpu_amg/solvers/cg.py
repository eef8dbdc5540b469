"""Preconditioned conjugate gradients.

Device-side replacement for faer's ``conjugate_gradient`` driver
(consumed by the reference at utils.rs:600-609 with ``CgParams``:
abs tol 0, rel tol, max iters, initial-guess status).  The whole solve is
one ``lax.while_loop`` under jit: each iteration is one SpMV, one
preconditioner application, two dot products (which become ``psum``s under
`shard_map` in the distributed path), and vector AXPYs.

Returns a :class:`SolveInfo` carrying the iteration count and the full
residual-norm history in a fixed-size buffer (static shapes — the
history is what BASELINE.md's parity checks compare).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from tpu_amg.linop import LinearOperator
from tpu_amg.shard_utils import sdot, snorm


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SolveInfo:
    """Result metadata (faer ``CgInfo`` analog)."""

    iters: jax.Array  # int32 scalar: iterations performed
    converged: jax.Array  # bool scalar
    res_norms: jax.Array  # (maxiter+1,) absolute residual 2-norms; NaN-padded
    final_res: jax.Array  # final absolute residual norm

    def history(self):
        """Trimmed residual history as a host numpy array."""
        import numpy as np

        h = np.asarray(self.res_norms)
        return h[: int(self.iters) + 1]


def cg(
    a: LinearOperator,
    b: jax.Array,
    m: Optional[LinearOperator] = None,
    x0: Optional[jax.Array] = None,
    *,
    rtol: float = 1e-12,
    atol: float = 0.0,
    maxiter: int = 1000,
    flexible: bool = False,
):
    """Solve A x = b with (optionally preconditioned) CG.

    Args:
      a: SPD operator.
      m: preconditioner applied as z = M(r) ≈ A⁻¹r (SPD). None → identity.
      x0: initial guess (zeros if None).
      rtol/atol: stop when ||r|| <= max(rtol*||b||, atol)
        (matches the reference example solve config, examples/amg/main.rs:100-104).
      maxiter: static iteration cap.
      flexible: use the Polak-Ribière beta (FCG): β = zᵀ(r−r_prev)/zᵀ_prev r_prev.
        Robust to preconditioners that are not exactly a fixed SPD operator
        (mixed-precision cycles, adaptive composites); costs one extra
        stored vector and one AXPY per iteration.

    Returns:
      (x, SolveInfo)
    """
    b = jnp.asarray(b)
    if x0 is None:
        x0 = jnp.zeros_like(b)

    apply_m = (lambda r: r) if m is None else m.mv
    b_norm = snorm(b)
    threshold = jnp.maximum(rtol * b_norm, atol)

    r0 = b - a.mv(x0)
    z0 = apply_m(r0)
    p0 = z0
    rz0 = sdot(r0, z0)
    res0 = snorm(r0)
    hist0 = jnp.full((maxiter + 1,), jnp.nan, dtype=b.dtype).at[0].set(res0)

    def cond(state):
        _, r, _, _, k, res, _ = state
        return (res > threshold) & (k < maxiter)

    def body(state):
        x, r, p, rz, k, _, hist = state
        ap = a.mv(p)
        alpha = rz / sdot(p, ap)
        x = x + alpha * p
        r_new = r - alpha * ap
        z = apply_m(r_new)
        rz_new = sdot(r_new, z)
        if flexible:
            # Polak-Ribière (Notay's flexible CG): re-orthogonalizes
            # against the previous residual so a slightly-varying or
            # inexact M cannot break the p-conjugacy recurrence
            beta = sdot(r_new - r, z) / rz
        else:
            beta = rz_new / rz
        p = z + beta * p
        res = snorm(r_new)
        hist = hist.at[k + 1].set(res)
        return x, r_new, p, rz_new, k + 1, res, hist

    x, r, _, _, k, res, hist = jax.lax.while_loop(
        cond, body, (x0, r0, p0, rz0, jnp.int32(0), res0, hist0)
    )
    info = SolveInfo(
        iters=k, converged=res <= threshold, res_norms=hist, final_res=res
    )
    return x, info
