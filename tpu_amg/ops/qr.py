"""Tall-skinny orthonormalization for (possibly row-sharded) bases.

XLA has no distributed QR; the replacement for the setup phase's
per-sweep re-orthonormalization (reference adaptivity.rs:353,
hierarchy.rs:228) is CholeskyQR2:

    G = XᵀX   (k×k — contraction over the sharded row axis → one psum)
    L = chol(G),  Q = X·L⁻ᵀ   (row-local)

iterated twice for numerical robustness (CholQR2 reaches
machine-precision orthogonality for cond(X) ≲ 1e7, which re-orthonormalized
smoothing bases always satisfy).  Every step is a small dense op or a
row-local matmul — no host round-trips, no collectives
beyond the single psum.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# TF32 would ruin the orthogonality of an f32 basis
HIGHEST = jax.lax.Precision.HIGHEST


def _spec(x):
    try:
        return tuple(jax.typeof(x).sharding.spec)
    except Exception:
        return (None,) * x.ndim


def cholesky_qr(x: jax.Array, iters: int = 2) -> jax.Array:
    """Orthonormalize the columns of x (n × k), sharded-row safe."""
    from jax.sharding import PartitionSpec as P

    row_spec = _spec(x)[0]
    sharded = row_spec is not None
    for _ in range(iters):
        if sharded:
            g = jnp.einsum(
                "nk,nl->kl", x, x, out_sharding=P(), precision=HIGHEST
            )
        else:
            g = jnp.matmul(x.T, x, precision=HIGHEST)
        # small jitter guards exactly-rank-deficient inputs
        eps = jnp.finfo(x.dtype).eps
        g = g + (eps * jnp.trace(g)) * jnp.eye(g.shape[0], dtype=x.dtype)
        chol = jnp.linalg.cholesky(g)
        inv_lt = jnp.linalg.inv(chol).T  # k×k, replicated
        if sharded:
            x = jnp.einsum(
                "nk,kl->nl", x, inv_lt, out_sharding=P(row_spec, None),
                precision=HIGHEST,
            )
        else:
            x = jnp.matmul(x, inv_lt, precision=HIGHEST)
    return x


def orthonormalize(x: jax.Array) -> jax.Array:
    """QR-based on unsharded inputs (exact), CholeskyQR2 on sharded."""
    if any(s is not None for s in _spec(x)):
        return cholesky_qr(x)
    q, _ = jnp.linalg.qr(x)
    return q
