"""Randomized SVD (Halko-Martinsson-Tropp) on matrix-free operators.

Reference ``rand_svd`` (decompositions/rand_svd.rs:25-102):
Y = A·Ω (Gaussian, l+oversample cols), optional subspace iteration
(AᵀA)^q, Q = thin-QR(Y), B = AᵀQ, SVD of Bᵀ, U = Q·Ũ.  Works on any
operator with mv/rmv (so it runs matrix-free on an ErrorPropagator for
near-null extraction — reference smooth_vector_rand_svd,
adaptivity.rs:248-262).

One fused jitted function: SpMM + tall-skinny QR + small dense SVD.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from tpu_amg.linop import LinearOperator


@partial(jax.jit, static_argnames=("rank", "oversample", "subspace_iters"))
def rand_svd(
    a: LinearOperator,
    key,
    rank: int,
    oversample: int = 10,
    subspace_iters: int = 0,
):
    """Approximate top-`rank` SVD of a.

    Returns (U (m, rank), s (rank,), V (n, rank)) with A ≈ U diag(s) Vᵀ.
    """
    m, n = a.shape
    ell = rank + oversample
    omega = jax.random.normal(key, (n, ell), dtype=jnp.float64)
    y = a.mm(omega)
    for _ in range(subspace_iters):
        y = a.mm(a.rmm(y))
    q, _ = jnp.linalg.qr(y)
    b = a.rmm(q)  # (n, ell) = Aᵀ Q
    # SVD of Bᵀ = (ell, n): Bᵀ = Ũ S Vᵀ  →  A ≈ Q Ũ S Vᵀ
    u_t, s, vh = jnp.linalg.svd(b.T, full_matrices=False)
    u = jnp.matmul(q, u_t, precision=jax.lax.Precision.HIGHEST)
    return u[:, :rank], s[:rank], vh[:rank].T


def smooth_vector_rand_svd(error_propagator, key, near_null_dim, iterations):
    """Near-null extraction via rand-SVD of the error propagator
    (reference adaptivity.rs:248-262): the dominant right singular
    vectors of E^q are the slowest-to-converge modes."""
    _, _, v = rand_svd(
        error_propagator,
        key,
        near_null_dim,
        oversample=10,
        subspace_iters=iterations,
    )
    return v
