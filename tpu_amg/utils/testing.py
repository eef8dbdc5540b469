"""Solver test drivers and self-checking numerical utilities.

Reference ``test_solver`` (utils.rs:553-689), ``approx_convergence_factor``
(utils.rs:691-736), and ``symmetry_test`` (multigrid.rs:520-580).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from tpu_amg.linop import LinearOperator
from tpu_amg.solvers import cg, stationary_iteration


@dataclasses.dataclass
class SolverReport:
    """What the reference prints per run (examples/amg/main.rs:471-474)."""

    cg_iters: int
    cg_converged: bool
    sli_iters: int
    sli_converged: bool
    cg_history: np.ndarray
    sli_history: np.ndarray

    def reduction_factor(self) -> float:
        h = self.cg_history
        if len(h) < 2 or h[0] == 0:
            return 0.0
        return float((h[-1] / h[0]) ** (1.0 / (len(h) - 1)))


def test_solver(
    a: LinearOperator,
    m: LinearOperator,
    b,
    x0=None,
    *,
    rtol: float = 1e-12,
    maxiter: int = 1000,
    run_sli: bool = True,
) -> SolverReport:
    """Run PCG and preconditioned stationary iteration on the same system
    and report iteration counts + residual histories
    (reference utils.rs:553-689).  ``run_sli=False`` skips the stationary
    solve (it runs to maxiter V-cycles on hard problems — a big cost on
    CPU hosts) and reports -1 iterations for it."""
    _, cg_info = cg(a, b, m, x0, rtol=rtol, maxiter=maxiter)
    if run_sli:
        _, sli_info = stationary_iteration(
            a, b, m, x0, rtol=rtol, maxiter=maxiter
        )
        sli_iters = int(sli_info.iters)
        sli_converged = bool(sli_info.converged)
        sli_history = sli_info.history()
    else:
        sli_iters, sli_converged = -1, False
        sli_history = np.zeros(1)
    return SolverReport(
        cg_iters=int(cg_info.iters),
        cg_converged=bool(cg_info.converged),
        sli_iters=sli_iters,
        sli_converged=sli_converged,
        cg_history=cg_info.history(),
        sli_history=sli_history,
    )


def approx_convergence_factor(
    a: LinearOperator,
    m: LinearOperator,
    key=None,
    *,
    num_iters: int = 100,
    num_vectors: int = 5,
) -> float:
    """Estimate the asymptotic convergence factor ‖E‖_A of E = I − MA by
    power iteration on A-normalized random vectors
    (reference utils.rs:691-736: 100 iterations × 5 vectors, mean)."""
    key = key if key is not None else jax.random.PRNGKey(42)
    n = a.shape[0]
    xs = jax.random.normal(key, (n, num_vectors), dtype=jnp.float64)

    def a_norms(v):
        return jnp.sqrt(jnp.einsum(
            "nm,nm->m", v, a.mm(v), precision=jax.lax.Precision.HIGHEST
        ))

    factors = jnp.ones(num_vectors)

    def body(_, carry):
        xs, factors = carry
        xs = xs / a_norms(xs)
        xs = xs - m.mm(a.mm(xs))
        factors = a_norms(xs)
        return xs, factors

    xs, factors = jax.lax.fori_loop(0, num_iters, body, (xs, factors))
    return float(jnp.mean(factors))


def symmetry_test(
    m: LinearOperator, key=None, num_tests: int = 5, rtol: float = 1e-10
) -> bool:
    """Check uᵀMv ≈ vᵀMu on random vectors (reference multigrid.rs:520-580)."""
    key = key if key is not None else jax.random.PRNGKey(0)
    n = m.shape[0]
    ok = True
    for i in range(num_tests):
        ku, kv = jax.random.split(jax.random.fold_in(key, i))
        u = jax.random.normal(ku, (n,), dtype=jnp.float64)
        v = jax.random.normal(kv, (n,), dtype=jnp.float64)
        lhs = jnp.vdot(u, m.mv(v), precision=jax.lax.Precision.HIGHEST)
        rhs = jnp.vdot(v, m.mv(u), precision=jax.lax.Precision.HIGHEST)
        scale = jnp.maximum(jnp.abs(lhs), jnp.abs(rhs))
        ok = ok and bool(jnp.abs(lhs - rhs) <= rtol * jnp.maximum(scale, 1.0))
    return ok
