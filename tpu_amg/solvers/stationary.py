"""Preconditioned stationary (Richardson) iteration.

Device-side replacement for faer's ``stationary_iteration`` driver used by
the reference's ``test_solver`` (utils.rs:664-689):

    x_{k+1} = x_k + M(b - A x_k)

Note: the reference's own ``StationaryIteration::apply`` contains a bug
(it substitutes x for b after the first sweep, smoothers.rs:152-154;
SURVEY.md Appendix B).  We implement the correct Richardson recurrence.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from tpu_amg.linop import LinearOperator
from tpu_amg.shard_utils import sdot, snorm
from tpu_amg.solvers.cg import SolveInfo


def stationary_iteration(
    a: LinearOperator,
    b: jax.Array,
    m: Optional[LinearOperator] = None,
    x0: Optional[jax.Array] = None,
    *,
    rtol: float = 1e-12,
    atol: float = 0.0,
    maxiter: int = 1000,
):
    """Run preconditioned Richardson until ||r|| <= max(rtol*||b||, atol)."""
    b = jnp.asarray(b)
    if x0 is None:
        x0 = jnp.zeros_like(b)
    apply_m = (lambda r: r) if m is None else m.mv
    b_norm = snorm(b)
    threshold = jnp.maximum(rtol * b_norm, atol)

    r0 = b - a.mv(x0)
    res0 = snorm(r0)
    hist0 = jnp.full((maxiter + 1,), jnp.nan, dtype=b.dtype).at[0].set(res0)

    def cond(state):
        _, k, res, _ = state
        return (res > threshold) & (k < maxiter)

    def body(state):
        x, k, _, hist = state
        r = b - a.mv(x)
        x = x + apply_m(r)
        res = snorm(b - a.mv(x))
        hist = hist.at[k + 1].set(res)
        return x, k + 1, res, hist

    x, k, res, hist = jax.lax.while_loop(
        cond, body, (x0, jnp.int32(0), res0, hist0)
    )
    info = SolveInfo(
        iters=k, converged=res <= threshold, res_norms=hist, final_res=res
    )
    return x, info
