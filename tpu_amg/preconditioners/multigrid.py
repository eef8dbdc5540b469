"""Multigrid μ-cycle preconditioner.

Device analog of the reference's ``Multigrid`` (reference
multigrid.rs:172-518): levels are an immutable pytree (tuple of
:class:`Level`), the μ-cycle is a Python recursion over the *static* level
count, so ``jit`` unrolls it into one straight-line XLA program — no
dynamic control flow, every per-level shape static.

The cycle recursion mirrors multigrid.rs:269-380: pre-smooth
``smoothing_steps`` Richardson steps with the level smoother, restrict the
residual, recurse μ times, prolongate + correct, post-smooth; coarsest
level applies the coarse solver directly.  Symmetric by construction
(rmv = mv; reference multigrid.rs:475-514 is symmetric-only too).

All ops accept (n,) vectors or (n, m) multi-vectors — the adaptive setup
smooths 32–64 near-null candidates through full cycles at once
(reference adaptivity.rs:307-390), which turns the SpMV into an
SpMM and the smoother into batched matmuls.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax

from tpu_amg.linop import LinearOperator, SparseOperator


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Level:
    """One multigrid level: operator, smoother, and grid-transfer ops.

    ``r``/``p`` transfer between this level and the next-coarser one
    (absent on the coarsest level).
    """

    a: LinearOperator
    smoother: LinearOperator  # applied to residuals (M ≈ A⁻¹)
    r: LinearOperator | None = None  # (n_c, n_f) restriction
    p: LinearOperator | None = None  # (n_f, n_c) prolongation


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Multigrid(LinearOperator):
    """μ-cycle over a static tuple of levels + coarse solver.

    mu=1 → V-cycle, mu=2 → W-cycle (reference MultigridConfig, μ default 1,
    multigrid.rs:27-44).
    """

    levels: Tuple[Level, ...]
    coarse_solver: LinearOperator
    mu: int = dataclasses.field(default=1, metadata=dict(static=True))
    smoothing_steps: int = dataclasses.field(default=1, metadata=dict(static=True))

    @property
    def shape(self):
        return self.levels[0].a.shape

    @property
    def num_levels(self) -> int:
        # levels holds the non-coarsest grids; coarsest is the solver
        return len(self.levels) + 1

    def _smooth(self, level: Level, v, f):
        """reference multigrid.rs:407-424 ``smooth`` helper."""
        for _ in range(self.smoothing_steps):
            v = v + level.smoother(f - level.a(v))
        return v

    def _cycle(self, idx: int, v, f):
        """reference multigrid.rs:269-380 ``cycle`` recursion."""
        if idx == len(self.levels):
            return self.coarse_solver(f)
        level = self.levels[idx]
        v = self._smooth(level, v, f)
        resid = f - level.a(v)
        f_c = level.r(resid)
        v_c = jax.numpy.zeros(
            f_c.shape, dtype=f_c.dtype
        )
        for _ in range(self.mu):
            v_c = self._cycle(idx + 1, v_c, f_c)
        v = v + level.p(v_c)
        v = self._smooth(level, v, f)
        return v

    def _apply(self, rhs):
        v0 = jax.numpy.zeros(rhs.shape, dtype=rhs.dtype)
        return self._cycle(0, v0, rhs)

    def mv(self, x):
        return self._apply(x)

    def mm(self, xs):
        return self._apply(xs)
