"""Mixed-precision preconditioning (tpu_amg/precision.py).

The bf16 cycle is a memory-bandwidth feature; these CPU tests pin its
semantics: casts hit every float leaf and nothing else, the wrapper
keeps outer-loop dtypes intact, and PCG convergence survives a bf16
V-cycle with iteration counts close to the full-precision run.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_amg.precision import MixedPrecision, cast_operator, cast_preconditioner
from tpu_amg.solver import AMGSolver, SolverConfig
from tpu_amg.solvers import cg
from tpu_amg.utils.problems import poisson2d


def _setup(n=32, **kw):
    cfg = SolverConfig(
        coarsening_near_null_dim=8,
        smoothing_iters=5,
        coarsest_dim=64,
        dtype=jnp.float32,
        **kw,
    )
    a = poisson2d(n)
    return a, AMGSolver.setup(a, cfg)


def _float_leaf_dtypes(op):
    return {
        l.dtype
        for l in jax.tree_util.tree_leaves(op)
        if hasattr(l, "dtype") and jnp.issubdtype(l.dtype, jnp.inexact)
    }


class TestCastOperator:
    def test_casts_all_float_leaves(self):
        _, solver = _setup()
        mg16 = cast_operator(solver.preconditioner, jnp.bfloat16)
        assert _float_leaf_dtypes(mg16) == {jnp.dtype(jnp.bfloat16)}

    def test_integer_leaves_untouched(self):
        _, solver = _setup()
        mg = solver.preconditioner
        ints = [
            l.dtype
            for l in jax.tree_util.tree_leaves(mg)
            if hasattr(l, "dtype") and not jnp.issubdtype(l.dtype, jnp.inexact)
        ]
        mg16 = cast_operator(mg, jnp.bfloat16)
        ints16 = [
            l.dtype
            for l in jax.tree_util.tree_leaves(mg16)
            if hasattr(l, "dtype") and not jnp.issubdtype(l.dtype, jnp.inexact)
        ]
        assert ints == ints16

    def test_static_structure_preserved(self):
        _, solver = _setup()
        mg = solver.preconditioner
        mg16 = cast_operator(mg, jnp.bfloat16)
        assert type(mg16) is type(mg)
        assert mg16.smoothing_steps == mg.smoothing_steps
        assert len(mg16.levels) == len(mg.levels)

    def test_roundtrip_close(self):
        # bf16 has ~3 decimal digits; a cast-down/apply stays within a
        # relative ~1% of the f32 apply for a well-scaled cycle
        _, solver = _setup()
        mg = solver.preconditioner
        mg16 = cast_operator(mg, jnp.bfloat16)
        r = jnp.asarray(
            np.random.default_rng(0).normal(size=mg.shape[0]), jnp.bfloat16
        )
        z16 = np.asarray(mg16.mv(r), dtype=np.float64)
        z = np.asarray(mg.mv(r.astype(jnp.float32)), dtype=np.float64)
        rel = np.linalg.norm(z16 - z) / np.linalg.norm(z)
        assert rel < 0.05


class TestMixedPrecisionWrapper:
    def test_output_dtype_matches_input(self):
        _, solver = _setup()
        m = cast_preconditioner(solver.preconditioner, "bf16")
        assert isinstance(m, MixedPrecision)
        r = jnp.ones((m.shape[0],), jnp.float32)
        assert m.mv(r).dtype == jnp.float32
        rs = jnp.ones((m.shape[0], 3), jnp.float32)
        assert m.mm(rs).dtype == jnp.float32

    def test_values_mode_keeps_vectors(self):
        _, solver = _setup()
        m = cast_preconditioner(solver.preconditioner, "bf16_values")
        assert not isinstance(m, MixedPrecision)
        assert _float_leaf_dtypes(m) == {jnp.dtype(jnp.bfloat16)}

    def test_unknown_mode_raises(self):
        _, solver = _setup()
        with pytest.raises(ValueError):
            cast_preconditioner(solver.preconditioner, "fp8")


class TestConvergence:
    @pytest.mark.parametrize("mode", ["bf16_values", "bf16"])
    def test_pcg_converges_with_bf16_cycle(self, mode):
        a, solver = _setup(n=32)
        op = solver.op
        b = jnp.asarray(
            np.random.default_rng(1).normal(size=a.nrows), jnp.float32
        )
        _, info_f32 = cg(op, b, solver.preconditioner, rtol=1e-6, maxiter=100)
        m = cast_preconditioner(solver.preconditioner, mode)
        x, info = cg(op, b, m, rtol=1e-6, maxiter=100)
        assert bool(info.converged)
        # a bf16 rounding of the cycle must not meaningfully degrade it
        assert int(info.iters) <= int(info_f32.iters) + 3
        res = np.linalg.norm(
            np.asarray(b, np.float64)
            - np.asarray(a.to_scipy() @ np.asarray(x, np.float64))
        )
        assert res <= 1e-6 * np.linalg.norm(np.asarray(b)) * 10

    def test_solver_facade_cycle_precision(self):
        a, solver = _setup(n=24, cycle_precision="bf16")
        b = np.random.default_rng(2).normal(size=a.nrows)
        x, info = solver.solve(b, rtol=1e-6, maxiter=100)
        assert bool(info.converged)

    def test_checkpoint_load_applies_precision(self, tmp_path):
        a, solver = _setup(n=24, cycle_precision="bf16_values")
        p = tmp_path / "h.npz"
        solver.save(p)
        loaded = AMGSolver.load(
            p,
            a,
            dataclasses.replace(solver.config),
        )
        assert _float_leaf_dtypes(loaded.preconditioner) == {
            jnp.dtype(jnp.bfloat16)
        }
