"""AMGSolver facade: setup / solve / checkpoint round-trip."""

import jax.numpy as jnp
import numpy as np
import pytest

from tpu_amg.solver import AMGSolver, SolverConfig
from tpu_amg.utils.problems import poisson2d


@pytest.fixture(scope="module")
def solver():
    a = poisson2d(16)
    cfg = SolverConfig(
        coarsening_near_null_dim=4,
        interp_near_null_dim=2,
        smoothing_iters=8,
        coarsest_dim=40,
        aggregation_iters=10,
        coarsening_factor=4.0,
    )
    return a, AMGSolver.setup(a, cfg)


def test_solve_cg(solver):
    a, s = solver
    b = jnp.ones(a.nrows)
    x, info = s.solve(b, rtol=1e-10)
    assert bool(info.converged)
    np.testing.assert_allclose(
        a.matvec(np.asarray(x)), np.ones(a.nrows), atol=1e-7
    )
    assert int(info.iters) <= 20


def test_solve_multiple_rhs_reuses(solver):
    a, s = solver
    rng = np.random.default_rng(0)
    for _ in range(3):
        b = jnp.asarray(rng.normal(size=a.nrows))
        x, info = s.solve(b, rtol=1e-8)
        assert bool(info.converged)


def test_stationary_method(solver):
    a, s = solver
    b = jnp.ones(a.nrows)
    x, info = s.solve(b, rtol=1e-6, method="stationary")
    assert bool(info.converged)


def test_checkpoint_roundtrip(solver, tmp_path):
    a, s = solver
    s.save(tmp_path / "h.npz")
    s2 = AMGSolver.load(tmp_path / "h.npz", a, s.config)
    b = jnp.ones(a.nrows)
    _, i1 = s.solve(b, rtol=1e-8)
    _, i2 = s2.solve(b, rtol=1e-8)
    assert abs(int(i1.iters) - int(i2.iters)) <= 2


def test_adaptive_method():
    a = poisson2d(12)
    cfg = SolverConfig(
        method="adaptive",
        composite_components=2,
        coarsening_near_null_dim=4,
        interp_near_null_dim=2,
        smoothing_iters=6,
        coarsest_dim=30,
        aggregation_iters=5,
        coarsening_factor=4.0,
    )
    s = AMGSolver.setup(a, cfg)
    b = jnp.ones(a.nrows)
    x, info = s.solve(b, rtol=1e-8)
    assert bool(info.converged)


def test_reorder_option_solves_scrambled_system():
    from tests.test_reorder import scrambled_poisson

    scrambled, _ = scrambled_poisson(12, seed=5)
    cfg = SolverConfig(
        reorder=True,
        coarsening_near_null_dim=4,
        interp_near_null_dim=1,
        smoothing_iters=8,
        coarsest_dim=40,
        aggregation_iters=10,
        coarsening_factor=8.0,
    )
    s = AMGSolver.setup(scrambled, cfg)
    b = jnp.ones(scrambled.nrows)
    x, info = s.solve(b, rtol=1e-10)
    assert bool(info.converged)
    # solution is in the ORIGINAL numbering
    np.testing.assert_allclose(
        scrambled.matvec(np.asarray(x)), np.ones(scrambled.nrows), atol=1e-7
    )


def test_level_matrices_match_device_operators():
    """level_matrices() returns the host CSRs in the cycle's own
    numbering (RCM-permuted levels included): each level's device A, R
    and P apply exactly those matrices."""
    a = poisson2d(40)
    s = AMGSolver.setup(a, SolverConfig(
        coarsening_near_null_dim=4, interp_near_null_dim=2,
        smoothing_iters=4, coarsest_dim=40, aggregation_iters=10,
        dense_threshold=0,
    ))
    mats = s.level_matrices()
    assert len(mats) == len(s.preconditioner.levels) >= 2
    rng = np.random.default_rng(1)
    for level, (a_l, p_l, r_l) in zip(s.preconditioner.levels, mats):
        for op, csr in ((level.a, a_l), (level.r, r_l), (level.p, p_l)):
            x = rng.standard_normal(csr.ncols)
            np.testing.assert_allclose(
                np.asarray(op.mv(jnp.asarray(x))), csr.matvec(x),
                rtol=1e-12, atol=1e-12,
            )
