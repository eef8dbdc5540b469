"""Hierarchy checkpoint/resume round-trip."""

import jax.numpy as jnp
import numpy as np

from tpu_amg.hierarchy import HierarchyConfig
from tpu_amg.linop import aslinearoperator
from tpu_amg.preconditioners.multigrid_builder import MultigridConfig
from tpu_amg.solvers import cg
from tpu_amg.utils.checkpoint import load_hierarchy, save_hierarchy
from tpu_amg.utils.problems import poisson2d


def test_roundtrip_and_resume(tmp_path):
    from tests.test_hierarchy import near_null_basis, sa_config

    a = poisson2d(12)
    nn = near_null_basis(a, k=2)
    h = HierarchyConfig(coarsest_dim=20, interpolation_config=sa_config()).build(
        a, nn
    )
    save_hierarchy(tmp_path / "h.npz", h)
    h2 = load_hierarchy(tmp_path / "h.npz")

    assert h2.num_levels == h.num_levels
    for lvl in range(h.num_levels):
        np.testing.assert_array_equal(
            h2.matrices[lvl].data, h.matrices[lvl].data
        )
        np.testing.assert_array_equal(
            h2.near_nulls[lvl], h.near_nulls[lvl]
        )
    assert h2.op_complexity() == h.op_complexity()

    # resume: build a multigrid from the loaded hierarchy and solve
    mg = MultigridConfig(
        smoother="chebyshev",
    ).build(h2)
    op = aslinearoperator(a)
    b = jnp.ones(a.nrows)
    _, info = cg(op, b, mg, rtol=1e-8)
    assert bool(info.converged)


def test_adaptive_composite_roundtrip(tmp_path):
    """The adaptive composite's per-component hierarchies round-trip and
    the reloaded solver applies the same preconditioner."""
    from tpu_amg.solver import AMGSolver, SolverConfig

    a = poisson2d(12)
    cfg = SolverConfig(
        method="adaptive",
        composite_components=2,
        coarsening_near_null_dim=4,
        smoothing_iters=5,
        coarsest_dim=20,
        smoother="chebyshev",
    )
    solver = AMGSolver.setup(a, cfg)
    assert len(solver.component_hierarchies) == 2
    solver.save(tmp_path / "comp.npz")

    solver2 = AMGSolver.load(tmp_path / "comp.npz", a, cfg)
    assert len(solver2.preconditioner.components) == 2
    r = np.random.default_rng(3).normal(size=a.nrows)
    z1 = np.asarray(solver.apply_preconditioner(r))
    z2 = np.asarray(solver2.apply_preconditioner(r))
    np.testing.assert_allclose(z2, z1, rtol=1e-12, atol=1e-14)

    x, info = solver2.solve(jnp.ones(a.nrows), rtol=1e-8)
    assert bool(info.converged)
