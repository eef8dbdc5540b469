"""Hierarchy construction + algebraic multigrid end-to-end
(SURVEY.md §7 stages 5-6)."""

import jax.numpy as jnp
import numpy as np
import pytest

from tpu_amg.hierarchy import HierarchyConfig, create_weights
from tpu_amg.interpolation import AggregationConfig, InterpolationConfig
from tpu_amg.linop import aslinearoperator
from tpu_amg.partition import PartitionerConfig
from tpu_amg.preconditioners.multigrid_builder import MultigridConfig
from tpu_amg.solvers import cg
from tpu_amg.utils.problems import poisson2d
from tpu_amg.utils.testing import approx_convergence_factor, symmetry_test


def sa_config(cf=4.0, cd=2):
    return InterpolationConfig(
        kind="aggregation",
        aggregation=AggregationConfig(
            candidate_dimension=cd,
            partitioner_config=PartitionerConfig(
                coarsening_factor=cf, max_improvement_iters=10
            ),
        ),
    )


def near_null_basis(a, k=4, iters=15, seed=0):
    from tests.test_sa import near_null_smooth

    return near_null_smooth(a, k=k, iters=iters, seed=seed)


@pytest.fixture(scope="module")
def poisson_hierarchy():
    a = poisson2d(16)  # 256 dofs
    nn = near_null_basis(a, k=2)
    cfg = HierarchyConfig(
        coarsest_dim=40, interpolation_config=sa_config(cf=4.0, cd=2)
    )
    return a, cfg.build(a, nn)


class TestHierarchy:
    def test_levels_and_complexities(self, poisson_hierarchy):
        a, h = poisson_hierarchy
        assert h.num_levels >= 2
        assert h.matrices[-1].nrows <= 40 or h.num_levels > 1
        assert 1.0 < h.grid_complexity() < 3.0
        assert 1.0 < h.op_complexity() < 4.0

    def test_coarse_near_null_orthonormal(self, poisson_hierarchy):
        _, h = poisson_hierarchy
        for lvl in range(1, h.num_levels):
            nn = h.get_near_null(lvl)
            np.testing.assert_allclose(
                nn.T @ nn, np.eye(nn.shape[1]), atol=1e-10
            )

    def test_weights_recomputed_per_level(self, poisson_hierarchy):
        _, h = poisson_hierarchy
        assert len(h.nn_weights) == h.num_levels
        for lvl in range(h.num_levels):
            w = h.get_nn_weights(lvl)
            expected = create_weights(h.get_op(lvl), h.get_near_null(lvl))
            np.testing.assert_allclose(w, expected)

    def test_galerkin_property(self, poisson_hierarchy):
        _, h = poisson_hierarchy
        for lvl in range(h.num_levels - 1):
            af = h.get_op(lvl).to_dense()
            p = h.get_interpolation(lvl).to_dense()
            ac = h.get_op(lvl + 1).to_dense()
            np.testing.assert_allclose(ac, p.T @ af @ p, atol=1e-9)

    def test_max_levels_respected(self):
        a = poisson2d(16)
        nn = near_null_basis(a, k=2)
        cfg = HierarchyConfig(
            coarsest_dim=4,
            max_levels=2,
            interpolation_config=sa_config(),
        )
        h = cfg.build(a, nn)
        assert h.num_levels == 2


class TestAlgebraicMultigrid:
    def test_amg_pcg_converges_fast(self, poisson_hierarchy):
        a, h = poisson_hierarchy
        mg = MultigridConfig(
            smoothing_steps=1,
            smoother_partitioner=PartitionerConfig(
                coarsening_factor=16.0, max_improvement_iters=10
            ),
        ).build(h)
        op = aslinearoperator(a)
        b = jnp.ones(a.nrows)
        _, info = cg(op, b, mg, rtol=1e-10)
        assert bool(info.converged)
        assert int(info.iters) <= 25

    def test_amg_symmetric(self, poisson_hierarchy):
        a, h = poisson_hierarchy
        mg = MultigridConfig(
            smoother_partitioner=PartitionerConfig(
                coarsening_factor=16.0, max_improvement_iters=5
            )
        ).build(h)
        assert symmetry_test(mg, rtol=1e-8)

    def test_convergence_factor_below_one(self, poisson_hierarchy):
        a, h = poisson_hierarchy
        mg = MultigridConfig(
            smoother_partitioner=PartitionerConfig(
                coarsening_factor=16.0, max_improvement_iters=5
            )
        ).build(h)
        op = aslinearoperator(a)
        cf = approx_convergence_factor(op, mg, num_iters=30)
        assert cf < 0.9


class TestCoarseDrop:
    def test_coarse_drop_sparsifies_and_converges(self):
        """Non-Galerkin coarse sparsification (coarse_drop_tol) must cut
        coarse-level fill without hurting convergence materially."""
        import jax.numpy as jnp
        import numpy as np

        from tpu_amg.solver import AMGSolver, SolverConfig
        from tpu_amg.solvers import cg
        from tpu_amg.utils.problems import poisson3d

        a = poisson3d(14)
        common = dict(
            coarsening_near_null_dim=4, interp_near_null_dim=2,
            coarsening_factor=16.0, smoothing_iters=5, coarsest_dim=100,
            dtype=jnp.float64, sa_trunc_tol=0.1, seed=0,
        )
        plain = AMGSolver.setup(a, SolverConfig(**common))
        drop = AMGSolver.setup(
            a, SolverConfig(coarse_drop_tol=0.01, **common)
        )
        assert (
            drop.hierarchy.op_complexity()
            < plain.hierarchy.op_complexity()
        )
        x_true = np.random.default_rng(0).normal(size=a.nrows)
        b = drop.op.mv(jnp.asarray(x_true))
        x, info = cg(drop.op, b, drop.preconditioner, rtol=1e-8,
                     maxiter=60)
        assert bool(info.converged)

    def test_coarse_drop_block_matrix_stays_spd(self):
        """Block (elasticity-like) hierarchies must survive dropping:
        intra-block entries are protected so the bs x bs diagonal
        blocks stay invertible (block_jacobi_smooth raises otherwise).
        """
        import jax.numpy as jnp

        from tpu_amg.solver import AMGSolver, SolverConfig
        from tpu_amg.utils.problems import elasticity_3d

        a = elasticity_3d(7)
        s = AMGSolver.setup(a, SolverConfig(
            coarsening_near_null_dim=8, interp_near_null_dim=6,
            coarsening_factor=8.0, smoothing_iters=5, coarsest_dim=200,
            dtype=jnp.float64, sa_trunc_tol=0.05, coarse_drop_tol=0.02,
            seed=0,
        ))
        assert len(s.hierarchy.matrices) >= 2
