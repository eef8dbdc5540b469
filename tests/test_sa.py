"""Smoothed aggregation + Galerkin coarsening (SURVEY.md §7 stage 5)."""

import numpy as np
import pytest

from tpu_amg.interpolation import AggregationConfig
from tpu_amg.interpolation.sa import (
    block_jacobi_smooth,
    smooth_interpolation,
    smoothed_aggregation,
)
from tpu_amg.partition import Partition, PartitionerConfig
from tpu_amg.utils.problems import elasticity_3d, poisson1d, poisson2d


def near_null_smooth(a, k=4, iters=10, seed=0):
    """Cheap near-null basis: l1-Jacobi-smoothed random vectors."""
    import jax.numpy as jnp

    from tpu_amg.linop import aslinearoperator
    from tpu_amg.preconditioners import ErrorPropagator, build_smoother

    op = aslinearoperator(a)
    m = build_smoother("l1", op.ell)
    e = ErrorPropagator(a=op, m=m, iters=iters)
    rng = np.random.default_rng(seed)
    v = np.concatenate(
        [np.ones((a.nrows, 1)), rng.normal(size=(a.nrows, k - 1))], axis=1
    )
    basis = np.asarray(e.mm(jnp.asarray(v)))
    q, _ = np.linalg.qr(basis)
    return q


class TestTentativeP:
    def test_partition_of_intervals_constant_preserved(self):
        # constant near-null, interval aggregates: P must exactly
        # reproduce the constant on the coarse grid (SA exactness on the
        # candidate space)
        a = poisson1d(33)
        n = 32
        part = Partition(np.arange(n) // 4)
        nn = np.ones((n, 1))
        g = smoothed_aggregation(a, part, nn, 1, 0)
        p = g.interpolation.to_dense()
        # P * coarse_nn == fine_nn (unsmoothed tentative P is exact on nn)
        recon = p @ g.coarse_nn
        np.testing.assert_allclose(recon, nn, atol=1e-12)

    def test_orthonormal_columns_per_aggregate(self):
        a = poisson1d(17)
        n = 16
        part = Partition(np.arange(n) // 4)
        nn = near_null_smooth(a, k=3)
        g = smoothed_aggregation(a, part, nn, 2, 0)
        p = g.interpolation.to_dense()
        ptp = p.T @ p
        np.testing.assert_allclose(ptp, np.eye(p.shape[1]), atol=1e-10)

    def test_exact_near_null_reproduction_multidim(self):
        a = poisson1d(33)
        n = 32
        part = Partition(np.arange(n) // 8)
        nn = near_null_smooth(a, k=3)
        g = smoothed_aggregation(a, part, nn, 3, 0)
        # with cd = k the whole candidate space is reproduced
        recon = g.interpolation.to_dense() @ g.coarse_nn
        np.testing.assert_allclose(recon, nn, atol=1e-10)

    def test_agg_too_small_raises(self):
        a = poisson1d(9)
        part = Partition(np.arange(8) // 2)  # size-2 aggs
        nn = near_null_smooth(a, k=4)
        with pytest.raises(ValueError):
            smoothed_aggregation(a, part, nn, 4, 0)


class TestSmoothing:
    def test_smooth_interpolation_formula(self):
        a = poisson1d(17)
        part = Partition(np.arange(16) // 4)
        nn = np.ones((16, 1))
        g = smoothed_aggregation(a, part, nn, 1, 0)
        p0 = smoothed_aggregation(a, part, nn, 1, 0).interpolation
        # smoothing_steps=0 then manual smoothing == smoothing_steps=1
        g0 = smoothed_aggregation(a, part, nn, 1, 0)
        ps = smooth_interpolation(a, g0.interpolation)
        ad, dd = a.to_dense(), np.diag(1.0 / a.diagonal())
        expected = (np.eye(16) - 0.66 * dd @ ad) @ g0.interpolation.to_dense()
        np.testing.assert_allclose(ps.to_dense(), expected, atol=1e-12)

    def test_block_jacobi_smooth_formula(self):
        a = elasticity_3d(3)
        n_blocks = a.nrows // 3
        part = Partition(np.arange(n_blocks) // 9)
        nn = near_null_smooth(a, k=6)
        g0 = smoothed_aggregation(a, part, nn, 6, 0)
        ps = block_jacobi_smooth(a, g0.interpolation)
        # dense check: D_b block diag inverse
        ad = a.to_dense()
        db = np.zeros_like(ad)
        for b in range(n_blocks):
            s = slice(3 * b, 3 * b + 3)
            db[s, s] = np.linalg.inv(ad[s, s])
        expected = (np.eye(a.nrows) - 0.66 * db @ ad) @ g0.interpolation.to_dense()
        np.testing.assert_allclose(ps.to_dense(), expected, atol=1e-9)


class TestGalerkin:
    def test_coarse_symmetric_spd(self):
        a = poisson2d(10)
        cfg = AggregationConfig(
            smoothing_steps=1,
            candidate_dimension=2,
            partitioner_config=PartitionerConfig(coarsening_factor=4.0),
        )
        nn = near_null_smooth(a, k=2)
        g = cfg.build(a, nn, np.ones(2))
        ac = g.coarse_mat.to_dense()
        np.testing.assert_allclose(ac, ac.T, atol=1e-10)
        w = np.linalg.eigvalsh(ac)
        assert w.min() > 0

    def test_coarse_dims_consistent(self):
        a = poisson2d(8)
        nn = near_null_smooth(a, k=2)
        cfg = AggregationConfig(
            candidate_dimension=2,
            partitioner_config=PartitionerConfig(coarsening_factor=4.0),
        )
        g = cfg.build(a, nn, np.ones(2))
        n_aggs = g.partition.num_aggs
        assert g.coarse_mat.shape == (2 * n_aggs, 2 * n_aggs)
        assert g.interpolation.shape == (64, 2 * n_aggs)
        assert g.coarse_nn.shape[0] == 2 * n_aggs
        assert g.coarse_mat.block_size == 2


class TestTruncation:
    def test_truncate_drops_and_preserves_l1(self):
        from tpu_amg.interpolation.sa import truncate_prolongator
        from tpu_amg.sparse import CSR

        rng = np.random.default_rng(1)
        dense = rng.normal(size=(20, 8)) * (rng.random((20, 8)) < 0.6)
        dense[3] = 0.0  # empty row survives
        p = CSR.from_dense(dense, tol=0.0).eliminate_zeros()
        t = truncate_prolongator(p, 0.3)
        td = t.to_dense()
        pd = p.to_dense()
        # every kept entry is >= 0.3*rowmax in the original
        rowmax = np.abs(pd).max(axis=1)
        kept = np.abs(td) > 0
        orig_small = np.abs(pd) < 0.3 * rowmax[:, None]
        assert not (kept & orig_small).any()
        # row L1 mass preserved
        np.testing.assert_allclose(
            np.abs(td).sum(1), np.abs(pd).sum(1), rtol=1e-12
        )

    def test_truncated_hierarchy_converges_and_sparser(self):
        """Truncation must cut Galerkin fill without breaking SA
        convergence (3-D is where the fill explodes)."""
        import jax.numpy as jnp

        from tpu_amg.solver import AMGSolver, SolverConfig
        from tpu_amg.solvers import cg
        from tpu_amg.utils.problems import poisson3d

        a = poisson3d(12)
        common = dict(
            coarsening_near_null_dim=4, interp_near_null_dim=2,
            coarsening_factor=16.0, smoothing_iters=5, coarsest_dim=100,
            dtype=jnp.float64, seed=0,
        )
        plain = AMGSolver.setup(a, SolverConfig(**common))
        trunc = AMGSolver.setup(
            a, SolverConfig(sa_trunc_tol=0.1, **common)
        )
        assert trunc.hierarchy.op_complexity() <= (
            plain.hierarchy.op_complexity()
        )
        x_true = np.random.default_rng(0).normal(size=a.nrows)
        b = trunc.op.mv(jnp.asarray(x_true))
        x, info = cg(trunc.op, b, trunc.preconditioner, rtol=1e-8,
                     maxiter=60)
        assert bool(info.converged)
        relerr = np.linalg.norm(np.asarray(x) - x_true) / np.linalg.norm(
            x_true
        )
        assert relerr < 1e-6
