"""Adaptive/bootstrap AMG + composite preconditioner + rand-SVD
(SURVEY.md §7 stage 6)."""

import jax
import jax.numpy as jnp
import numpy as np

from tpu_amg.adaptivity import AdaptiveConfig, find_near_null, smooth_vector
from tpu_amg.decompositions import rand_svd
from tpu_amg.hierarchy import HierarchyConfig
from tpu_amg.interpolation import AggregationConfig, InterpolationConfig
from tpu_amg.linop import DenseOperator, DiagonalOperator, aslinearoperator
from tpu_amg.partition import PartitionerConfig
from tpu_amg.preconditioners import Composite, build_smoother
from tpu_amg.preconditioners.multigrid_builder import MultigridConfig
from tpu_amg.preconditioners.smoothers import ErrorPropagator, l1_inverse_diag
from tpu_amg.solvers import cg
from tpu_amg.utils.problems import anisotropic_diffusion_2d, poisson2d
from tpu_amg.utils.testing import symmetry_test


class TestSmoothVector:
    def test_orthonormal_output(self):
        a = poisson2d(8)
        op = aslinearoperator(a)
        m = build_smoother("l1", op.ell)
        basis, cfs = smooth_vector(op, m, 10, 4, jax.random.PRNGKey(0))
        np.testing.assert_allclose(basis.T @ basis, np.eye(4), atol=1e-10)
        assert (cfs > 0).all() and (cfs < 1).all()

    def test_captures_smooth_modes(self):
        # after smoothing, basis should be rich in low-frequency content:
        # projection of the constant onto span(basis) should be large
        a = poisson2d(8)
        op = aslinearoperator(a)
        m = build_smoother("l1", op.ell)
        basis, _ = smooth_vector(op, m, 30, 4, jax.random.PRNGKey(1))
        const = np.ones(64) / 8.0
        proj = np.linalg.norm(basis.T @ const)
        assert proj > 0.8  # most of the constant lives in the basis


class TestFindNearNull:
    def test_shapes_and_quality(self):
        a = poisson2d(8)
        nn = find_near_null(a, 10, 3, 16.0, jax.random.PRNGKey(0))
        assert nn.shape == (64, 3)
        assert np.isfinite(nn).all()


class TestComposite:
    def test_single_component_equals_component(self):
        a = poisson2d(6)
        op = aslinearoperator(a)
        m = build_smoother("l1", op.ell)
        comp = Composite(a=op, components=(m,))
        x = jnp.asarray(np.random.default_rng(0).normal(size=36))
        # single component: reversed + skip-first = just the component once
        np.testing.assert_allclose(
            np.asarray(comp.mv(x)), np.asarray(m.mv(x)), rtol=1e-12
        )

    def test_two_components_sweep_order(self):
        # out after sweep [M1, M0, M1] (reversed [M1,M0], forward skip
        # first [M1]) — verify against hand-rolled sweep
        a = poisson2d(6)
        op = aslinearoperator(a)
        m0 = build_smoother("l1", op.ell)
        m1 = build_smoother("jacobi", op.ell, omega=0.5)
        comp = Composite(a=op, components=(m0, m1))
        x = jnp.asarray(np.random.default_rng(1).normal(size=36))
        out = jnp.zeros(36)
        ws = x
        for m in (m1, m0, m1):
            out = out + m.mv(ws)
            ws = x - op.mv(out)
        np.testing.assert_allclose(
            np.asarray(comp.mv(x)), np.asarray(out), rtol=1e-12
        )

    def test_composite_symmetric(self):
        a = poisson2d(6)
        op = aslinearoperator(a)
        m0 = build_smoother("l1", op.ell)
        m1 = build_smoother("jacobi", op.ell, omega=0.5)
        comp = Composite(a=op, components=(m0, m1))
        assert symmetry_test(comp, rtol=1e-9)


class TestAdaptiveBuild:
    def test_two_component_composite_beats_one(self):
        a = anisotropic_diffusion_2d(12, epsilon=1e-2, theta=np.pi / 7)
        cfg = AdaptiveConfig(
            hierarchy_config=HierarchyConfig(
                coarsest_dim=30,
                interpolation_config=InterpolationConfig(
                    kind="aggregation",
                    aggregation=AggregationConfig(
                        candidate_dimension=2,
                        partitioner_config=PartitionerConfig(
                            coarsening_factor=4.0, max_improvement_iters=10
                        ),
                    ),
                ),
            ),
            multigrid_config=MultigridConfig(
                smoothing_steps=1,
                smoother_partitioner=PartitionerConfig(
                    coarsening_factor=16.0, max_improvement_iters=10
                ),
            ),
            max_components=2,
            test_iters=10,
            coarsening_near_null_dim=4,
        )
        comp = cfg.build(a, jax.random.PRNGKey(0))
        assert len(comp.components) == 2
        op = comp.a
        b = jnp.ones(a.nrows)
        _, info2 = cg(op, b, comp, rtol=1e-10)
        one = Composite(a=op, components=comp.components[:1])
        _, info1 = cg(op, b, one, rtol=1e-10)
        assert bool(info2.converged)
        assert int(info2.iters) <= int(info1.iters) + 1


class TestRandSVD:
    def test_manufactured_decay(self):
        """reference rand_svd_test example (examples/rand_svd_test.rs):
        A = U diag(e^{-0.1 i}) Vᵀ (200×150), recover k=50."""
        rng = np.random.default_rng(0)
        m, n, k = 200, 150, 50
        u, _ = np.linalg.qr(rng.normal(size=(m, m)))
        v, _ = np.linalg.qr(rng.normal(size=(n, n)))
        s = np.exp(-0.1 * np.arange(n))
        a = (u[:, :n] * s) @ v.T
        op = DenseOperator(mat=jnp.asarray(a))
        uu, ss, vv = rand_svd(op, jax.random.PRNGKey(0), k, 10, 2)
        uu, ss, vv = np.asarray(uu), np.asarray(ss), np.asarray(vv)
        # subspace alignment score (rand_svd_test.rs:88-105)
        align_u = np.linalg.norm(u[:, :k].T @ uu) ** 2 / k
        align_v = np.linalg.norm(v[:, :k].T @ vv) ** 2 / k
        sigma_ratio = ss.sum() / s[:k].sum()
        assert align_u > 0.95
        assert align_v > 0.95
        assert 0.97 < sigma_ratio <= 1.001

    def test_error_propagator_near_null(self):
        from tpu_amg.decompositions import smooth_vector_rand_svd

        a = poisson2d(8)
        op = aslinearoperator(a)
        m = DiagonalOperator(diag=l1_inverse_diag(op.ell))
        e = ErrorPropagator(a=op, m=m, iters=1)
        v = smooth_vector_rand_svd(e, jax.random.PRNGKey(0), 4, 5)
        v = np.asarray(v)
        assert v.shape == (64, 4)
        # dominant modes of E are smooth: energy (Rayleigh quotient)
        # much lower than random vectors
        rq = np.einsum("nk,nk->k", v, a.matvec(v)) / np.einsum(
            "nk,nk->k", v, v
        )
        assert rq.max() < 2.0  # smooth modes of Poisson have small RQ


class TestDeviceBootstrapPath:
    """With an accelerator present, find_near_null builds its f32
    smoothing operator through ``SparseOperator.from_csr`` — the format
    decision every other operator gets — and lets build errors raise.
    The CPU stands in for the accelerator here."""

    def _spy(self, monkeypatch, fail: bool):
        import tpu_amg.adaptivity as adaptivity
        from tpu_amg.linop import SparseOperator

        calls = []
        real = SparseOperator.from_csr

        def spy(csr, dtype=jnp.float64, **kw):
            calls.append((csr.nrows, jnp.dtype(dtype)))
            if fail:
                raise RuntimeError("device format build failed")
            return real(csr, dtype=dtype, **kw)

        monkeypatch.setattr(SparseOperator, "from_csr", staticmethod(spy))
        monkeypatch.setattr(
            adaptivity, "_accel_device", lambda: jax.devices("cpu")[0]
        )
        return calls

    def test_build_error_raises(self, monkeypatch):
        import pytest

        a = poisson2d(182)  # 33,124 rows >= 2**15
        calls = self._spy(monkeypatch, fail=True)
        with pytest.raises(RuntimeError, match="device format build failed"):
            find_near_null(a, 2, 3, 16.0, jax.random.PRNGKey(0))
        assert calls == [(a.nrows, jnp.dtype(jnp.float32))]

    def test_small_system_keeps_f64(self, monkeypatch):
        a = poisson2d(16)
        calls = self._spy(monkeypatch, fail=False)
        nn = find_near_null(a, 2, 3, 16.0, jax.random.PRNGKey(0))
        assert nn.shape == (a.nrows, 3)
        assert calls and all(dt == jnp.float64 for _, dt in calls)

    def test_f32_path_runs(self, monkeypatch):
        a = poisson2d(182)
        calls = self._spy(monkeypatch, fail=False)
        nn = find_near_null(a, 2, 3, 16.0, jax.random.PRNGKey(0))
        assert calls[0] == (a.nrows, jnp.dtype(jnp.float32))
        assert nn.shape == (a.nrows, 3) and np.isfinite(nn).all()
