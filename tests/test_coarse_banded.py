"""BandedCholeskySolver — the sparse coarsest-level direct solve
(role of the reference's SparseCholeskySolve, coarse_solvers.rs:166-276).
"""

import numpy as np
import pytest
import scipy.sparse as sps

from tpu_amg.preconditioners.coarse import (
    BandedCholeskySolver,
    build_coarse_solver,
)
from tpu_amg.sparse.csr import CSR


def _poisson2d_scrambled(nx, seed=0):
    """2-D Poisson with a random node relabeling (so RCM has real work)."""
    n = nx * nx
    d = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx))
    eye = sps.identity(nx)
    a = (sps.kron(d, eye) + sps.kron(eye, d)).tocsr()
    rng = np.random.default_rng(seed)
    p = rng.permutation(n)
    a = a[p][:, p].tocsr()
    a.sort_indices()
    return a


class TestBandedCholesky:
    def test_matches_direct_solve(self):
        a = _poisson2d_scrambled(40)
        solver = BandedCholeskySolver.build(CSR.from_scipy(a))
        rng = np.random.default_rng(1)
        x = rng.standard_normal(a.shape[0])
        y = np.asarray(solver.mv(x))
        ref = sps.linalg.spsolve(a.tocsc(), x)
        np.testing.assert_allclose(y, ref, rtol=1e-8, atol=1e-8)

    def test_multi_rhs(self):
        a = _poisson2d_scrambled(24, seed=2)
        solver = BandedCholeskySolver.build(CSR.from_scipy(a))
        rng = np.random.default_rng(3)
        xs = rng.standard_normal((a.shape[0], 3))
        ys = np.asarray(solver.mm(xs))
        for j in range(3):
            ref = sps.linalg.spsolve(a.tocsc(), xs[:, j])
            np.testing.assert_allclose(ys[:, j], ref, rtol=1e-8, atol=1e-8)

    def test_dispatch_above_dense_cap(self, monkeypatch):
        # cholesky auto-switches to the banded factorization past the
        # dense cap instead of raising
        import tpu_amg.preconditioners.coarse as coarse_mod

        monkeypatch.setattr(coarse_mod, "DENSE_COARSE_CAP", 500)
        a = _poisson2d_scrambled(32, seed=4)  # 1024 > 500
        solver = build_coarse_solver("cholesky", CSR.from_scipy(a))
        assert isinstance(solver, BandedCholeskySolver)
        x = np.random.default_rng(5).standard_normal(a.shape[0])
        ref = sps.linalg.spsolve(a.tocsc(), x)
        np.testing.assert_allclose(
            np.asarray(solver.mv(x)), ref, rtol=1e-8, atol=1e-8
        )

    def test_explicit_kind(self):
        a = _poisson2d_scrambled(16, seed=6)
        solver = build_coarse_solver("banded", CSR.from_scipy(a))
        assert isinstance(solver, BandedCholeskySolver)

    def test_rejects_unbanded(self):
        from tpu_amg.errors import MultigridBuildError

        rng = np.random.default_rng(7)
        n, m = 3000, 6000
        i = rng.integers(0, n, m)
        j = rng.integers(0, n, m)
        a = sps.coo_matrix((np.ones(m), (i, j)), shape=(n, n))
        a = (a + a.T + 50 * sps.identity(n)).tocsr()
        with pytest.raises(MultigridBuildError, match="bandwidth"):
            BandedCholeskySolver.build(CSR.from_scipy(a), max_bandwidth=64)

    def test_jit_apply(self):
        import jax

        a = _poisson2d_scrambled(20, seed=8)
        solver = BandedCholeskySolver.build(CSR.from_scipy(a))
        x = np.random.default_rng(9).standard_normal(a.shape[0])
        y = np.asarray(jax.jit(lambda s, v: s.mv(v))(solver, x))
        ref = sps.linalg.spsolve(a.tocsc(), x)
        np.testing.assert_allclose(y, ref, rtol=1e-8, atol=1e-8)
