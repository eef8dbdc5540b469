"""Multi-device sharding: sharded SpMV/CG/multigrid on the virtual
8-device CPU mesh (SURVEY.md §4.5, §7 stage 8)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_amg.linop import SparseOperator, aslinearoperator
from tpu_amg.parallel import (
    HaloELL,
    halo_spmv,
    make_solver_mesh,
    pad_ell_identity,
    shard_ell,
    shard_multigrid,
    shard_operator,
)
from tpu_amg.parallel.dist import shard_vector
from tpu_amg.solvers import cg
from tpu_amg.sparse import ELL
from tpu_amg.utils.problems import poisson1d, poisson2d


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest should provide 8 CPU devices"
    m = make_solver_mesh(8)
    # mesh context for sharded gathers (ell._row_gather); jax.set_mesh
    # returns a context object — exit it on teardown so later test
    # modules don't trace plain arrays under an active abstract mesh
    ctx = jax.set_mesh(m)
    yield m
    ctx.__exit__(None, None, None)


class TestShardedSpMV:
    def test_sharded_matches_single(self, mesh):
        a = poisson2d(16)  # 256 = 8 * 32
        ell = ELL.from_csr(a)
        sharded = shard_ell(ell, mesh)
        x = jnp.asarray(np.random.default_rng(0).normal(size=256))
        xs = shard_vector(x, mesh)
        y = jax.jit(lambda e, v: e.mv(v))(sharded, xs)
        np.testing.assert_allclose(np.asarray(y), a.matvec(np.asarray(x)))

    def test_pad_identity(self, mesh):
        a = poisson1d(12)  # 11 dofs -> pad to 16
        ell = pad_ell_identity(ELL.from_csr(a), 8)
        assert ell.nrows == 16
        x = jnp.asarray(np.random.default_rng(1).normal(size=16))
        y = np.asarray(ell.mv(x))
        np.testing.assert_allclose(y[:11], a.matvec(np.asarray(x[:11])))
        np.testing.assert_allclose(y[11:], np.asarray(x[11:]))

    def test_halo_spmv_matches(self, mesh):
        a = poisson2d(16)  # banded: bandwidth 16 < 32 local rows
        ell = ELL.from_csr(a)
        h = HaloELL.from_ell(ell, mesh)
        assert h.halo <= 16
        x = jnp.asarray(np.random.default_rng(2).normal(size=256))
        xs = shard_vector(x, mesh)
        y = halo_spmv(h, xs)
        np.testing.assert_allclose(
            np.asarray(y), a.matvec(np.asarray(x)), rtol=1e-12
        )

    def test_halo_spmm_matches(self, mesh):
        a = poisson2d(16)
        h = HaloELL.from_ell(ELL.from_csr(a), mesh)
        xs = jnp.asarray(np.random.default_rng(3).normal(size=(256, 4)))
        y = halo_spmv(h, shard_vector(xs, mesh))
        np.testing.assert_allclose(
            np.asarray(y), a.to_dense() @ np.asarray(xs), rtol=1e-12
        )

    def test_halo_dia_matches(self, mesh):
        from tpu_amg.parallel import HaloDIA
        from tpu_amg.sparse.dia import DIA

        a = poisson2d(16)
        h = HaloDIA.from_dia(DIA.from_csr(a), mesh)
        assert h.halo == 16
        x = jnp.asarray(np.random.default_rng(4).normal(size=256))
        y = halo_spmv(h, shard_vector(x, mesh))
        np.testing.assert_allclose(
            np.asarray(y), a.matvec(np.asarray(x)), rtol=1e-12
        )
        xs = jnp.asarray(np.random.default_rng(5).normal(size=(256, 3)))
        ys = halo_spmv(h, shard_vector(xs, mesh))
        np.testing.assert_allclose(
            np.asarray(ys), a.to_dense() @ np.asarray(xs), rtol=1e-12
        )

    def test_halo_rectangular_transfer(self, mesh):
        """Halo form of a grid-transfer operator: aggregate-ordered
        restriction (n_c, n_f) with both dims divisible by the mesh."""
        from tpu_amg.sparse import CSR

        n_f, n_c = 256, 32  # 8 fine nodes per coarse, aligned ordering
        rows = np.arange(n_f) // 8
        cols = np.arange(n_f)
        vals = np.full(n_f, 1 / np.sqrt(8.0))
        r = CSR.from_coo(rows, cols, vals, (n_c, n_f))
        h = HaloELL.from_ell(ELL.from_csr(r), mesh)
        assert h.shape == (n_c, n_f)
        x = jnp.asarray(np.random.default_rng(6).normal(size=n_f))
        y = halo_spmv(h, shard_vector(x, mesh))
        np.testing.assert_allclose(
            np.asarray(y), r.to_dense() @ np.asarray(x), rtol=1e-12
        )

    def test_halo_violation_raises(self, mesh):
        # dense-ish row spanning everything breaks the band assumption
        n = 64
        rows = np.concatenate([np.arange(n), np.zeros(n, dtype=int)])
        cols = np.concatenate([np.arange(n), np.arange(n)])
        vals = np.ones(2 * n)
        from tpu_amg.sparse import CSR

        a = CSR.from_coo(rows, cols, vals, (n, n))
        with pytest.raises(ValueError):
            HaloELL.from_ell(ELL.from_csr(a), mesh)


class TestShardedSolve:
    def test_sharded_cg_matches_replicated(self, mesh):
        a = poisson2d(16)
        op = aslinearoperator(a)
        b = jnp.ones(256)
        x_ref, info_ref = cg(op, b, rtol=1e-10)

        from tpu_amg.linop import SparseOperator

        sop = shard_operator(
            SparseOperator.from_csr(a, prefer_dia=False), mesh
        )
        bs = shard_vector(b, mesh)
        x_sh, info_sh = jax.jit(
            lambda a_, b_: cg(a_, b_, rtol=1e-10)
        )(sop, bs)
        np.testing.assert_allclose(
            np.asarray(x_sh), np.asarray(x_ref), atol=1e-8
        )
        assert abs(int(info_sh.iters) - int(info_ref.iters)) <= 1

    @pytest.mark.parametrize(
        "prefer_dia,smoother",
        [(True, "chebyshev"), (False, "chebyshev"), (True, "block")],
    )
    def test_sharded_vcycle_equals_replicated(self, mesh, prefer_dia, smoother):
        """The sharded V-cycle (halo fine level) must reproduce the
        replicated V-cycle numerically."""
        from tpu_amg.parallel.halo import HaloDIA, HaloELL

        mg, a = _build_algebraic_mg(prefer_dia=prefer_dia, smoother=smoother)
        mg_sharded = shard_multigrid(mg, mesh, replicate_below=256)
        # the fine level must actually be a halo-sharded operator
        fine_mat = mg_sharded.levels[0].a.ell
        assert isinstance(
            fine_mat, HaloDIA if prefer_dia else HaloELL
        ), type(fine_mat)

        r = jnp.asarray(np.random.default_rng(7).normal(size=256))
        z_ref = np.asarray(jax.jit(mg.mv)(r))
        z_sh = np.asarray(jax.jit(mg_sharded.mv)(shard_vector(r, mesh)))
        np.testing.assert_allclose(z_sh, z_ref, rtol=1e-10, atol=1e-12)

    def test_sharded_multigrid_pcg(self, mesh):
        """Full PCG with the *sharded* V-cycle as preconditioner matches
        the replicated solve (iterates and solution)."""
        mg, a = _build_algebraic_mg(prefer_dia=True)
        op = aslinearoperator(a)
        b = jnp.ones(256)
        x_ref, info_ref = cg(op, b, mg, rtol=1e-10)

        sop = shard_operator(
            SparseOperator.from_csr(a, prefer_dia=True), mesh
        )
        from tpu_amg.parallel.halo import HaloDIA

        assert isinstance(sop.ell, HaloDIA)
        mg_sharded = shard_multigrid(mg, mesh, replicate_below=256)
        bs = shard_vector(b, mesh)
        x_sh, info_sh = jax.jit(
            lambda a_, b_, m_: cg(a_, b_, m_, rtol=1e-10)
        )(sop, bs, mg_sharded)
        assert bool(info_sh.converged)
        assert int(info_sh.iters) == int(info_ref.iters)
        np.testing.assert_allclose(
            np.asarray(x_sh), np.asarray(x_ref), atol=1e-9
        )


def test_shard_multigrid_preserves_dtype(mesh):
    """Regression: _as_ell_operator re-derives BandedDense/BandedStack
    transfers as ELL for sharding — it must keep the build dtype (an f64
    rebuild of one f32 level poisons the whole sharded CG carry and
    breaks the while_loop dtype invariants)."""
    mg, _ = _build_algebraic_mg(prefer_dia=False, dtype=jnp.float32)
    # the setup must actually produce a non-ELL transfer to normalize
    from tpu_amg.sparse.banded import BandedDense, BandedStack

    kinds = {
        type(getattr(lvl, f).ell).__name__
        for lvl in mg.levels
        for f in ("r", "p")
        if hasattr(getattr(lvl, f), "ell")
    }
    assert kinds & {"BandedDense", "BandedStack"}, kinds
    mg_sharded = shard_multigrid(mg, mesh, replicate_below=0)
    float_dtypes = {
        leaf.dtype
        for leaf in jax.tree_util.tree_leaves(mg_sharded)
        if hasattr(leaf, "dtype") and jnp.issubdtype(leaf.dtype, jnp.inexact)
    }
    assert float_dtypes == {jnp.dtype(jnp.float32)}, float_dtypes


def _build_algebraic_mg(
    prefer_dia: bool, smoother: str = "chebyshev", dtype=jnp.float64
):
    """SA hierarchy + multigrid on poisson2d(16) (256 dofs, 8-divisible);
    fine level sharded, coarse levels replicated."""
    from tpu_amg.hierarchy import HierarchyConfig, create_weights
    from tpu_amg.interpolation import AggregationConfig, InterpolationConfig
    from tpu_amg.partition import PartitionerConfig
    from tpu_amg.preconditioners.multigrid_builder import MultigridConfig

    a = poisson2d(16)
    nn = np.ones((a.nrows, 1))
    hier = HierarchyConfig(
        coarsest_dim=16,
        max_levels=3,
        interpolation_config=InterpolationConfig(
            kind="aggregation",
            aggregation=AggregationConfig(
                candidate_dimension=1,
                partitioner_config=PartitionerConfig(
                    coarsening_factor=8.0, max_improvement_iters=5
                ),
            ),
        ),
    ).build(a, nn, create_weights(a, nn))
    mg = MultigridConfig(
        smoothing_steps=1,
        prefer_dia=prefer_dia,
        dense_threshold=0,
        smoother=smoother,
        dtype=dtype,
    ).build(hier)
    return mg, a


class TestSubMeshRedistribution:
    def test_fine_full_mesh_mid_submesh(self):
        """Coarse-grid redistribution: fine level sharded over the full
        (4, 2) mesh, a mid level over only the 'y' sub-axis (replicated
        across 'x'), coarsest fully replicated — one jitted solve with
        XLA inserting the cross-tier resharding collectives."""
        import jax
        from jax.sharding import PartitionSpec as P

        from tpu_amg.linop import SparseOperator
        from tpu_amg.parallel.dist import shard_ell, shard_vector
        from tpu_amg.sparse import ELL

        mesh = jax.make_mesh((4, 2), ("x", "y"))
        ctx = jax.set_mesh(mesh)  # restored below — leaks into later tests
        a = poisson2d(16)  # 256 dofs: 8 | full mesh
        fine = shard_ell(ELL.from_csr(a), mesh, axis=("x", "y"))
        mid_csr = poisson2d(8)  # 64 dofs: shard over y only
        mid = shard_ell(ELL.from_csr(mid_csr), mesh, axis=("y",))

        x_f = shard_vector(jnp.ones(256), mesh, axis=("x", "y"))
        x_m = shard_vector(jnp.ones(64), mesh, axis=("y",))

        @jax.jit
        def step(fine_, mid_, xf, xm):
            yf = fine_.mv(xf)
            ym = mid_.mv(xm)
            # cross-tier: restrict fine result onto mid size (toy: slice)
            from jax.sharding import reshard

            rf = reshard(yf, P())[:64]
            return jnp.sum(ym * rf)

        try:
            val = step(fine, mid, x_f, x_m)
            ref = float(
                np.dot(
                    mid_csr.matvec(np.ones(64)),
                    a.matvec(np.ones(256))[:64],
                )
            )
            np.testing.assert_allclose(float(val), ref, rtol=1e-10)
        finally:
            ctx.__exit__(None, None, None)


def _delaunay_system():
    """64² jittered-Delaunay graph Laplacian, RCM'd (4096 = 8 * 512)."""
    import scipy.sparse as sps
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(0)
    side = 64
    n_pts = side * side
    gx, gy = np.meshgrid(np.arange(side, dtype=np.float64),
                         np.arange(side, dtype=np.float64))
    pts = np.stack([gx.ravel(), gy.ravel()], 1)
    pts += rng.uniform(-0.35, 0.35, pts.shape)
    tri = Delaunay(pts[rng.permutation(n_pts)])
    e = np.concatenate([tri.simplices[:, [0, 1]],
                        tri.simplices[:, [1, 2]],
                        tri.simplices[:, [2, 0]]])
    i = np.concatenate([e[:, 0], e[:, 1]])
    j = np.concatenate([e[:, 1], e[:, 0]])
    a = sps.coo_matrix((np.ones(len(i)), (i, j)),
                       shape=(n_pts, n_pts)).tocsr()
    a.sum_duplicates()
    a.data[:] = -1.0
    a = (a + sps.diags(np.asarray(-a.sum(axis=1)).ravel() + 1e-8)).tocsr()
    p = reverse_cuthill_mckee(a, symmetric_mode=True)
    ap = a[p][:, p].tocsr()
    ap.sort_indices()
    return ap


def _unstructured_poisson_system():
    """utils.problems' 64² unstructured Poisson on another seed's mesh."""
    from tpu_amg.utils.problems import unstructured_poisson_2d

    return unstructured_poisson_2d(64, seed=1).to_scipy().tocsr()


class TestHaloELLUnstructured:
    """HaloELL — the distributed unstructured SpMV — against the
    single-device ELL and scipy on two RCM'd Delaunay systems."""

    SYSTEMS = {
        "delaunay": _delaunay_system,
        "unstructured_poisson": _unstructured_poisson_system,
    }

    def _halo(self, name, mesh):
        from tpu_amg.sparse.csr import CSR

        ap = self.SYSTEMS[name]()
        ell = ELL.from_csr(CSR.from_scipy(ap), dtype=jnp.float32)
        h = HaloELL.from_ell(ell, mesh)
        assert h.halo <= h.n_loc_rows
        return ap, ell, h

    @pytest.mark.parametrize("name", sorted(SYSTEMS))
    def test_halo_ell_matches_single(self, mesh, name):
        ap, ell, h = self._halo(name, mesh)
        x = np.random.default_rng(1).normal(size=ap.shape[0]).astype(
            np.float32)
        y = np.asarray(h.mv(shard_vector(jnp.asarray(x), mesh)))
        y_single = np.asarray(ell.mv(jnp.asarray(x)))
        ref = ap @ x
        np.testing.assert_allclose(
            y, y_single, rtol=0, atol=1e-5 * np.abs(ref).max()
        )
        np.testing.assert_allclose(
            y, ref, rtol=0, atol=2e-5 * np.abs(ref).max()
        )

    @pytest.mark.parametrize("name", sorted(SYSTEMS))
    def test_halo_ell_multivector(self, mesh, name):
        ap, ell, h = self._halo(name, mesh)
        xs = np.random.default_rng(2).normal(size=(ap.shape[0], 2)).astype(
            np.float32)
        ys = np.asarray(h.mm(shard_vector(jnp.asarray(xs), mesh)))
        ys_single = np.asarray(ell.mm(jnp.asarray(xs)))
        ref = ap @ xs
        np.testing.assert_allclose(
            ys, ys_single, rtol=0, atol=1e-5 * np.abs(ref).max()
        )
        np.testing.assert_allclose(
            ys, ref, rtol=0, atol=2e-5 * np.abs(ref).max()
        )
