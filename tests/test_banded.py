"""BandedDense (dense-slab window) format tests — the batched-matmul path for
gather-hostile operators like smoothed-SA transfers (R rows hold
hundreds of entries dense within a column window)."""

import numpy as np
import pytest
import scipy.sparse as sps

from tpu_amg.sparse.banded import BandedDense, BandedUnsupported
from tpu_amg.sparse.csr import CSR


def _smoothed_r_like(n=300, nc=4000, seed=0):
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for i in range(n):
        c0 = int(i * (nc - 600) / n)
        cset = c0 + np.unique(rng.integers(0, 550, size=400))
        rows += [i] * len(cset)
        cols += list(cset)
        vals += list(rng.standard_normal(len(cset)))
    return sps.coo_matrix((vals, (rows, cols)), shape=(n, nc)).tocsr()


class TestBandedDense:
    def test_mv_mm_match_scipy(self):
        sp = _smoothed_r_like()
        b = BandedDense.from_csr(CSR.from_scipy(sp))
        rng = np.random.default_rng(1)
        x = rng.standard_normal(sp.shape[1]).astype(np.float32)
        ref = sp @ x
        np.testing.assert_allclose(
            np.asarray(b.mv(np.asarray(x))), ref,
            atol=3e-6 * np.abs(ref).max(), rtol=0,
        )
        xs = rng.standard_normal((sp.shape[1], 3)).astype(np.float32)
        refs = sp @ xs
        np.testing.assert_allclose(
            np.asarray(b.mm(np.asarray(xs))), refs,
            atol=3e-6 * np.abs(refs).max(), rtol=0,
        )

    def test_square_interface(self):
        sq = (
            sps.diags(np.arange(1, 301).astype(float))
            + sps.random(300, 300, density=0.3, random_state=1)
        ).tocsr()
        b = BandedDense.from_csr(CSR.from_scipy(sq), dtype=np.float64)
        np.testing.assert_allclose(np.asarray(b.diagonal()), sq.diagonal())
        np.testing.assert_allclose(
            np.asarray(b.row_sums()), np.asarray(sq.sum(axis=1)).ravel()
        )
        np.testing.assert_allclose(
            np.asarray(b.abs_row_sums()),
            np.asarray(abs(sq).sum(axis=1)).ravel(),
        )

    def test_inflation_gate(self):
        # scattered sparse rows: slabs would dwarf nnz — must refuse
        rng = np.random.default_rng(2)
        n = 4000
        i = np.repeat(np.arange(n), 3)
        j = rng.integers(0, n, 3 * n)
        sp = sps.coo_matrix((np.ones(3 * n), (i, j)), shape=(n, n)).tocsr()
        with pytest.raises(BandedUnsupported):
            BandedDense.from_csr(CSR.from_scipy(sp), max_inflation=6.0)

    def test_from_csr_dispatch_picks_banded(self):
        import jax.numpy as jnp

        from tpu_amg.linop import SparseOperator
        from tpu_amg.sparse.banded import BandedDense as BD

        sp = _smoothed_r_like()
        op = SparseOperator.from_csr(
            CSR.from_scipy(sp), dtype=jnp.float32
        )
        assert isinstance(op.ell, BD)

    def test_transpose_apply(self):
        sp = _smoothed_r_like(n=200, nc=3000, seed=3)
        b = BandedDense.from_csr(CSR.from_scipy(sp))
        rng = np.random.default_rng(4)
        y = rng.standard_normal(sp.shape[0]).astype(np.float32)
        ref = sp.T @ y
        np.testing.assert_allclose(
            np.asarray(b.rmv(np.asarray(y))), ref,
            atol=3e-6 * np.abs(ref).max(), rtol=0,
        )
        ys = rng.standard_normal((sp.shape[0], 3)).astype(np.float32)
        refs = sp.T @ ys
        np.testing.assert_allclose(
            np.asarray(b.rmm(np.asarray(ys))), refs,
            atol=3e-6 * np.abs(refs).max(), rtol=0,
        )


def _hub_prolongation_like(n=6000, nc=1500, seed=5):
    """P-like rectangular matrix: a few hub rows (50 entries) among
    mean-4 rows — ELL pads to k=50, 12x the mean (the gather-hostile
    shape of smoothed-SA prolongations)."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for i in range(n):
        c0 = int(i * (nc - 80) / n)
        k = 50 if i % 997 == 0 else 4
        cset = c0 + np.unique(rng.integers(0, 60, size=k))
        rows += [i] * len(cset)
        cols += list(cset)
        vals += list(rng.standard_normal(len(cset)))
    return sps.coo_matrix((vals, (rows, cols)), shape=(n, nc)).tocsr()


class TestGatherHostileDispatch:
    """Gather-hostile routing (linop._pick_format): operators whose ELL
    padding exceeds 3x nnz take the windowed-slab path even below the
    24-nnz/row density gate (a 262k smoothed-SA P measured 98 ms as an
    ELL gather vs 4.6 ms as slabs)."""

    def test_rectangular_hub_rows_take_slabs(self):
        import jax.numpy as jnp

        from tpu_amg.linop import SparseOperator
        from tpu_amg.sparse.banded import BandedDense, BandedStack

        sp = _hub_prolongation_like()
        op = SparseOperator.from_csr(
            CSR.from_scipy(sp), dtype=jnp.float32
        )
        assert isinstance(op.ell, (BandedDense, BandedStack)), type(op.ell)
        rng = np.random.default_rng(6)
        x = rng.standard_normal(sp.shape[1]).astype(np.float32)
        ref = sp @ x
        np.testing.assert_allclose(
            np.asarray(op.mv(np.asarray(x))), ref,
            atol=3e-6 * np.abs(ref).max(), rtol=0,
        )

    def test_uniform_narrow_rows_stay_ell(self):
        import jax.numpy as jnp

        from tpu_amg.linop import SparseOperator
        from tpu_amg.sparse.ell import ELL

        # uniform 4-entry rows: ELL padding is ~1x, gather stays
        rng = np.random.default_rng(7)
        n, nc = 3000, 800
        rows = np.repeat(np.arange(n), 4)
        cols = (rows * nc // n + rng.integers(0, 40, 4 * n)) % nc
        sp = sps.coo_matrix(
            (np.ones(4 * n), (rows, cols)), shape=(n, nc)
        ).tocsr()
        op = SparseOperator.from_csr(
            CSR.from_scipy(sp), dtype=jnp.float32
        )
        assert isinstance(op.ell, ELL)

    def test_stack_bucket_precompute_matches_direct(self):
        # the _rb16 shared-pass bucket derivation must agree with a
        # from-scratch per-bucket build
        sp = _hub_prolongation_like(n=2000, nc=600, seed=8)
        csr = CSR.from_scipy(sp)
        stack = BandedDense.stack_from_csr(csr, max_inflation=64.0)
        rng = np.random.default_rng(9)
        x = rng.standard_normal(sp.shape[1]).astype(np.float32)
        ref = sp @ x
        np.testing.assert_allclose(
            np.asarray(stack.mv(np.asarray(x))), ref,
            atol=3e-6 * np.abs(ref).max(), rtol=0,
        )
        back = stack.to_csr().to_scipy()
        # slabs store f32 — round-trip matches to f32 precision
        assert (abs(back - sp) > 1e-6 * abs(sp).max()).nnz == 0
