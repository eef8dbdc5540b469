"""Device-format choice (``SparseOperator.from_csr``) against scipy on the
matrix classes the solver meets: banded and wide-band unstructured
matrices, hub rows, structured stencils, rectangular transfers, duplicate
column entries and unbanded matrices.  The choice depends on the matrix
alone, never on the platform."""

import numpy as np
import pytest
import scipy.sparse as sps

import jax
import jax.numpy as jnp

from tpu_amg.linop import SparseOperator
from tpu_amg.sparse import CSR
from tpu_amg.utils.problems import poisson3d


def _random_banded(n=3000, band=40, per_row=9, seed=0):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), per_row)
    cols = np.clip(rows + rng.integers(-band, band + 1, rows.size), 0, n - 1)
    a = sps.coo_matrix((rng.standard_normal(rows.size), (rows, cols)),
                       shape=(n, n)).tocsr()
    return a + sps.eye(n) * 10.0


def _wide_band():
    return _random_banded(n=4096, band=1500, per_row=12, seed=1)


def _hub_rows():
    # a few rows hold ~300 entries, the rest ~6: ELL would pad every row
    # to the hub row
    a = _random_banded(n=4000, band=20, per_row=6, seed=2).tolil()
    rng = np.random.default_rng(3)
    for r in (5, 1700, 3999):
        a[r, rng.choice(4000, 300, replace=False)] = 1.0
    return a.tocsr()


def _structured_poisson():
    return poisson3d(12).to_scipy().tocsr()


def _rectangular():
    rng = np.random.default_rng(4)
    n, nc = 3000, 400
    rows = np.repeat(np.arange(n), 3)
    cols = np.minimum(rows // 8 + rng.integers(0, 3, rows.size), nc - 1)
    return sps.coo_matrix((rng.random(rows.size), (rows, cols)),
                          shape=(n, nc)).tocsr()


def _duplicate_columns():
    rng = np.random.default_rng(5)
    n = 2000
    rows = np.repeat(np.arange(n), 8)
    cols = np.clip(rows + rng.integers(-3, 4, rows.size), 0, n - 1)
    # COO duplicates are summed on conversion; the format must see sums
    return sps.coo_matrix((rng.standard_normal(rows.size), (rows, cols)),
                          shape=(n, n)).tocsr()


def _unbanded():
    return sps.random(2500, 2500, density=0.004, random_state=6,
                      format="csr") + sps.eye(2500)


MATRICES = {
    "random_banded": _random_banded,
    "wide_band": _wide_band,
    "hub_rows": _hub_rows,
    "structured_poisson": _structured_poisson,
    "rectangular": _rectangular,
    "duplicate_columns": _duplicate_columns,
    "unbanded": _unbanded,
}
# f32: storage + accumulation over tens of terms; f64: roundoff only
TOL = {jnp.float32: 1e-5, jnp.float64: 1e-12}


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_from_csr_matches_scipy(name, dtype):
    sp = MATRICES[name]()
    op = SparseOperator.from_csr(CSR.from_scipy(sp), dtype=dtype,
                                 with_transpose=True)
    rng = np.random.default_rng(7)
    x = rng.standard_normal(sp.shape[1])
    y = np.asarray(op.mv(jnp.asarray(x, dtype)), dtype=np.float64)
    ref = sp @ x
    assert np.linalg.norm(y - ref) <= TOL[dtype] * np.linalg.norm(ref)
    xt = rng.standard_normal(sp.shape[0])
    yt = np.asarray(op.rmv(jnp.asarray(xt, dtype)), dtype=np.float64)
    ref_t = sp.T @ xt
    assert np.linalg.norm(yt - ref_t) <= TOL[dtype] * np.linalg.norm(ref_t)
    xs = rng.standard_normal((sp.shape[1], 3))
    ys = np.asarray(op.mm(jnp.asarray(xs, dtype)), dtype=np.float64)
    ref_s = sp @ xs
    assert np.linalg.norm(ys - ref_s) <= TOL[dtype] * np.linalg.norm(ref_s)


class _FakeDevice:
    def __init__(self, platform):
        self.platform = platform
        self.device_kind = platform


@pytest.mark.parametrize("platform", ["cpu", "gpu", "tpu"])
def test_pick_format_ignores_platform(platform, monkeypatch):
    """The same matrix gets the same format whatever device JAX reports
    first."""
    from tpu_amg.linop import _pick_format

    chosen = {}
    for name, make in MATRICES.items():
        csr = CSR.from_scipy(make())
        chosen[name] = type(_pick_format(csr, jnp.float32, True, 32, 3.0))
    monkeypatch.setattr(jax, "devices",
                        lambda *a, **k: [_FakeDevice(platform)])
    for name, make in MATRICES.items():
        csr = CSR.from_scipy(make())
        got = type(_pick_format(csr, jnp.float32, True, 32, 3.0))
        assert got is chosen[name], (name, platform)
