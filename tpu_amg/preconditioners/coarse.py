"""Coarsest-level direct solvers.

The reference offers sparse/dense Cholesky (``CoarseSolverKind::Cholesky``)
with SVD/Eigh declared but unimplemented (reference coarse_solvers.rs:27-40).
The coarsest grid (default ≤ 1000 dofs, hierarchy.rs:30-32) is tiny as a
sparse problem, so we densify it and apply a materialized Cholesky
inverse as one dense matmul.
We also actually implement the pseudo-inverse (eigh) variant the reference
stubs out, for semi-definite coarse grids.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from tpu_amg.linop import HIGHEST, LinearOperator
from tpu_amg.sparse.csr import CSR


def _mm(a, b):
    return jnp.matmul(a, b, precision=HIGHEST)


def _densify(a) -> jnp.ndarray:
    if isinstance(a, CSR):
        return jnp.asarray(a.to_dense())
    if hasattr(a, "ell"):
        a = a.ell
    if hasattr(a, "offsets"):  # DIA
        n = a.shape[0]
        dense = np.zeros(a.shape)
        data = np.asarray(a.data)
        for d, off in enumerate(a.offsets):
            rows = np.arange(max(0, -off), min(n, n - off))
            dense[rows, rows + off] = data[d, rows]
        return jnp.asarray(dense)
    if hasattr(a, "cols"):  # ELL
        dense = np.zeros(a.shape)
        cols = np.asarray(a.cols)
        data = np.asarray(a.data)
        np.add.at(dense, (np.arange(a.shape[0])[:, None], cols), data)
        return jnp.asarray(dense)
    return jnp.asarray(a)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DenseCholeskySolver(LinearOperator):
    """Exact solve via a Cholesky-factored inverse, applied as a dense
    matmul.

    Role of the reference's Sparse/DenseCholeskySolve
    (coarse_solvers.rs:55-276).  Triangular solves are sequential
    chains; A⁻¹ is therefore materialized once at build through the
    Cholesky factorization, making every application a single dense
    matmul.  Symmetric: rmv = mv.
    """

    inv: jax.Array  # A⁻¹ = L⁻ᵀ L⁻¹, materialized at build

    @property
    def shape(self):
        return self.inv.shape

    @staticmethod
    def build(a) -> "DenseCholeskySolver":
        # factor/invert on the host in f64: one-time setup work; only
        # the final inverse ships to the device.
        dense = np.asarray(_densify(a))
        chol = np.linalg.cholesky(dense)
        inv_l = np.linalg.inv(chol)
        return DenseCholeskySolver(inv=jnp.asarray(inv_l.T @ inv_l))

    def mv(self, x):
        return jnp.matmul(self.inv, x, precision=HIGHEST)

    def mm(self, xs):
        return jnp.matmul(self.inv, xs, precision=HIGHEST)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DensePinvSolver(LinearOperator):
    """Pseudo-inverse solve via eigendecomposition (the reference's
    unimplemented ``CoarseSolverKind::Eigh``, coarse_solvers.rs:27-40).

    Robust for singular/semi-definite coarse operators (e.g. pure-Neumann
    problems where the constant is in the kernel).
    """

    pinv: jax.Array  # materialized dense pseudo-inverse

    @property
    def shape(self):
        return self.pinv.shape

    @staticmethod
    def build(a, rtol: float = 1e-12) -> "DensePinvSolver":
        dense = np.asarray(_densify(a))  # host-side (see DenseCholeskySolver)
        w, v = np.linalg.eigh(dense)
        cutoff = rtol * np.max(np.abs(w))
        inv_w = np.where(np.abs(w) > cutoff, 1.0 / w, 0.0)
        return DensePinvSolver(pinv=jnp.asarray((v * inv_w) @ v.T))

    def mv(self, x):
        return jnp.matmul(self.pinv, x, precision=HIGHEST)

    def mm(self, xs):
        return jnp.matmul(self.pinv, xs, precision=HIGHEST)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BandedCholeskySolver(LinearOperator):
    """Sparse direct solve for large coarsest levels — the analog of
    the reference's sparse LLT (coarse_solvers.rs:166-276,
    symbolic+numeric factorization at :166-181, solve at :199-276).

    Setup (host, one-time): RCM-reorder the coarse operator to minimal
    bandwidth b, factor with a banded Cholesky (LAPACK pbtrf via scipy;
    the band is the exact fill pattern of the factor), then slice L into
    an s×s block-bidiagonal form with s ≥ b and materialize the diagonal
    blocks' inverses.

    Apply (device): two ``lax.scan`` substitution sweeps —
    forward  u_i = L_ii⁻¹ (x_i − L_{i,i−1} u_{i−1}) and
    backward z_i = L_ii⁻ᵀ (u_i − L_{i+1,i}ᵀ z_{i+1}) —
    each step two dense (s,s)@(s,·) matmuls: the sequential chain is
    n/s ≈ tens of steps of dense work, not n scalar steps.
    """

    inv_l_diag: jax.Array  # (nb, s, s) L_ii⁻¹
    sub: jax.Array  # (nb, s, s) L_{i,i−1} (block 0 is zero)
    perm: jax.Array  # RCM permutation (int32)
    iperm: jax.Array  # inverse permutation
    n: int = dataclasses.field(metadata=dict(static=True))

    @property
    def shape(self):
        return (self.n, self.n)

    @staticmethod
    def build(
        a,
        dtype=None,
        max_bandwidth: int = 4096,
        max_factor_flops: float = 5e11,
        max_device_bytes: int = 2 << 30,
    ) -> "BandedCholeskySolver":
        import scipy.linalg as sla
        import scipy.sparse as sps

        from tpu_amg.errors import MultigridBuildError

        if isinstance(a, CSR):
            csr = a
        elif hasattr(a, "to_scipy"):
            csr = a
        else:
            dense = np.asarray(_densify(a))
            sp = sps.csr_matrix(dense)
            csr = CSR.from_scipy(sp)
        sp = csr.to_scipy().tocsr()
        sp.sort_indices()
        n = sp.shape[0]

        from tpu_amg.utils.reorder import rcm_permutation

        perm = rcm_permutation(csr)
        spp = sp[perm][:, perm].tocoo()
        b = int(np.abs(spp.row - spp.col).max()) if spp.nnz else 0
        if b > max_bandwidth:
            raise MultigridBuildError(
                f"coarse level ({n} dofs) has RCM bandwidth {b} > "
                f"{max_bandwidth}; banded Cholesky would be denser than "
                "useful — coarsen further or raise max_bandwidth."
            )
        if n * float(b) ** 2 > max_factor_flops:
            raise MultigridBuildError(
                f"banded factorization cost n*b^2 = {n * b * b:.2e} flops "
                "exceeds the setup budget."
            )
        s = max(128, -(-max(b, 1) // 128) * 128)
        nb = -(-n // s)
        itemsize = jnp.dtype(dtype or jnp.float32).itemsize
        if 2 * nb * s * s * itemsize > max_device_bytes:
            raise MultigridBuildError(
                f"banded factor blocks need {2 * nb * s * s * itemsize:.2e}"
                " bytes on device — over budget."
            )

        # lower band form ab[i, j] = B[j+i, j], i = 0..b
        sppc = spp.tocsr()
        rows = np.repeat(np.arange(n), np.diff(sppc.indptr))
        cols = sppc.indices
        lower = rows >= cols
        ab = np.zeros((b + 1, n))
        ab[rows[lower] - cols[lower], cols[lower]] = sppc.data[lower]
        try:
            cb = sla.cholesky_banded(ab, lower=True)
        except Exception as e:  # noqa: BLE001
            raise MultigridBuildError(
                f"banded Cholesky failed (operator not SPD?): {e}"
            ) from e

        # L as scipy sparse for block slicing; pad tail rows with 1.0
        np_ = n  # true dim; padded dim:
        npad = nb * s
        li = []
        lj = []
        lv = []
        for d in range(b + 1):
            j = np.arange(n - d)
            v = cb[d, j]
            nzm = v != 0.0
            li.append(j[nzm] + d)
            lj.append(j[nzm])
            lv.append(v[nzm])
        if npad > n:
            pad = np.arange(n, npad)
            li.append(pad)
            lj.append(pad)
            lv.append(np.ones(npad - n))
        lmat = sps.coo_matrix(
            (np.concatenate(lv), (np.concatenate(li), np.concatenate(lj))),
            shape=(npad, npad),
        ).tocsr()

        inv_l_diag = np.zeros((nb, s, s))
        sub = np.zeros((nb, s, s))
        eye = np.eye(s)
        for i in range(nb):
            sl = slice(i * s, (i + 1) * s)
            lii = lmat[sl, sl].toarray()
            inv_l_diag[i] = sla.solve_triangular(lii, eye, lower=True)
            if i:
                sub[i] = lmat[sl, slice((i - 1) * s, i * s)].toarray()

        iperm = np.argsort(perm)
        dt = dtype or jnp.float64
        return BandedCholeskySolver(
            inv_l_diag=jnp.asarray(inv_l_diag, dtype=dt),
            sub=jnp.asarray(sub, dtype=dt),
            perm=jnp.asarray(perm, dtype=jnp.int32),
            iperm=jnp.asarray(iperm, dtype=jnp.int32),
            n=int(np_),
        )

    def _solve_blocks(self, xb):
        """xb: (nb, s, k) permuted+padded rhs blocks → solution blocks."""
        nb, s, k = xb.shape

        def fwd(carry, inp):
            invd, lsub, xi = inp
            u = _mm(invd, xi - _mm(lsub, carry))
            return u, u

        z0 = jnp.zeros((s, k), dtype=xb.dtype)
        _, u = jax.lax.scan(fwd, z0, (self.inv_l_diag, self.sub, xb))

        def bwd(carry, inp):
            invd, lsub_next, ui = inp
            z = _mm(invd.T, ui - _mm(lsub_next.T, carry))
            return z, z

        sub_next = jnp.concatenate(
            [self.sub[1:], jnp.zeros_like(self.sub[:1])], axis=0
        )
        _, z = jax.lax.scan(
            bwd, z0, (self.inv_l_diag, sub_next, u), reverse=True
        )
        return z

    def mm(self, xs):
        from tpu_amg.shard_utils import ensure_replicated

        xs = ensure_replicated(xs)  # replicated coarsest-level solve
        squeeze = xs.ndim == 1
        if squeeze:
            xs = xs[:, None]
        nb, s, _ = self.inv_l_diag.shape
        xp = jnp.take(xs, self.perm, axis=0)
        xp = jnp.pad(xp, ((0, nb * s - self.n), (0, 0)))
        z = self._solve_blocks(xp.reshape(nb, s, -1))
        y = jnp.take(z.reshape(nb * s, -1)[: self.n], self.iperm, axis=0)
        return y[:, 0] if squeeze else y

    def mv(self, x):
        return self.mm(x)


DENSE_COARSE_CAP = 20_000


def build_coarse_solver(kind: str, a, dtype=None) -> LinearOperator:
    """Reference ``CoarseSolverKind`` dispatch (coarse_solvers.rs:14-42).

    ``cholesky`` picks dense (materialized inverse, one matmul per
    apply) below DENSE_COARSE_CAP dofs and the banded sparse factorization
    above it — the role split of the reference's Dense/SparseCholeskySolve
    (coarse_solvers.rs:55-162 vs :166-276)."""
    n = a.shape[0]
    if kind in ("banded", "banded_cholesky") or (
        kind == "cholesky" and n > DENSE_COARSE_CAP
    ):
        # n^2 densification at this size is multi-GB (and LAPACK potrf
        # has been observed to segfault near the int32 element boundary);
        # use the sparse banded factorization instead
        return BandedCholeskySolver.build(a, dtype=dtype)
    if n > DENSE_COARSE_CAP:
        from tpu_amg.errors import MultigridBuildError

        raise MultigridBuildError(
            f"coarsest level has {n} dofs — too large for a dense "
            f"{kind} solve. Use kind='cholesky' (auto-banded), lower "
            "max_levels restrictions, or raise coarsest_dim."
        )
    if kind == "cholesky":
        s = DenseCholeskySolver.build(a)
        if dtype is not None:
            s = DenseCholeskySolver(inv=s.inv.astype(dtype))
        return s
    if kind in ("eigh", "pinv", "svd"):
        s = DensePinvSolver.build(a)
        if dtype is not None:
            s = DensePinvSolver(pinv=s.pinv.astype(dtype))
        return s
    raise ValueError(f"unknown coarse solver kind {kind!r}")
