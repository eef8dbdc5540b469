"""Sparse containers and host-side sparse algebra.

Two complementary representations:

- :class:`CSR` — the canonical setup-side format (host, numpy-backed).
  Mirrors the role of faer's ``SparseRowMat`` in the reference
  (reference core.rs:13-17): COO→CSR construction with duplicate summing,
  transpose, SpGEMM, Galerkin triple products.
- :class:`ELL` — the general device compute format: rows padded to a
  fixed width so SpMV/SpMM become gathers + FMAs with static shapes,
  replacing the reference's rayon-parallel blocked CSR SpMM (reference
  par_spmm.rs).
"""

from tpu_amg.sparse.bsr import BSR
from tpu_amg.sparse.csr import CSR
from tpu_amg.sparse.dia import DIA
from tpu_amg.sparse.ell import ELL
from tpu_amg.sparse.ops import (
    spgemm,
    rap,
    sp_add,
    sp_transpose,
    from_coo,
    eye_csr,
    diags_csr,
)

__all__ = [
    "BSR",
    "CSR",
    "DIA",
    "ELL",
    "spgemm",
    "rap",
    "sp_add",
    "sp_transpose",
    "from_coo",
    "eye_csr",
    "diags_csr",
]
