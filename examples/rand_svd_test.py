"""Randomized-SVD manufactured-solution accuracy test.

Equivalent of reference examples/rand_svd_test.rs:39-105: A = U·diag(e^{-0.1 i})·Vᵀ
(200×150, k=50); recover via rand_svd; report U/V subspace alignment
‖U_refᵀU‖_F²/k and σ-recovery ratio, and the combined score (≈1 expected).
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

import tpu_amg  # noqa: E402,F401  (x64 and the compile cache)

from tpu_amg.decompositions import rand_svd
from tpu_amg.linop import DenseOperator


def main(m=200, n=150, k=50, decay=0.1, seed=0):
    rng = np.random.default_rng(seed)
    u_ref, _ = np.linalg.qr(rng.normal(size=(m, m)))
    v_ref, _ = np.linalg.qr(rng.normal(size=(n, n)))
    sigma = np.exp(-decay * np.arange(n))
    a = (u_ref[:, :n] * sigma) @ v_ref.T

    u, s, v = rand_svd(
        DenseOperator(mat=jnp.asarray(a)), jax.random.PRNGKey(seed), k,
        oversample=10, subspace_iters=2,
    )
    u, s, v = np.asarray(u), np.asarray(s), np.asarray(v)

    align_u = np.linalg.norm(u_ref[:, :k].T @ u) ** 2 / k
    align_v = np.linalg.norm(v_ref[:, :k].T @ v) ** 2 / k
    sigma_ratio = s.sum() / sigma[:k].sum()
    score = align_u * align_v * sigma_ratio
    print(f"U subspace alignment: {align_u:.6f}")
    print(f"V subspace alignment: {align_v:.6f}")
    print(f"sigma recovery ratio: {sigma_ratio:.6f}")
    print(f"combined score:       {score:.6f}")


if __name__ == "__main__":
    main()
