"""Builder: Hierarchy → device-side Multigrid preconditioner.

Reference ``MultigridConfig::build`` (multigrid.rs:27-165): for each
non-coarsest level, re-run the modularity partitioner with the *smoother*
coarsening factor (the amg CLI uses block_smoother_size = 128,
examples/amg/main.rs:107) on that level's operator/near-null to get the
block-smoother partition, build a BlockSmoother per level, and a direct
coarse solver on the last level.

(The reference's level loop contains a latent wrong-operator fallback —
multigrid.rs:147 falls back to the finest op — which we do not replicate;
SURVEY.md Appendix B.)
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import jax.numpy as jnp

from tpu_amg.hierarchy import Hierarchy
from tpu_amg.linop import SparseOperator
from tpu_amg.partition import PartitionerConfig
from tpu_amg.preconditioners.block_smoother import BlockSmoother
from tpu_amg.preconditioners.coarse import build_coarse_solver
from tpu_amg.preconditioners.multigrid import Level, Multigrid

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class MultigridConfig:
    """Defaults: μ=1, smoothing_steps 1, Cholesky coarsest
    (multigrid.rs:35-44); smoother partition cf defaults to the CLI's
    block_smoother_size 128 (examples/amg/main.rs:107).

    ``smoother``: "block" (the reference's additive-Schwarz
    BlockSmoother), "chebyshev" (degree-``chebyshev_degree`` polynomial
    in D⁻¹A — the alternative with no partitioner cost),
    or "l1"/"l2"/"jacobi" diagonal smoothing.
    """

    # cycle index: None = auto (1 for SA hierarchies, 2 for classical —
    # measured at 120^2 poisson: classical V-cycle ||E||_A degrades
    # 0.158 (2-level) -> 0.651 (full depth) while the W-cycle holds
    # 0.261; SA's cf-8 aggressive coarsening keeps V-cycles sharp and a
    # W-cycle there only adds cost)
    mu: Optional[int] = None
    smoothing_steps: int = 1
    coarse_solver: Optional[str] = "cholesky"
    smoother: str = "block"
    chebyshev_degree: int = 3
    smoother_partitioner: PartitionerConfig = dataclasses.field(
        default_factory=lambda: PartitionerConfig(coarsening_factor=128.0)
    )
    dtype: object = jnp.float64
    prefer_dia: bool = True  # DIA fast path for diagonal-structured levels
    dense_threshold: int = 2048  # densify small coarse levels (dense matvec)
    # RCM-reorder coarse Galerkin levels whose aggregate-order bandwidth
    # defeats the windowed device formats (banded slabs); the
    # permutation folds into R/P so the cycle is exactly similarity-
    # equivalent.  Levels that are DIA-eligible or dense keep their
    # ordering.
    reorder_levels: bool = True

    def _build_smoother(self, a, nn, w, a_op):
        from tpu_amg.linop import DiagonalOperator
        from tpu_amg.preconditioners.chebyshev import ChebyshevSmoother

        if self.smoother == "block":
            cfg = self.smoother_partitioner
            # cap cf so at least 2 aggregates exist
            n_nodes = a.nrows // a.block_size
            if cfg.coarsening_factor > n_nodes / 2:
                cfg = dataclasses.replace(
                    cfg, coarsening_factor=max(n_nodes / 2.0, 1.0)
                )
            partition = cfg.build_partition(a, nn, w).expand_blocks(
                a.block_size
            )
            return BlockSmoother.build(a, partition, dtype=self.dtype)
        # diagonal quantities from the host CSR (works for every device
        # operator type: DIA/ELL/Dense)
        if self.smoother == "chebyshev":
            d_inv = jnp.asarray(1.0 / a.abs_row_sums(), dtype=self.dtype)
            return ChebyshevSmoother.build(
                a_op, d_inv, degree=self.chebyshev_degree
            )
        if self.smoother == "l1":
            diag = 1.0 / a.abs_row_sums()
        elif self.smoother == "jacobi":
            diag = 0.66 / a.diagonal()
        elif self.smoother == "l2":
            import numpy as np

            d = a.diagonal()
            rows, cols, vals = a.coo()
            acc = np.zeros(a.nrows)
            np.add.at(
                acc, rows, np.abs(vals) * np.sqrt(d[rows]) / np.sqrt(d[cols])
            )
            diag = 1.0 / acc
        else:
            raise ValueError(f"unknown smoother {self.smoother!r}")
        return DiagonalOperator(diag=jnp.asarray(diag, dtype=self.dtype))

    def _level_perms(self, hierarchy: Hierarchy):
        """Per-level RCM permutations (None = keep ordering).

        Only non-dense, non-DIA intermediate levels are touched: cd=1 /
        hub-row Galerkin operators inherit aggregate ordering whose
        bandwidth defeats the banded slabs (the reference's CSR kernel
        handles such rows for free, par_spmm.rs:37-84; the fix here is to
        restore bandedness)."""
        level_count = hierarchy.num_levels
        perms = [None] * level_count
        if not self.reorder_levels:
            return perms
        from tpu_amg.sparse.dia import try_from_csr
        from tpu_amg.utils.reorder import (
            bandwidth,
            block_rcm_permutation,
            permute_symmetric,
        )

        for lvl in range(1, level_count - 1):
            a = hierarchy.get_op(lvl)
            if a.nrows <= self.dense_threshold:
                continue
            if self.prefer_dia:
                dia = try_from_csr(a, max_diags=160)
                if (
                    dia is not None
                    and len(dia.offsets) * a.nrows <= 8.0 * max(a.nnz, 1)
                ):
                    continue  # structured level: slice-FMA path, keep order
            perm = block_rcm_permutation(a)
            if bandwidth(permute_symmetric(a, perm)) < 0.8 * bandwidth(a):
                perms[lvl] = perm
                logger.debug("level %d RCM adopted", lvl)
        return perms

    def level_csrs(self, hierarchy: Hierarchy):
        """Host CSRs each cycle level is built from, in the cycle's own
        numbering (RCM-permuted levels included): one
        ``(a, near_null, p, r)`` per level above the coarsest."""
        from tpu_amg.utils.reorder import (
            permute_cols,
            permute_rows,
            permute_symmetric,
        )

        perms = self._level_perms(hierarchy)
        out = []
        for lvl in range(hierarchy.num_levels - 1):
            a = hierarchy.get_op(lvl)
            nn = hierarchy.get_near_null(lvl)
            p_csr = hierarchy.get_interpolation(lvl)
            r_csr = hierarchy.get_restriction(lvl)
            if perms[lvl] is not None:
                a = permute_symmetric(a, perms[lvl])
                nn = nn[perms[lvl]]
                p_csr = permute_rows(p_csr, perms[lvl])
                r_csr = permute_cols(r_csr, perms[lvl])
            if perms[lvl + 1] is not None:
                p_csr = permute_cols(p_csr, perms[lvl + 1])
                r_csr = permute_rows(r_csr, perms[lvl + 1])
            out.append((a, nn, p_csr, r_csr))
        return out

    def build(self, hierarchy: Hierarchy) -> Multigrid:
        level_count = hierarchy.num_levels
        levels = []
        for lvl, (a, nn, p_csr, r_csr) in enumerate(
            self.level_csrs(hierarchy)
        ):
            w = hierarchy.get_nn_weights(lvl)
            if a.nrows <= self.dense_threshold:
                # small coarse levels: one dense matvec in place of a
                # sparse gather
                from tpu_amg.linop import DenseOperator

                a_op = DenseOperator(
                    mat=jnp.asarray(a.to_dense(), dtype=self.dtype)
                )
            else:
                # wide DIA envelope: Galerkin stencils of structured
                # grids reach ~125 diagonals and stay slice-FMAs
                a_op = SparseOperator.from_csr(
                    a, dtype=self.dtype, prefer_dia=self.prefer_dia,
                    dia_max_diags=160, dia_max_density=8.0,
                )
            smoother = self._build_smoother(a, nn, w, a_op)
            p_op = SparseOperator.from_csr(p_csr, dtype=self.dtype)
            r_op = SparseOperator.from_csr(r_csr, dtype=self.dtype)
            # Smoothed-SA restrictions have rows = 2/3-D aggregate blobs
            # whose 1-D column span defeats every windowed format; when R
            # landed on the ELL gather path but P is window-dense, apply
            # R as Pᵀ through P's slabs instead (R = Pᵀ exactly,
            # reference interpolation/mod.rs:824-827): one ELL-gathered
            # restriction's gather pads every row to the hub row, while
            # P's slabs stream contiguously.
            from tpu_amg.linop import TransposeOperator
            from tpu_amg.sparse.banded import BandedDense, BandedStack
            from tpu_amg.sparse.ell import ELL as _ELL

            if (
                isinstance(r_op.ell, _ELL)
                and r_op.ell.k >= 64
                and isinstance(p_op.ell, (BandedDense, BandedStack))
            ):
                r_op = TransposeOperator(base=p_op)
            n_coarse = hierarchy.get_op(lvl + 1).nrows
            if (
                r_op.shape != (n_coarse, a.nrows)
                or p_op.shape != (a.nrows, n_coarse)
                or smoother.shape[0] != a.nrows
            ):
                from tpu_amg.errors import MultigridBuildError

                raise MultigridBuildError(
                    f"level {lvl} assembly mismatch: A n={a.nrows}, "
                    f"R {r_op.shape}, P {p_op.shape}, smoother "
                    f"{smoother.shape}, coarse n={n_coarse}"
                )
            levels.append(Level(a=a_op, smoother=smoother, r=r_op, p=p_op))
        coarse = build_coarse_solver(
            self.coarse_solver or "cholesky",
            hierarchy.get_op(level_count - 1),
            dtype=self.dtype,
        )
        mu = self.mu
        if mu is None:
            classical = "classical" in getattr(
                hierarchy, "partition_kinds", []
            )
            mu = 2 if classical else 1
        return Multigrid(
            levels=tuple(levels),
            coarse_solver=coarse,
            mu=mu,
            smoothing_steps=self.smoothing_steps,
        )
