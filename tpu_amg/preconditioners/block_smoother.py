"""Block smoother: non-overlapping additive Schwarz with diagonal
compensation.

Reference ``BlockSmoother`` (block_smoothers.rs:89-241): per aggregate of
a partition, extract the local dense block of A, *compensate* the diagonal
for cut edges so the block stays an SPD upper bound:

- scalar dofs: dᵢ += 0.5·√(aᵢᵢ/aⱼⱼ)·|aᵢⱼ| per cut edge (i,j)
  (block_smoothers.rs:293-324),
- vector dofs (block_size>1): per cut block pair accumulate
  0.5·U·|S|·Uᵀ from the SVD of −A_IJ onto the diagonal block
  (block_smoothers.rs:326-399),

then factor each block and apply as gather → per-block solve → scatter.

Device design: aggregates are grouped into power-of-two *size
buckets* (instead of padding everything to the global max — skewed
distributions would otherwise cost O(n_aggs·bmax²) memory); the per-block
inverses are materialized once at setup via batched Cholesky (the
reference's ``into_sparse_mat`` analog, block_smoothers.rs:125-146), so
each application is one batched (n_b, s_b, s_b) × (n_b, s_b) matmul
per bucket plus one gather and one disjoint scatter — replacing
the reference's rayon loop of per-aggregate Cholesky solves
(block_smoothers.rs:165-214).  Setup is fully vectorized: block
extraction is one scatter over the intra-aggregate COO entries and the
block-case compensation is one batched SVD over cut block pairs — no
per-aggregate Python loop (reference uses rayon par_iter,
block_smoothers.rs:95).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tpu_amg.linop import LinearOperator
from tpu_amg.partition.partition import Partition
from tpu_amg.sparse.csr import CSR


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BlockBucket:
    """Aggregates padded to one common size s_b."""

    inv_blocks: jax.Array  # (n_b, s_b, s_b) materialized block inverses
    idx: jax.Array  # (n_b, s_b) int32 dof indices, padded with 0
    mask: jax.Array  # (n_b, s_b) 1.0 valid / 0.0 padding


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BlockSmoother(LinearOperator):
    buckets: Tuple[BlockBucket, ...]
    n: int = dataclasses.field(metadata=dict(static=True))

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.n)

    def _scatter_add(self, out, idx, sol, x):
        """Disjoint scatter-add of per-aggregate solutions back to dofs,
        with explicit output sharding matching x when inputs are sharded."""
        idx_spec = tuple(jax.typeof(idx).sharding.spec)
        x_spec = tuple(jax.typeof(x).sharding.spec)
        if all(s is None for s in idx_spec + x_spec):
            return out.at[idx].add(sol)
        from jax.sharding import PartitionSpec as P

        return out.at[idx].add(sol, out_sharding=P(*x_spec))

    def mv(self, x):
        from tpu_amg.sparse.ell import _row_gather

        out = jnp.zeros((self.n,) + x.shape[1:], dtype=x.dtype)
        for b in self.buckets:
            rhs = _row_gather(x, b.idx, 0) * b.mask  # (n_b, s_b)
            sol = jnp.einsum(
                "abc,ac->ab", b.inv_blocks, rhs,
                preferred_element_type=rhs.dtype,
                precision=jax.lax.Precision.HIGHEST,
            )
            out = self._scatter_add(out, b.idx, sol * b.mask, x)
        return out

    def mm(self, xs):
        from tpu_amg.sparse.ell import _row_gather

        out = jnp.zeros((self.n,) + xs.shape[1:], dtype=xs.dtype)
        for b in self.buckets:
            rhs = _row_gather(xs, b.idx, 1) * b.mask[..., None]
            sol = jnp.einsum(
                "abc,acm->abm", b.inv_blocks, rhs,
                preferred_element_type=rhs.dtype,
                precision=jax.lax.Precision.HIGHEST,
            )
            out = self._scatter_add(out, b.idx, sol * b.mask[..., None], xs)
        return out

    # ------------------------------------------------------------------
    @staticmethod
    def build(a: CSR, partition: Partition, dtype=jnp.float64) -> "BlockSmoother":
        """Assemble from a host CSR matrix and a partition of its dofs.

        ``partition`` partitions *scalar* dofs; when ``a.block_size > 1``
        aggregates must contain whole blocks (guaranteed when the
        partition came from a block-contracted graph, reference
        partitioners/mod.rs:294-301).
        """
        sm, _ = BlockSmoother.build_cached(a, partition, dtype)
        return sm

    @staticmethod
    def build_cached(
        a: CSR, partition: Partition, dtype=jnp.float64, cache=None,
        host_only: bool = False,
    ):
        """``build`` plus an opaque cache enabling *exact incremental*
        rebuilds: when called again with the same partition on a
        modified matrix (compatible relaxation re-zeroes C rows/cols
        each round, classical.py), only aggregates whose assembled
        block changed are re-factorized.  Returns (smoother, cache).

        ``host_only=True`` skips device placement entirely and returns
        ``(None, cache)`` — the cache then powers :func:`host_apply`
        for setup-phase relaxation loops (compatible relaxation) that
        must not pay an XLA compile per round."""
        n = a.nrows
        if partition.num_nodes != n:
            raise ValueError(
                f"partition covers {partition.num_nodes} dofs, matrix has {n}"
            )
        bs = a.block_size
        node_to_agg = partition.node_to_agg
        n_aggs = partition.num_aggs
        comp = _diag_compensation(a, node_to_agg, bs)

        # local rank of each dof within its (ascending-sorted) aggregate
        order = np.argsort(node_to_agg, kind="stable")
        sizes = np.bincount(node_to_agg, minlength=n_aggs)
        starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        local_rank = np.empty(n, dtype=np.int64)
        local_rank[order] = np.arange(n) - np.repeat(starts, sizes)

        # size buckets: multiples of 64 above 8 (≤1.25x padding for the
        # big cf≈128-256 smoother blocks whose Cholesky dominates setup;
        # a power-of-two scheme would pad 257→512 = 8x the flops)
        padded = np.where(
            sizes <= 8, 8, ((np.maximum(sizes, 1) + 63) // 64) * 64
        ).astype(np.int64)
        rows, cols, vals = a.coo()
        intra = node_to_agg[rows] == node_to_agg[cols]
        ri, ci, vi = rows[intra], cols[intra], vals[intra]
        agg_i = node_to_agg[ri]

        buckets = []
        new_cache: dict = {"n_aggs": n_aggs, "by_size": {}}
        for s_b in np.unique(padded):
            agg_sel = np.flatnonzero(padded == s_b)
            n_b = len(agg_sel)
            slot = -np.ones(n_aggs, dtype=np.int64)
            slot[agg_sel] = np.arange(n_b)
            sizes_b = sizes[agg_sel]

            blocks = np.zeros((n_b, s_b, s_b))
            # one vectorized scatter of all intra-aggregate entries
            in_b = slot[agg_i] >= 0
            blocks[slot[agg_i[in_b]], local_rank[ri[in_b]],
                   local_rank[ci[in_b]]] = vi[in_b]
            # identity on padded diagonal slots
            jj = np.arange(s_b)
            pad_mask = jj[None, :] >= sizes_b[:, None]
            blocks[np.arange(n_b)[:, None], jj[None, :], jj[None, :]] += (
                pad_mask.astype(np.float64)
            )
            # diagonal compensation
            if bs == 1:
                dofs_b = np.flatnonzero(slot[node_to_agg] >= 0)
                np.add.at(
                    blocks,
                    (slot[node_to_agg[dofs_b]], local_rank[dofs_b],
                     local_rank[dofs_b]),
                    comp[dofs_b],
                )
            else:
                blk_ids = np.flatnonzero(
                    slot[node_to_agg[np.arange(0, n, bs)]] >= 0
                )
                if len(blk_ids):
                    first_dof = blk_ids * bs
                    ag = node_to_agg[first_dof]
                    ls = local_rank[first_dof]
                    ar = np.arange(bs)
                    np.add.at(
                        blocks,
                        (
                            slot[ag][:, None, None],
                            ls[:, None, None] + ar[None, :, None],
                            ls[:, None, None] + ar[None, None, :],
                        ),
                        comp[blk_ids],
                    )

            idx = np.zeros((n_b, s_b), dtype=np.int32)
            mask = np.zeros((n_b, s_b))
            dofs_b = np.flatnonzero(slot[node_to_agg] >= 0)
            idx[slot[node_to_agg[dofs_b]], local_rank[dofs_b]] = dofs_b
            mask[slot[node_to_agg[dofs_b]], local_rank[dofs_b]] = 1.0

            prev = None
            if (
                cache is not None
                and cache.get("n_aggs") == n_aggs
                and int(s_b) in cache["by_size"]
            ):
                prev = cache["by_size"][int(s_b)]
            # host-only callers (compatible relaxation) apply the blocks
            # a handful of times per rebuild: keep Cholesky FACTORS and
            # solve (potrs) instead of forming explicit inverses — skips
            # the trtri+gemm 60% of the factor cost.  The device path
            # keeps inverses (applied as batched matmuls).
            kind = "chol" if host_only else "inv"
            if host_only:
                factor = _spd_cholesky
            else:
                # factor in the target precision: the inverse is applied
                # as an f32 batched matmul on device anyway, and f32
                # LAPACK is ~2x f64 on the block-Cholesky that dominates
                # find_near_null's setup phase
                fdt = (
                    np.float32
                    if jnp.dtype(dtype).itemsize == 4
                    else np.float64
                )

                def factor(b, _fdt=fdt):
                    return _spd_inverse(np.ascontiguousarray(b, _fdt))
            if (
                prev is not None
                and kind in prev
                and prev["blocks"].shape == blocks.shape
            ):
                # exact incremental: re-factor only changed aggregates
                changed = np.flatnonzero(
                    np.any(prev["blocks"] != blocks, axis=(1, 2))
                )
                fac = prev[kind].copy()
                if len(changed):
                    fac[changed] = factor(blocks[changed])
            else:
                fac = factor(blocks)
            new_cache["by_size"][int(s_b)] = {
                "blocks": blocks, kind: fac, "idx": idx, "mask": mask,
            }
            inv = fac if not host_only else None

            if not host_only:
                buckets.append(
                    BlockBucket(
                        inv_blocks=jnp.asarray(inv, dtype=dtype),
                        idx=jnp.asarray(idx),
                        mask=jnp.asarray(mask, dtype=dtype),
                    )
                )
        if host_only:
            return None, new_cache
        return BlockSmoother(buckets=tuple(buckets), n=n), new_cache


def host_apply(cache: dict, x: np.ndarray) -> np.ndarray:
    """Apply the block smoother on host from a ``build_cached`` cache:
    per bucket one gather, one batched solve/matmul, one disjoint
    assignment.  Setup-phase twin of :meth:`BlockSmoother.mv` (identical
    numerics) for loops that would otherwise recompile XLA every
    round."""
    out = np.zeros_like(x)
    for e in cache["by_size"].values():
        idx, mask = e["idx"], e["mask"]
        rhs = x[idx] * mask
        if "chol" in e:
            from scipy.linalg import get_lapack_funcs

            chol = e["chol"]
            (potrs,) = get_lapack_funcs(("potrs",), (chol,))
            sol = np.empty_like(rhs)
            for k in range(chol.shape[0]):
                sol[k], _ = potrs(chol[k], rhs[k], lower=1)
        else:
            sol = np.matmul(e["inv"], rhs[..., None])[..., 0]
        flat = mask.ravel().astype(bool)
        out[idx.ravel()[flat]] = sol.ravel()[flat]
    return out


def _spd_cholesky(blocks: np.ndarray) -> np.ndarray:
    """Batched lower-Cholesky factors (host_apply solves with potrs).
    Falls back to explicit inverses packed as 'solved-by-identity-L'
    only if factorization fails — in that rare case we return the
    inverse's Cholesky-of-inverse instead; simplest robust fallback is
    factoring the compensated block with a tiny diagonal lift."""
    try:
        return np.linalg.cholesky(blocks)
    except np.linalg.LinAlgError:
        lift = blocks + 1e-10 * np.einsum(
            "bii->b", np.abs(blocks)
        )[:, None, None] * np.eye(blocks.shape[1])
        return np.linalg.cholesky(lift)


def _spd_inverse(blocks: np.ndarray) -> np.ndarray:
    """Batched SPD inverse via Cholesky (inv = L⁻ᵀL⁻¹); falls back to LU
    for blocks that fail the factorization (compensation guarantees SPD
    in exact arithmetic — block_smoothers.rs:293-399 — but roundoff can
    bite on near-singular aggregates).

    Cost ≈ 1.7·s³ per block, all in LAPACK/BLAS (potrf + trtri + gemm);
    this is the dominant setup flop sink of compatible relaxation
    (classical.py), so no naive-einsum/LU detours."""
    try:
        chol = np.linalg.cholesky(blocks)
    except np.linalg.LinAlgError:
        return np.linalg.inv(blocks)
    from scipy.linalg import get_lapack_funcs

    (trtri,) = get_lapack_funcs(("trtri",), (blocks,))
    linv = np.empty_like(chol)
    for k in range(chol.shape[0]):  # one LAPACK call per block
        linv[k], info = trtri(chol[k], lower=1)
        if info != 0:
            return np.linalg.inv(blocks)
    return np.matmul(linv.transpose(0, 2, 1), linv)


def _diag_compensation(a: CSR, node_to_agg: np.ndarray, bs: int):
    """Cut-edge diagonal compensation.

    Scalar case returns a (n,) vector of diagonal additions
    (block_smoothers.rs:293-324).  Block case returns a
    (n_blocks, bs, bs) array of diagonal-block additions computed with
    one batched SVD over all cut block pairs (block_smoothers.rs:326-399).
    """
    rows, cols, vals = a.coo()
    cut = node_to_agg[rows] != node_to_agg[cols]
    if bs == 1:
        diag = a.diagonal()
        comp = np.zeros(a.nrows)
        r, c, v = rows[cut], cols[cut], vals[cut]
        with np.errstate(divide="ignore", invalid="ignore"):
            scale = np.sqrt(np.abs(diag[r]) / np.abs(diag[c]))
        scale = np.where(np.isfinite(scale), scale, 1.0)
        np.add.at(comp, r, 0.5 * scale * np.abs(v))
        return comp

    # block case: group cut entries by (block_row, block_col), form the
    # dense bs×bs coupling blocks, one batched SVD, accumulate 0.5·U|S|Uᵀ
    n_blocks = a.nrows // bs
    brows, bcols = rows // bs, cols // bs
    bcut = cut & (brows != bcols)
    comp = np.zeros((n_blocks, bs, bs))
    if not bcut.any():
        return comp
    r, c, v = rows[bcut], cols[bcut], vals[bcut]
    br, bc = brows[bcut], bcols[bcut]
    pair_key = br * (a.ncols // bs) + bc
    uniq, inv_idx = np.unique(pair_key, return_inverse=True)
    mats = np.zeros((len(uniq), bs, bs))
    mats[inv_idx, r % bs, c % bs] = -v
    u, s, _ = np.linalg.svd(mats)
    adds = 0.5 * np.einsum("pik,pk,pjk->pij", u, np.abs(s), u)
    np.add.at(comp, (uniq // (a.ncols // bs)), adds)
    return comp
