"""BandedDense — dense-slab storage over selected column blocks, the
batched-matmul path for gather-hostile sparse operators (smoothed-SA transfers, above
all).

Smoothing the tentative prolongation densifies it: P columns (and hence
R rows) grow to hundreds-or-thousands of entries over an aggregate's
smeared support (reference interpolation/mod.rs:927-1028 does the same;
its CPU CSR kernel doesn't care).  A row-padded ELL of such an operator
pads every row to the widest one — a 1518×24000 restriction with
k=3867 stores 2.6x its nnz, one gather per padded slot.

Those rows are *block-dense*: their support concentrates in a modest
number of 128-column blocks (for 3-D problems the support is a stack of
per-plane runs, so a single contiguous window does NOT work — the 1-D
span of a 3-D blob grows like n^(2/3)).  So: group consecutive rows into
tiles, give each tile its set of touched 128-column blocks (q lists the
block ids), and store the tile as a dense (rows, G·128) slab over the
selected blocks.  Apply is then

    y[tile] = slab[tile] @ x2d[q[tile]].ravel()

— one efficient XLA row-gather (G rows of 512 B per tile) plus one
batched matmul.  No per-nonzero gathers; storage
≈ nnz for block-dense rows (gated by ``max_inflation`` otherwise).
The transpose apply (restriction as Pᵀ) is the same contraction followed
by a 128-wide row scatter-add.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

LANES = 128


class BandedUnsupported(ValueError):
    """Rows not block-dense enough for dense-slab storage."""


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BandedDense:
    """Tile-blocked dense matrix; see module docstring.

    slabs: (T, R, G*128) — dense rows per tile (zero-padded).
    q:     (T, G)        — selected 128-column block ids per tile.
    """

    slabs: jax.Array
    q: jax.Array
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))
    x2d_rows: int = dataclasses.field(metadata=dict(static=True))
    bw: int = dataclasses.field(default=LANES, metadata=dict(static=True))
    block_size: int = dataclasses.field(default=1, metadata=dict(static=True))

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    @property
    def dtype(self):
        return self.slabs.dtype

    def _windows(self, x: jax.Array) -> jax.Array:
        from tpu_amg.shard_utils import ensure_replicated

        x = ensure_replicated(x)  # single-chip format: gather once
        t, r, w = self.slabs.shape
        pad = self.x2d_rows * self.bw - x.shape[0]
        x2d = jnp.pad(x, ((0, pad),) + ((0, 0),) * (x.ndim - 1)).reshape(
            (self.x2d_rows, self.bw) + x.shape[1:]
        )
        wins = jnp.take(x2d, self.q.reshape(-1), axis=0)
        return wins.reshape((t, w) + x.shape[1:])

    def mv(self, x: jax.Array) -> jax.Array:
        wins = self._windows(x.astype(self.dtype))
        y = jnp.einsum(
            "trw,tw->tr", self.slabs, wins,
            preferred_element_type=self.dtype,
            precision=jax.lax.Precision.HIGHEST,
        )
        return y.reshape(-1)[: self.nrows]

    def mm(self, xs: jax.Array) -> jax.Array:
        wins = self._windows(xs.astype(self.dtype))  # (T, W, m)
        y = jnp.einsum(
            "trw,twm->trm", self.slabs, wins,
            preferred_element_type=self.dtype,
            precision=jax.lax.Precision.HIGHEST,
        )
        return y.reshape(-1, xs.shape[1])[: self.nrows]

    def __call__(self, x):
        return self.mm(x) if x.ndim > 1 else self.mv(x)

    # transpose application: y = Aᵀx.  This is how restrictions run when
    # R rows are 3-D blobs: R = Pᵀ exactly (reference
    # interpolation/mod.rs:824-827) and P — fine-row-major — IS
    # block-dense, so apply P's slabs backwards: per tile one dense
    # contraction then a 128-wide row scatter-add into the output.
    def rmv(self, x: jax.Array) -> jax.Array:
        from tpu_amg.shard_utils import ensure_replicated

        x = ensure_replicated(x)
        t, r, w = self.slabs.shape
        xp = jnp.pad(x.astype(self.dtype), (0, t * r - x.shape[0]))
        contrib = jnp.einsum(
            "trw,tr->tw", self.slabs, xp.reshape(t, r),
            preferred_element_type=self.dtype,
            precision=jax.lax.Precision.HIGHEST,
        )
        out2d = jnp.zeros((self.x2d_rows, self.bw), dtype=self.dtype)
        out2d = out2d.at[self.q.reshape(-1)].add(
            contrib.reshape(-1, self.bw)
        )
        return out2d.reshape(-1)[: self.ncols]

    def rmm(self, xs: jax.Array) -> jax.Array:
        from tpu_amg.shard_utils import ensure_replicated

        xs = ensure_replicated(xs)
        t, r, w = self.slabs.shape
        m = xs.shape[1]
        xp = jnp.pad(
            xs.astype(self.dtype), ((0, t * r - xs.shape[0]), (0, 0))
        )
        contrib = jnp.einsum(
            "trw,trm->twm", self.slabs, xp.reshape(t, r, m),
            preferred_element_type=self.dtype,
            precision=jax.lax.Precision.HIGHEST,
        )
        out = jnp.zeros((self.x2d_rows, self.bw, m), dtype=self.dtype)
        out = out.at[self.q.reshape(-1)].add(
            contrib.reshape(-1, self.bw, m)
        )
        return out.reshape(-1, m)[: self.ncols]

    # interface parity with the other device formats (square use)
    def diagonal(self) -> jax.Array:
        t, r, w = self.slabs.shape
        rows = jnp.arange(t * r).reshape(t, r)
        blk = rows // self.bw  # global block of the diagonal column
        match = self.q[:, None, :] == blk[:, :, None]  # (T, R, G)
        j = jnp.argmax(match, axis=2)  # first matching block slot
        valid = jnp.any(match, axis=2)
        pos = j * self.bw + rows % self.bw
        d = jnp.take_along_axis(self.slabs, pos[:, :, None], axis=2)[:, :, 0]
        return jnp.where(valid, d, 0.0).reshape(-1)[: self.nrows]

    def abs_row_sums(self) -> jax.Array:
        return jnp.sum(jnp.abs(self.slabs), axis=2).reshape(-1)[: self.nrows]

    def row_sums(self) -> jax.Array:
        return jnp.sum(self.slabs, axis=2).reshape(-1)[: self.nrows]

    def to_csr(self):
        """Host CSR reconstruction (used when a distributed setup needs
        to re-format transfers for halo sharding)."""
        from tpu_amg.sparse.csr import CSR

        s = np.asarray(self.slabs)
        qn = np.asarray(self.q)
        tt, rr, ww = np.nonzero(s)
        t, r, w = self.slabs.shape
        rows = tt * r + rr
        cols = qn[tt, ww // self.bw] * self.bw + ww % self.bw
        keep = (rows < self.nrows) & (cols < self.ncols)
        return CSR.from_coo(
            rows[keep], cols[keep], s[tt, rr, ww][keep], self.shape,
            block_size=self.block_size,
        )

    def __repr__(self):
        t, r, w = self.slabs.shape
        dense = t * r * w
        return (
            f"BandedDense(shape={self.shape}, nnz={self.nnz}, tiles={t}, "
            f"rows/tile={r}, blocks/tile={w // self.bw} (bw={self.bw}, "
            f"x{dense / max(self.nnz, 1):.1f} slots), dtype={self.dtype})"
        )

    # ------------------------------------------------------------------
    @staticmethod
    def stack_from_csr(
        csr,
        dtype=jnp.float32,
        max_inflation: float = 8.0,
        quantiles=(0.7, 0.95, 1.0),
        _rb16=None,
    ) -> "BandedStack":
        """Row-heterogeneous variant: one hub row otherwise sets the slab
        width for every tile (a 112-nnz row among 25-nnz rows inflated a
        262k-dof restriction 18x past its nnz).  Rows are sorted by
        block count and bucketed at ``quantiles``; each bucket becomes
        its own BandedDense and the outputs are concatenated and
        un-permuted (the permutation arrays are tiny relative to the
        operator)."""
        import scipy.sparse as sps

        n, ncols = csr.shape
        if csr.nnz == 0:
            raise BandedUnsupported("empty matrix")
        sp = sps.csr_matrix(
            (np.asarray(csr.data), np.asarray(csr.indices),
             np.asarray(csr.indptr)), shape=(n, ncols),
        )
        # per-row 16-block count as the homogeneity key
        if _rb16 is None:
            _rb16 = BandedDense._row_blocks16(csr)
        urow16, ublk16, _ = _rb16
        ucount = np.bincount(urow16, minlength=n)
        # class-bucket by block count but keep ORIGINAL row order within
        # each class — rows_per_tile groups consecutive rows, and
        # consecutive original rows are spatially adjacent (sorting by
        # density would scatter each tile across the domain and blow the
        # per-tile block union)
        thrs = [float(np.quantile(ucount, q)) for q in quantiles]
        parts, part_rows = [], []
        total_slab = 0
        prev_thr = -np.inf
        from tpu_amg.sparse.csr import CSR as _CSR

        rank = np.empty(n, dtype=np.int64)
        for thr in thrs:
            bmask = (ucount > prev_thr) & (ucount <= thr)
            rows = np.flatnonzero(bmask)
            prev_thr = thr
            if len(rows) == 0:
                continue
            sub = sp[rows]
            sub_csr = _CSR.from_scipy(sub.tocsr())
            # derive the bucket's (row, block) pairs from the parent's
            # shared pass instead of re-uniquing the bucket's nnz
            rank[rows] = np.arange(len(rows))
            sel = bmask[urow16]
            rb_sub = (
                rank[urow16[sel]],
                ublk16[sel],
                np.repeat(
                    np.arange(len(rows)), np.diff(np.asarray(sub_csr.indptr))
                ),
            )
            # rpt=1: restriction-like rows are disjoint aggregate
            # supports — tiles of several rows multiply the slab width
            # without sharing blocks
            part = BandedDense.from_csr(
                sub_csr, dtype=dtype,
                rows_per_tile=1,
                max_inflation=float("inf"),  # gated on the total below
                _rb16=rb_sub,
            )
            total_slab += int(np.prod(part.slabs.shape))
            parts.append(part)
            part_rows.append(rows)
        if total_slab > max_inflation * max(csr.nnz, 1):
            raise BandedUnsupported(
                f"stacked slabs would be {total_slab / max(csr.nnz, 1):.1f}x nnz"
            )
        rows_sorted = np.concatenate(part_rows)
        inv = np.empty(n, dtype=np.int64)
        inv[rows_sorted] = np.arange(n)
        return BandedStack(
            parts=tuple(parts),
            inv=jnp.asarray(inv, dtype=jnp.int32),
            rows_sorted=jnp.asarray(rows_sorted, dtype=jnp.int32),
            shape=(int(n), int(ncols)),
            nnz=int(csr.nnz),
            block_size=int(getattr(csr, "block_size", 1)),
        )

    @staticmethod
    def _row_blocks16(csr):
        """Shared precompute: unique (row, 16-block) pairs of the CSR.
        Every (rows_per_tile, bw) combination derives from this one
        nnz-scale pass ((a//16)//f == a//(16*f)), so format-selection
        retries and stack buckets cost |unique| not nnz each."""
        indices = np.asarray(csr.indices)
        nnz_row = np.diff(np.asarray(csr.indptr))
        rows_of = np.repeat(np.arange(csr.shape[0]), nnz_row)
        nblk16 = -(-csr.shape[1] // 16)
        u = np.unique(rows_of.astype(np.int64) * nblk16 + indices // 16)
        return u // nblk16, u % nblk16, rows_of

    @staticmethod
    def from_csr(
        csr,
        dtype=jnp.float32,
        rows_per_tile: int = 8,
        max_blocks: int = 2048,
        max_inflation: float = 8.0,
        bw: int = None,
        _rb16=None,
    ) -> "BandedDense":
        """``bw`` is the column-block granularity: 128 gathers the widest
        rows but 3-D supports (short per-plane runs) are only dense at
        16-32; when None, the cheapest of {128, 32, 16} is chosen.
        ``_rb16``: optional precomputed ``_row_blocks16(csr)`` (shared
        across rows_per_tile retries)."""
        n, ncols = csr.shape
        indices = np.asarray(csr.indices)
        vals = np.asarray(csr.data)
        nnz = len(indices)
        if nnz == 0:
            raise BandedUnsupported("empty matrix")
        r = rows_per_tile
        t = -(-n // r)
        if _rb16 is None:
            _rb16 = BandedDense._row_blocks16(csr)
        urow16, ublk16, rows_of = _rb16
        tid = rows_of // r

        # coarsen the shared row-level pairs to tile granularity
        nblk16 = -(-ncols // 16)
        u16 = np.unique((urow16 // r) * nblk16 + ublk16)
        ut16, ub16 = u16 // nblk16, u16 % nblk16

        def tile_blocks(width):
            """(tile, block) pairs + per-tile counts at ``width``."""
            f = width // 16
            nblk_w = -(-nblk16 // f)
            uw = np.unique(ut16 * nblk_w + ub16 // f)
            ut_w, ub_w = uw // nblk_w, uw % nblk_w
            counts_w = np.bincount(ut_w, minlength=t)
            return ut_w, ub_w, counts_w

        if bw is None:
            # pick the block width minimizing slab bytes (gather rows
            # narrower than 128 are less efficient — prefer wider on a
            # near-tie by scanning from wide to narrow)
            best, best_cost = None, None
            for cand in (LANES, 32, 16):
                _, _, counts_c = tile_blocks(cand)
                gg = int(counts_c.max(initial=1))
                cost = t * r * gg * cand
                if best_cost is None or cost < 0.7 * best_cost:
                    best, best_cost = cand, cost
            bw = best

        # distinct bw-wide column blocks per tile (sorted, deduped)
        nblk = -(-ncols // bw)
        ut, ub, counts = tile_blocks(bw)
        ukey = ut * nblk + ub
        g = int(counts.max(initial=1))
        if g > max_blocks:
            raise BandedUnsupported(
                f"tile touches {g} column blocks (cap {max_blocks})"
            )
        if t * r * g * bw > max_inflation * max(nnz, 1):
            raise BandedUnsupported(
                f"dense slabs would be "
                f"{t * r * g * bw / max(nnz, 1):.1f}x nnz (bw={bw})"
            )
        # q: per-tile block list, padded with the tile's first block
        # (padding slots multiply against zero slab columns)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot_of = np.arange(len(ukey)) - starts[ut]
        firsts = np.zeros(t, dtype=np.int64)
        has = counts > 0
        firsts[has] = ub[starts[has]]
        q = np.repeat(firsts[:, None], g, axis=1)
        q[ut, slot_of] = ub

        # entry → slab position: find its block's slot within the tile
        ekey = tid.astype(np.int64) * nblk + indices // bw
        slot = np.searchsorted(ukey, ekey)
        local_slot = slot - starts[tid]
        slabs = np.zeros((t, r, g * bw), dtype=np.dtype(jnp.dtype(dtype).name))
        slabs[tid, rows_of % r, local_slot * bw + indices % bw] = vals

        x2d_rows = nblk
        return BandedDense(
            slabs=jnp.asarray(slabs),
            q=jnp.asarray(q, dtype=jnp.int32),
            shape=(int(n), int(ncols)),
            nnz=int(nnz),
            x2d_rows=int(x2d_rows),
            bw=int(bw),
            block_size=int(getattr(csr, "block_size", 1)),
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BandedStack:
    """Row-bucketed stack of BandedDense parts (see
    BandedDense.stack_from_csr).  Rows are stored sorted by density;
    ``rows_sorted``/``inv`` translate between original and sorted row
    order."""

    parts: Tuple[BandedDense, ...]
    inv: jax.Array  # original row -> position in the concat
    rows_sorted: jax.Array  # position in the concat -> original row
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))
    block_size: int = dataclasses.field(default=1, metadata=dict(static=True))

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    @property
    def dtype(self):
        return self.parts[0].dtype

    def mv(self, x: jax.Array) -> jax.Array:
        from tpu_amg.shard_utils import ensure_replicated

        x = ensure_replicated(x)
        y = jnp.concatenate([p.mv(x) for p in self.parts])
        return jnp.take(y, self.inv, axis=0)

    def mm(self, xs: jax.Array) -> jax.Array:
        from tpu_amg.shard_utils import ensure_replicated

        xs = ensure_replicated(xs)
        y = jnp.concatenate([p.mm(xs) for p in self.parts])
        return jnp.take(y, self.inv, axis=0)

    def rmv(self, x: jax.Array) -> jax.Array:
        from tpu_amg.shard_utils import ensure_replicated

        x = ensure_replicated(x)
        xs = jnp.take(x, self.rows_sorted, axis=0)
        out = None
        lo = 0
        for p in self.parts:
            contrib = p.rmv(xs[lo : lo + p.nrows])
            out = contrib if out is None else out + contrib
            lo += p.nrows
        return out

    def rmm(self, x: jax.Array) -> jax.Array:
        from tpu_amg.shard_utils import ensure_replicated

        x = ensure_replicated(x)
        xs = jnp.take(x, self.rows_sorted, axis=0)
        out = None
        lo = 0
        for p in self.parts:
            contrib = p.rmm(xs[lo : lo + p.nrows])
            out = contrib if out is None else out + contrib
            lo += p.nrows
        return out

    def __call__(self, x):
        return self.mm(x) if x.ndim > 1 else self.mv(x)

    def abs_row_sums(self) -> jax.Array:
        y = jnp.concatenate([p.abs_row_sums() for p in self.parts])
        return jnp.take(y, self.inv, axis=0)

    def row_sums(self) -> jax.Array:
        y = jnp.concatenate([p.row_sums() for p in self.parts])
        return jnp.take(y, self.inv, axis=0)

    def to_csr(self):
        from tpu_amg.sparse.ops import from_coo as _from_coo

        rows_all, cols_all, vals_all = [], [], []
        lo = 0
        rs = np.asarray(self.rows_sorted)
        for p in self.parts:
            c = p.to_csr()
            r, cc, vv = c.coo()
            rows_all.append(rs[lo + r])
            cols_all.append(cc)
            vals_all.append(vv)
            lo += p.nrows
        return _from_coo(
            np.concatenate(rows_all), np.concatenate(cols_all),
            np.concatenate(vals_all), self.shape,
        ).with_block_size(self.block_size)

    def __repr__(self):
        slots = sum(int(np.prod(p.slabs.shape)) for p in self.parts)
        return (
            f"BandedStack(shape={self.shape}, nnz={self.nnz}, "
            f"parts={len(self.parts)} (x{slots / max(self.nnz, 1):.1f} "
            f"slots), dtype={self.dtype})"
        )
