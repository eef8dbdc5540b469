"""Structured-grid acceleration: gather-free transfers + DIA levels.

A gather moves index bytes as well as values; for tensor-product grids
(the benchmark problems and most production fine grids) every V-cycle
ingredient can be expressed gather-free:

- level operators: DIA stencils (sparse/dia.py),
- tentative transfers: factor-2 aggregation as *reshape/repeat* ops
  (:class:`StructuredInterp`) — P applies as repeat+mask, R as a
  reshape-sum, zero indices moved,
- smoothed transfers P_s = (I − ω D⁻¹A) P_t applied *lazily* as a
  composition of (structured P_t, DIA SpMV, diagonal scale)
  (:class:`SmoothedTransferP`/``R``) — the algebraic smoothed-aggregation
  operator without materializing its widened stencil,
- smoothers: Chebyshev (SpMV + AXPY only), coarsest: dense solve.

``build_structured_multigrid`` assembles the full hierarchy: the Galerkin
coarse matrices are still computed exactly (host SpGEMM of the smoothed
P, reference interpolation/mod.rs:824-828), so convergence is identical
to materialized SA — only the *application* of P/R is restructured.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tpu_amg.linop import LinearOperator, SparseOperator, aslinearoperator
from tpu_amg.partition.partition import Partition
from tpu_amg.preconditioners.chebyshev import ChebyshevSmoother
from tpu_amg.preconditioners.coarse import build_coarse_solver
from tpu_amg.preconditioners.multigrid import Level, Multigrid
from tpu_amg.sparse import CSR
from tpu_amg.sparse.ops import from_coo, spgemm


def structured_partition(grid_shape: Tuple[int, ...], factor: int = 2):
    """Factor-f aggregation of a tensor grid; returns (Partition,
    coarse_shape)."""
    coarse_shape = tuple((s + factor - 1) // factor for s in grid_shape)
    idx = np.indices(grid_shape)
    agg = np.zeros(grid_shape, dtype=np.int64)
    stride = 1
    for d in reversed(range(len(grid_shape))):
        agg += (idx[d] // factor) * stride
        stride *= coarse_shape[d]
    return Partition(agg.reshape(-1)), coarse_shape


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class StructuredInterp(LinearOperator):
    """Tentative P for factor-2 tensor aggregation, applied as
    repeat + weight (mv) / weighted reshape-sum (rmv). ``weights`` are
    the per-fine-node tentative-P entries (1/√|agg| for the constant
    candidate)."""

    weights: jax.Array  # (n_fine,)
    fine_shape: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    coarse_shape: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    factor: int = dataclasses.field(default=2, metadata=dict(static=True))

    @property
    def shape(self):
        return (
            int(np.prod(self.fine_shape)),
            int(np.prod(self.coarse_shape)),
        )

    def mv(self, xc):
        up = xc.reshape(self.coarse_shape)
        for d, (fs, cs) in enumerate(zip(self.fine_shape, self.coarse_shape)):
            up = jnp.repeat(up, self.factor, axis=d)
            if up.shape[d] != fs:
                up = jax.lax.slice_in_dim(up, 0, fs, axis=d)
        return self.weights * up.reshape(-1)

    def rmv(self, xf):
        w = (self.weights * xf).reshape(self.fine_shape)
        for d, (fs, cs) in enumerate(zip(self.fine_shape, self.coarse_shape)):
            pad_to = cs * self.factor
            if pad_to != fs:
                pads = [(0, 0)] * w.ndim
                pads[d] = (0, pad_to - fs)
                w = jnp.pad(w, pads)
            new_shape = w.shape[:d] + (cs, self.factor) + w.shape[d + 1 :]
            w = w.reshape(new_shape).sum(axis=d + 1)
        return w.reshape(-1)

    def mm(self, xs):
        return jax.vmap(self.mv, in_axes=1, out_axes=1)(xs)

    def rmm(self, xs):
        return jax.vmap(self.rmv, in_axes=1, out_axes=1)(xs)

    def to_csr(self) -> CSR:
        """Materialize (host) for Galerkin products."""
        part, _ = structured_partition(self.fine_shape, self.factor)
        n_f = int(np.prod(self.fine_shape))
        return from_coo(
            np.arange(n_f),
            part.node_to_agg,
            np.asarray(self.weights),
            (n_f, part.num_aggs),
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SmoothedTransferP(LinearOperator):
    """P_s = (I − ω D⁻¹ A) P_t applied lazily (no widened stencil)."""

    tentative: StructuredInterp
    a: LinearOperator  # fine-level operator (DIA)
    d_inv: jax.Array  # ω·D⁻¹ (includes the 0.66 weight)

    @property
    def shape(self):
        return self.tentative.shape

    def mv(self, xc):
        px = self.tentative.mv(xc)
        # barrier: without it XLA fuses the repeat-upsample INTO the
        # DIA slice-FMA loop, degenerating to gather-like code
        # (~15x slower, measured); materializing px keeps both passes
        # stream-shaped
        px = jax.lax.optimization_barrier(px)
        return px - self.d_inv * self.a.mv(px)

    def rmv(self, xf):
        # P_sᵀ = P_tᵀ (I − A D⁻¹ω)  (A symmetric)
        return self.tentative.rmv(xf - self.a.mv(self.d_inv * xf))

    def mm(self, xs):
        px = self.tentative.mm(xs)
        px = jax.lax.optimization_barrier(px)
        return px - self.d_inv[:, None] * self.a.mm(px)

    def rmm(self, xs):
        return self.tentative.rmm(xs - self.a.mm(self.d_inv[:, None] * xs))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TransposeOp(LinearOperator):
    inner: LinearOperator

    @property
    def shape(self):
        return (self.inner.shape[1], self.inner.shape[0])

    def mv(self, x):
        return self.inner.rmv(x)

    def mm(self, xs):
        return self.inner.rmm(xs)

    def rmv(self, x):
        return self.inner.mv(x)

    def rmm(self, xs):
        return self.inner.mm(xs)


def build_structured_multigrid(
    a: CSR,
    grid_shape: Tuple[int, ...],
    *,
    coarsest_dim: int = 1000,
    smoothing: bool = True,
    jacobi_weight: float = 0.66,
    chebyshev_degree: int = 3,
    dtype=jnp.float32,
) -> Multigrid:
    """Fully gather-free SA multigrid for a stencil operator on a tensor
    grid. Galerkin coarse matrices are exact (host SpGEMM with the
    smoothed P); only the transfer *application* uses the lazy form.
    """
    levels = []
    cur = a
    cur_shape = grid_shape
    while cur.nrows > coarsest_dim and min(cur_shape) >= 4:
        part, coarse_shape = structured_partition(cur_shape)
        sizes = part.expand_blocks(1).agg_sizes()
        weights_np = 1.0 / np.sqrt(sizes[part.node_to_agg].astype(np.float64))
        if cur.nrows <= 4096:
            # small mid levels: one dense matvec
            from tpu_amg.linop import DenseOperator

            a_op: LinearOperator = DenseOperator(
                mat=jnp.asarray(cur.to_dense(), dtype=dtype)
            )
        else:
            # Galerkin stencils widen to ~125 diagonals on coarse levels;
            # keep them DIA (slice-FMAs), never ELL gathers
            a_op = SparseOperator.from_csr(
                cur, dtype=dtype, dia_max_diags=160, dia_max_density=8.0
            )
        tent = StructuredInterp(
            weights=jnp.asarray(weights_np, dtype=dtype),
            fine_shape=cur_shape,
            coarse_shape=coarse_shape,
        )
        p_csr = tent.to_csr()
        if smoothing:
            diag = cur.diagonal()
            d_inv = jnp.asarray(jacobi_weight / diag, dtype=dtype)
            p_dev: LinearOperator = SmoothedTransferP(
                tentative=tent, a=a_op, d_inv=d_inv
            )
            from tpu_amg.interpolation.sa import smooth_interpolation

            p_csr = smooth_interpolation(cur, p_csr, jacobi_weight)
        else:
            p_dev = tent
        r_csr = p_csr.transpose()
        coarse = spgemm(r_csr, spgemm(cur, p_csr))

        d_inv_sm = jnp.asarray(1.0 / cur.abs_row_sums(), dtype=dtype)
        smoother = ChebyshevSmoother.build(
            a_op, d_inv_sm, degree=chebyshev_degree
        )
        levels.append(
            Level(a=a_op, smoother=smoother, r=TransposeOp(inner=p_dev), p=p_dev)
        )
        cur = coarse
        cur_shape = coarse_shape
    coarse_solver = build_coarse_solver("cholesky", cur, dtype=dtype)
    return Multigrid(
        levels=tuple(levels),
        coarse_solver=coarse_solver,
        mu=1,
        smoothing_steps=1,
    )
