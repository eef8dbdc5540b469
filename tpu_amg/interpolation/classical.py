"""Classical AMG coarsening: compatible relaxation + least-squares
interpolation.

Reference ``ClassicalConfig`` + ``least_squares``
(interpolation/mod.rs:159-728):

**Compatible relaxation** (mod.rs:574-652): grow the C-point set by
maximal independent sets over the strength graph until relaxation on the
F-point subsystem A_F (C rows/cols identity-zeroed) contracts u₀ = 1 by
at least ``target_convergence`` per sweep; after each round, points that
relax slowly (σᵢ = |uᵢ|/‖u‖∞ > 1−ρ) are re-flagged as candidate F.

**LS interpolation** (mod.rs:654-709 + 433-510): for each non-C point,
candidate C-set = C-points within graph distance ``search_depth +
depth_ls``; enumerate all subsets up to ``max_interp``, solving per
subset either a constrained QP (weights ≥ 0, Σ ≤ 1: unconstrained
pseudo-inverse first, then the Σ=1 KKT system) or ridge-regularized LS;
accept a larger set only if err < accepted_err^(τ·Δr), τ = 1.2.

Batched deviation: subset solves are *batched* — for each point and
subset size r, all C(L, r) Gram subsystems are solved as one batched
pseudo-inverse/KKT solve instead of the reference's per-subset loop.
Numerics are identical.
"""

from __future__ import annotations

import dataclasses
import logging
from itertools import combinations
from typing import Optional

import numpy as np

from tpu_amg.interpolation.sa import GalerkinCoarse
from tpu_amg.partition import Partition, PartitionerConfig, strength_graph
from tpu_amg.preconditioners.block_smoother import BlockSmoother, host_apply
from tpu_amg.sparse import CSR, spgemm
from tpu_amg.sparse.ops import from_coo

logger = logging.getLogger(__name__)

# weight-validation constants (reference mod.rs:363-365, 394-396)
MIN_ABS = 1e-10
MIN_REL = 1e-2
FEAS_TOL = 1e-12
RIDGE_ETA = 1e-2

# point states
_F, _C, _N = 0, 1, 2


@dataclasses.dataclass
class CompatibleRelaxationConfig:
    """Defaults: target 0.3, 5 relax steps (mod.rs:236-243)."""

    target_convergence: float = 0.3
    relax_steps: int = 5
    max_iters: int = 50  # safety cap (the reference loops unboundedly)


@dataclasses.dataclass
class LeastSquaresConfig:
    """Defaults: search 3, depth_ls 2, max_interp 3, τ 1.2
    (mod.rs:215-232).

    ``max_candidates`` is a scaling deviation from the reference: the
    reference enumerates every C-point within the search radius
    (mod.rs:674-676), which on a 2-D stencil at ≥100k dofs means ~50+
    candidates and C(50,3) ≈ 2·10⁴ subset solves *per point*.  We rank
    the radius-ball candidates by strength-graph path weight and keep the
    strongest ``max_candidates``, so every point takes the batched solve
    path; subsets are still enumerated exhaustively within the kept set.
    """

    search_depth: int = 3
    depth_ls: int = 2
    solver: str = "constrained"  # or "regularized"
    max_interp: int = 3
    tau_threshold: float = 1.2
    max_candidates: int = 16


@dataclasses.dataclass
class ClassicalConfig:
    cr_options: CompatibleRelaxationConfig = dataclasses.field(
        default_factory=CompatibleRelaxationConfig
    )
    ls_options: LeastSquaresConfig = dataclasses.field(
        default_factory=LeastSquaresConfig
    )
    smoother_coarsening_factor: float = 256.0  # mod.rs:172-178

    def build(self, a: CSR, near_null, nn_weights) -> GalerkinCoarse:
        near_null = np.asarray(near_null, dtype=np.float64)
        if near_null.ndim == 1:
            near_null = near_null[:, None]
        smoother_cfg = PartitionerConfig(
            coarsening_factor=min(self.smoother_coarsening_factor, a.nrows / 2)
        )
        smoother_partition = smoother_cfg.build_partition(
            a, near_null, nn_weights
        ).expand_blocks(a.block_size)
        return least_squares_interpolation(
            a,
            smoother_partition,
            near_null,
            np.asarray(nn_weights, dtype=np.float64),
            self.cr_options,
            self.ls_options,
        )


# ----------------------------------------------------------------------
# compatible relaxation
# ----------------------------------------------------------------------
def compatible_relaxation(
    a: CSR,
    graph,
    smoother_partition: Partition,
    cr: CompatibleRelaxationConfig,
) -> np.ndarray:
    """Select C-points; returns the point-state array (F/C/N)
    (reference mod.rs:574-652)."""
    n = a.nrows
    u0 = np.ones(n)
    state = np.full(n, _F, dtype=np.int8)
    reduction = 1.0
    sm_cache = None  # CR rounds re-zero C rows/cols only: the smoother
    # rebuild is incremental (changed aggregates re-factorized, others
    # reused)

    # The whole CR loop runs on HOST: it is a setup-phase algorithm whose
    # matrix pattern would otherwise change shape every round and force a
    # fresh XLA compile of the relaxation (minutes per round at 100k+
    # dofs).  Numerics match ErrorPropagator(a_f, m_f, relax_steps).mv
    # exactly: u ← u − M(A_F u), relax_steps times.
    rows, cols, vals = a.coo()
    diag_pos = np.flatnonzero(rows == cols)
    full_diag = len(diag_pos) == n and np.array_equal(
        rows[diag_pos], np.arange(n)
    )
    for _ in range(cr.max_iters):
        if reduction <= cr.target_convergence:
            break
        f_mask = state == _F
        if f_mask.any():
            new_c = graph.maximal_independent_set(f_mask.copy())
            state[new_c] = _C
        # A_F: C rows/cols zeroed, unit diagonal at C
        not_c = (state != _C).astype(np.float64)
        vals_f = vals * not_c[rows] * not_c[cols]
        if full_diag:
            # fixed sparsity pattern: flip the existing diagonal entries
            vals_f[diag_pos[state == _C]] = 1.0
            a_f = dataclasses.replace(a, data=vals_f, block_size=1)
        else:  # pattern lacks diagonal entries somewhere: rebuild
            c_idx = np.flatnonzero(state == _C)
            a_f = CSR.from_coo(
                np.concatenate([rows, c_idx]),
                np.concatenate([cols, c_idx]),
                np.concatenate([vals_f, np.ones(len(c_idx))]),
                a.shape,
            )

        _, sm_cache = BlockSmoother.build_cached(
            a_f, smoother_partition, cache=sm_cache, host_only=True
        )
        a_f_sp = a_f.to_scipy()
        u = not_c * u0
        start_norm = np.linalg.norm(u)
        for _step in range(cr.relax_steps):
            u = u - host_apply(sm_cache, a_f_sp @ u)
        end_norm = np.linalg.norm(u)
        reduction = (end_norm / max(start_norm, 1e-300)) ** (
            1.0 / cr.relax_steps
        )
        # re-flag slow-to-converge points (mod.rs:636-646)
        tol = 1.0 - reduction
        inf_norm = np.abs(u).max()
        sigma = np.abs(u) / max(inf_norm, 1e-300)
        slow = sigma > tol
        state = np.where(slow & (state != _C), _F, state)
        state = np.where((~slow) & (state == _F), _N, state).astype(np.int8)
        logger.info(
            "CR round: reduction=%.3f C=%d/%d",
            reduction, int((state == _C).sum()), n,
        )
    return state


# ----------------------------------------------------------------------
# LS weight solvers (batched over subsets)
# ----------------------------------------------------------------------
def _batched_pinv_solve(gram: np.ndarray, rhs: np.ndarray) -> np.ndarray:
    """x = pinv(G) @ rhs for batched (s, r, r) and (s, r)."""
    w, q = np.linalg.eigh(gram)
    cutoff = (
        np.maximum(np.abs(w).max(axis=1), 1e-300)[:, None]
        * gram.shape[1]
        * np.finfo(np.float64).eps
    )
    inv_w = np.where(np.abs(w) > cutoff, 1.0 / np.where(w == 0, 1.0, w), 0.0)
    return np.einsum("sij,sj,skj,sk->si", q, inv_w, q, rhs)


def _eval_err(gram, p, g, btb):
    quad = np.einsum("si,sij,sj->s", p, gram, p)
    lin = np.einsum("si,si->s", g, p)
    return btb + quad - 2.0 * lin


def _validate_constrained(p: np.ndarray) -> np.ndarray:
    """(s,) bool mask: finite, ≥ min_abs, Σ ≤ 1+feas, ≥ min_rel·max
    (reference validate_weights_constrained, mod.rs:311-335)."""
    finite = np.isfinite(p).all(axis=1)
    pos = (p >= MIN_ABS).all(axis=1)
    sums = p.sum(axis=1) <= 1.0 + FEAS_TOL
    maxw = p.max(axis=1, initial=0.0)
    rel = (p >= MIN_REL * maxw[:, None]).all(axis=1)
    return finite & pos & sums & rel


def _validate_regularized(p: np.ndarray) -> np.ndarray:
    """|p| version for the regularized path (mod.rs:293-309)."""
    finite = np.isfinite(p).all(axis=1)
    absp = np.abs(p)
    big = (absp >= MIN_ABS).all(axis=1)
    maxw = absp.max(axis=1, initial=0.0)
    rel = (absp >= MIN_REL * maxw[:, None]).all(axis=1)
    return finite & big & rel


def _spd_solve_small(gram: np.ndarray, rhs: np.ndarray):
    """Batched solve G x = rhs for r ≤ 3 via closed-form inverses (pure
    vectorized arithmetic — the eigh-based pseudo-inverse costs ~1000x
    more per system and dominated classical setup).  Returns (x, ok)
    where ok flags rows whose residual certifies the solve; callers send
    ~ok rows to the eigh pseudo-inverse fallback (pinv-with-cutoff
    semantics preserved exactly where it matters)."""
    s, r = rhs.shape
    g = gram
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        if r == 1:
            x = rhs / g[:, 0, 0:1]
        elif r == 2:
            det = g[:, 0, 0] * g[:, 1, 1] - g[:, 0, 1] * g[:, 1, 0]
            x = np.empty_like(rhs)
            x[:, 0] = (g[:, 1, 1] * rhs[:, 0] - g[:, 0, 1] * rhs[:, 1]) / det
            x[:, 1] = (g[:, 0, 0] * rhs[:, 1] - g[:, 1, 0] * rhs[:, 0]) / det
        elif r == 3:
            a, b, c = g[:, 0, 0], g[:, 0, 1], g[:, 0, 2]
            d, e, f = g[:, 1, 0], g[:, 1, 1], g[:, 1, 2]
            h, i, j = g[:, 2, 0], g[:, 2, 1], g[:, 2, 2]
            A = e * j - f * i
            B = -(d * j - f * h)
            C = d * i - e * h
            det = a * A + b * B + c * C
            x = np.empty_like(rhs)
            r0, r1, r2 = rhs[:, 0], rhs[:, 1], rhs[:, 2]
            x[:, 0] = (A * r0 - (b * j - c * i) * r1 + (b * f - c * e) * r2) / det
            x[:, 1] = (B * r0 + (a * j - c * h) * r1 - (a * f - c * d) * r2) / det
            x[:, 2] = (C * r0 - (a * i - b * h) * r1 + (a * e - b * d) * r2) / det
        else:
            return _batched_pinv_solve(gram, rhs), np.ones(s, dtype=bool)
    # residual certification: ‖Gx − rhs‖∞ ≤ tol·(‖rhs‖∞ + ‖G‖‖x‖)
    gx = np.einsum("sij,sj->si", g, x)
    scale = np.abs(rhs).max(axis=1) + np.abs(g).max(axis=(1, 2)) * np.abs(
        x
    ).max(axis=1)
    ok = np.isfinite(x).all(axis=1) & (
        np.abs(gx - rhs).max(axis=1) <= 1e-9 * np.maximum(scale, 1e-300)
    )
    return x, ok


def _solve_lin(gram: np.ndarray, rhs: np.ndarray) -> np.ndarray:
    """Closed-form solve with eigh-pseudo-inverse fallback on rows the
    residual check rejects (singular/ill-conditioned Grams)."""
    x, ok = _spd_solve_small(gram, rhs)
    bad = np.flatnonzero(~ok)
    if len(bad):
        x[bad] = _batched_pinv_solve(gram[bad], rhs[bad])
    return x


def _solve_subsets_constrained(gram_ff, gf, btb):
    """Constrained QP per subset: pinv candidate, then Σ=1 KKT candidate
    (reference constrained_subset_qp, mod.rs:387-431).  Returns
    (weights (s, r), err (s,), valid (s,)).

    The KKT system [[G, 1], [1ᵀ, 0]][p; λ] = [g; 1] is solved in
    bordered form (p = y_g − λ·y_1 with y_g = G⁻¹g, y_1 = G⁻¹1 and
    λ = (1ᵀy_g − 1)/(1ᵀy_1)) and only for the subsets whose
    unconstrained candidate failed validation — the reference takes the
    same pinv-first shortcut per subset (mod.rs:398-414)."""
    s, r = gf.shape
    p_a = _solve_lin(gram_ff, gf)
    ok_a = _validate_constrained(p_a)

    p = p_a.copy()
    valid = ok_a.copy()
    need = np.flatnonzero(~ok_a)
    if len(need):
        g_n = gram_ff[need]
        y_g = p_a[need]
        y_1 = _solve_lin(g_n, np.ones((len(need), r)))
        with np.errstate(divide="ignore", invalid="ignore"):
            lam = (y_g.sum(axis=1) - 1.0) / y_1.sum(axis=1)
        p_b = y_g - lam[:, None] * y_1
        ok_b = _validate_constrained(p_b) & np.isfinite(lam)
        p[need] = np.where(ok_b[:, None], p_b, y_g)
        valid[need] = ok_b
    err = _eval_err(gram_ff, p, gf, btb)
    return p, err, valid


def _solve_subsets_regularized(gram_ff, gf, btb):
    """Ridge-regularized LS per subset (reference weighted_least_squares,
    mod.rs:358-385): λ = η·λ_max(G), p = pinv(G + λI) g."""
    r = gf.shape[1]
    lam = RIDGE_ETA * np.linalg.eigvalsh(gram_ff)[:, -1]
    reg = gram_ff + lam[:, None, None] * np.eye(r)
    p = _solve_lin(reg, gf)
    valid = _validate_regularized(p)
    err = _eval_err(gram_ff, p, gf, btb)
    return p, err, valid


def ls_interp_weights(
    vf: np.ndarray,
    vc: np.ndarray,
    d: np.ndarray,
    max_interp: int,
    gamma: Optional[float],
    mode: str,
):
    """Best interpolation subset + weights for one fine point
    (reference ls_interp_weights, mod.rs:433-510).

    Returns (weights, set indices into vc rows, err)."""
    ell = vc.shape[0]
    vc_d = vc * d
    gram = vc_d @ vc.T
    g = vc_d @ vf
    btb = float(vf @ (d * vf))

    accepted_w = np.zeros(0)
    accepted_set: list = []
    accepted_err = btb
    solver = (
        _solve_subsets_constrained
        if mode == "constrained"
        else _solve_subsets_regularized
    )

    for r in range(1, min(ell, max_interp) + 1):
        idx = np.array(list(combinations(range(ell), r)), dtype=np.int64)
        gram_ff = gram[idx[:, :, None], idx[:, None, :]]
        gf = g[idx]
        p, err, valid = solver(gram_ff, gf, btb)
        if not valid.any():
            continue
        err = np.where(valid, err, np.inf)
        best = int(np.argmin(err))
        best_err = float(err[best])
        if gamma is None:
            accept = best_err < accepted_err
        else:
            dr = r - len(accepted_set)
            accept = best_err < accepted_err ** (gamma * dr)
        if accept:
            accepted_w = p[best]
            accepted_set = idx[best].tolist()
            accepted_err = best_err
    return accepted_w, accepted_set, accepted_err


def _ls_interp_weights_batch(
    vf_all: np.ndarray,  # (P, k)
    vc_all: np.ndarray,  # (P, L, k)
    d: np.ndarray,
    max_interp: int,
    gamma: float,
    mode: str,
):
    """Batched ls_interp_weights over P points sharing candidate count L.

    Returns (weights (P, max_interp), local set ids (P, max_interp),
    sizes (P,)). Identical numerics to the per-point path — the subset
    enumeration is shared across the bucket and every Gram subsystem is
    solved in one batched pseudo-inverse/KKT pass.
    """
    p_count, ell, k = vc_all.shape
    vc_d = vc_all * d  # (P, L, k)
    gram = np.einsum("plk,pqk->plq", vc_d, vc_all)
    g = np.einsum("plk,pk->pl", vc_d, vf_all)
    btb = np.einsum("pk,pk->p", vf_all, vf_all * d)

    acc_w = np.zeros((p_count, max_interp))
    acc_set = np.zeros((p_count, max_interp), dtype=np.int64)
    acc_size = np.zeros(p_count, dtype=np.int64)
    acc_err = btb.copy()
    solver = (
        _solve_subsets_constrained
        if mode == "constrained"
        else _solve_subsets_regularized
    )

    for r in range(1, min(ell, max_interp) + 1):
        idx = np.array(list(combinations(range(ell), r)), dtype=np.int64)
        s_count = len(idx)
        gram_ff = gram[:, idx[:, :, None], idx[:, None, :]]  # (P,S,r,r)
        gf = g[:, idx]  # (P, S, r)
        w_flat, err_flat, valid_flat = solver(
            gram_ff.reshape(p_count * s_count, r, r),
            gf.reshape(p_count * s_count, r),
            np.repeat(btb, s_count),
        )
        err = np.where(valid_flat, err_flat, np.inf).reshape(p_count, s_count)
        w = w_flat.reshape(p_count, s_count, r)
        best = np.argmin(err, axis=1)  # (P,)
        best_err = err[np.arange(p_count), best]
        has_valid = np.isfinite(best_err)
        if gamma is None:
            accept = best_err < acc_err
        else:
            dr = r - acc_size
            accept = best_err < acc_err ** (gamma * dr)
        accept &= has_valid
        sel = np.flatnonzero(accept)
        if len(sel):
            acc_w[sel, :r] = w[sel, best[sel]]
            acc_w[sel, r:] = 0.0
            acc_set[sel, :r] = idx[best[sel]]
            acc_size[sel] = r
            acc_err[sel] = best_err[sel]
    return acc_w, acc_set, acc_size


# ----------------------------------------------------------------------
# full classical coarsening
# ----------------------------------------------------------------------
class CoarseFineSplit(Partition):
    """C/F split exposed as a Partition-like object: aggregate g = the
    g-th C-point plus the F-points it interpolates from is not tracked;
    instead we keep the sorted C-point list (reference CoarseFineSplit,
    mod.rs:512-537)."""

    def __init__(self, c_points: np.ndarray, n: int):
        self.c_points = np.sort(np.asarray(c_points, dtype=np.int64))
        node_to_agg = np.zeros(n, dtype=np.int64)
        node_to_agg[self.c_points] = np.arange(len(self.c_points))
        # F-points nominally belong to the nearest C aggregate only for
        # stats; store a trivial map: own C id for C-points, 0 otherwise.
        super().__init__(node_to_agg)
        self.n_fine = n

    def coarse_idx(self, fine_idx: int) -> Optional[int]:
        pos = np.searchsorted(self.c_points, fine_idx)
        if pos < len(self.c_points) and self.c_points[pos] == fine_idx:
            return int(pos)
        return None


def least_squares_interpolation(
    a: CSR,
    smoother_partition: Partition,
    near_null: np.ndarray,
    nn_weights: np.ndarray,
    cr: CompatibleRelaxationConfig,
    ls: LeastSquaresConfig,
) -> GalerkinCoarse:
    """Reference ``least_squares`` (mod.rs:539-728)."""
    n = a.nrows
    k = near_null.shape[1]
    d = nn_weights[:k]
    graph = strength_graph(a, near_null, nn_weights, ls.search_depth)
    state = compatible_relaxation(a, graph, smoother_partition, cr)

    c_points = np.flatnonzero(state == _C)
    n_coarse = len(c_points)
    if n_coarse == 0:
        raise RuntimeError("compatible relaxation selected no C-points")
    split = CoarseFineSplit(c_points, n)
    coarse_nn = near_null[split.c_points]

    # candidate search: C-points reachable in the θ-filtered strength
    # graph (the reference searches its AdjacencyList the same way,
    # mod.rs:674-676), ranked by path weight and capped at
    # ls.max_candidates so the subset solves stay batched at scale.
    hops = max(1, -(-(ls.search_depth + ls.depth_ls) // ls.search_depth))
    reach = _candidate_matrix(graph, hops)
    is_c = state == _C

    rows_p = list(split.c_points)
    cols_p = list(range(n_coarse))
    vals_p = [1.0] * n_coarse
    c_rank = -np.ones(n, dtype=np.int64)
    c_rank[split.c_points] = np.arange(n_coarse)

    # group non-C points by candidate count L so all LS subset solves
    # for a bucket run as ONE batched linear-algebra pass (batched
    # replacement for the reference's rayon per-point loop,
    # mod.rs:670-702).  The grouping itself is vectorized numpy group-by
    # (no per-row Python loop — required for ≥100k-dof classical setup).
    indptr, indices = reach.indptr, reach.indices
    rows_r = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    sel = is_c[indices]
    rr, cc, ww = rows_r[sel], indices[sel], reach.data[sel]
    order = np.lexsort((-ww, rr))  # strongest-first within each row
    rr, cc = rr[order], cc[order]
    first = np.concatenate([[True], rr[1:] != rr[:-1]])
    starts = np.maximum.accumulate(np.where(first, np.arange(len(rr)), 0))
    keep_c = (np.arange(len(rr)) - starts) < ls.max_candidates
    rr, cc = rr[keep_c], cc[keep_c]
    cand_flat = cc  # candidate C-points, row-major order (rr sorted)
    cand_counts = np.bincount(rr, minlength=n)
    cand_offsets = np.concatenate([[0], np.cumsum(cand_counts)[:-1]])
    eligible = (~is_c) & (cand_counts > 0)

    batch_limit = 16  # C(16,3)=560 subsets: fine batched; beyond, loop
    rows_out = [np.asarray(rows_p, dtype=np.int64)]
    cols_out = [np.asarray(cols_p, dtype=np.int64)]
    vals_out = [np.asarray(vals_p, dtype=np.float64)]
    for ell_count in np.unique(cand_counts[eligible]):
        pts = np.flatnonzero(eligible & (cand_counts == ell_count))
        # (P, L) candidate table via offset arithmetic
        cands = cand_flat[
            cand_offsets[pts][:, None] + np.arange(ell_count)[None, :]
        ]
        if ell_count <= batch_limit:
            w_all, set_all, size_all = _ls_interp_weights_batch(
                near_null[pts], near_null[cands], d,
                ls.max_interp, ls.tau_threshold, ls.solver,
            )
            # flatten accepted (point, slot) pairs without a Python loop
            slot = np.arange(w_all.shape[1])[None, :]
            keep = slot < size_all[:, None]  # (P, max_interp)
            pi, si = np.nonzero(keep)
            rows_out.append(pts[pi])
            cols_out.append(c_rank[cands[pi, set_all[pi, si]]])
            vals_out.append(w_all[pi, si])
        else:
            for i, cand in zip(pts, cands):
                weights, subset, _ = ls_interp_weights(
                    near_null[i], near_null[cand], d,
                    ls.max_interp, ls.tau_threshold, ls.solver,
                )
                for w, local in zip(weights, subset):
                    rows_out.append(np.array([i]))
                    cols_out.append(np.array([c_rank[cand[local]]]))
                    vals_out.append(np.array([float(w)]))

    rows_p = np.concatenate(rows_out)
    cols_p = np.concatenate(cols_out)
    vals_p = np.concatenate(vals_out)

    p = from_coo(rows_p, cols_p, vals_p, (n, n_coarse))
    r = p.transpose()
    coarse_mat = spgemm(r, spgemm(a, p)).with_block_size(1)
    return GalerkinCoarse(
        interpolation=p,
        restriction=r,
        coarse_mat=coarse_mat,
        coarse_nn=coarse_nn,
        partition=split,
        kind="classical",
    )


def _candidate_matrix(graph, hops: int):
    """Weighted reachability over the symmetrized strength graph:
    ``hops`` powers of the θ-filtered adjacency, weights summed across
    path lengths (a ranking proxy for 'strongest nearby C-points')."""
    sym = graph._sym().tocsr()
    acc = sym.copy()
    reach = sym.copy()
    for _ in range(hops - 1):
        acc = (acc @ sym).tocsr()
        reach = (reach + acc).tocsr()
    reach.setdiag(0.0)
    reach.eliminate_zeros()
    return reach.tocsr()


