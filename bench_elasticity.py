"""3-D elasticity on one GPU: per-format SpMV benchmarks on the fine
level plus a full AMG-PCG solve wall time.

The reference's flagship use case is small-block vector problems
(3-D elasticity, block_size=3 — reference core.rs:22-36,
block_smoothers.rs:326-399); this driver measures the level-format
choices (DIA slice-FMA, BSR block gather, ELL scalar gather) on the
real matrix and then times the production solve path end to end.

Usage:  python bench_elasticity.py [--n 33] [--no-solve]   (GPU only)
Prints one JSON line with the device, the format table and solve
numbers.
"""

import argparse
import json
import sys
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=33,
                    help="grid points per dim (n^3*3 dofs)")
    ap.add_argument("--unstructured", action="store_true",
                    help="jittered-Delaunay truss elasticity (block-RCM "
                         "ordered; utils/problems.py "
                         "unstructured_elasticity_3d) instead of the "
                         "structured hex grid")
    ap.add_argument("--reps", type=int, default=400)
    ap.add_argument("--no-solve", action="store_true")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from tpu_amg.utils.platform import require_gpu

    dev = require_gpu()
    print(f"# {dev['card']}", file=sys.stderr, flush=True)
    reps = args.reps

    from tpu_amg.sparse.bsr import BSR
    from tpu_amg.sparse.dia import try_from_csr
    from tpu_amg.sparse.ell import ELL
    from tpu_amg.utils.problems import (
        elasticity_3d,
        unstructured_elasticity_3d,
    )

    t0 = time.perf_counter()
    a = (unstructured_elasticity_3d(args.n) if args.unstructured
         else elasticity_3d(args.n))
    print(f"# elasticity n={a.nrows} nnz={a.nnz} block={a.block_size} "
          f"(built {time.perf_counter()-t0:.1f}s)", file=sys.stderr, flush=True)
    x = jnp.ones((a.nrows,), dtype=jnp.float32)

    def time_mv(mat, x0=x):
        @jax.jit
        def spmv_n(v):
            def body(u, _):
                return mat.mv(u), None
            u, _ = jax.lax.scan(body, v, None, length=reps)
            return u.sum()

        jax.block_until_ready(spmv_n(x0))
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(spmv_n(x0))
            best = min(best, (time.perf_counter() - t0) / reps)
        return best

    fmts = {}
    dia = try_from_csr(a, dtype=jnp.float32, max_diags=200)
    if dia is not None:
        fmts["dia"] = (time_mv(dia), f"{dia.data.shape[0]} diagonals")
        fmts["dia_bf16v"] = (
            time_mv(dia.astype(jnp.bfloat16)),
            "bf16 value stream, f32 x/accumulate",
        )
    bsr = BSR.from_csr(a, dtype=jnp.float32)
    fmts["bsr"] = (time_mv(bsr), f"k={bsr.k} block cols")
    ell = ELL.from_csr(a, dtype=jnp.float32)
    fmts["ell"] = (time_mv(ell), f"k={ell.k}")

    out = {
        "metric": "elasticity3d_unstructured_formats" if args.unstructured
        else "elasticity3d_formats",
        "device": {k: dev[k] for k in ("platform", "kind", "count")},
        "card": dev["card"],
        "n": a.nrows,
        "nnz": a.nnz,
    }
    for name, (dt, desc) in fmts.items():
        gnnzs = a.nnz / dt / 1e9
        out[f"{name}_gnnzs"] = round(gnnzs, 3)
        print(f"# {name:5s} {dt*1e6:9.1f} us  {gnnzs:8.2f} Gnnz/s   {desc}",
              file=sys.stderr, flush=True)

    if not args.no_solve:
        from tpu_amg.solver import AMGSolver, SolverConfig
        from tpu_amg.sparse.csr import CSR

        cfg = SolverConfig(
            method="sa",
            interp_near_null_dim=6,
            coarsening_near_null_dim=12,
            smoothing_iters=8,
            coarsening_factor=8.0 * 2,  # aggregates of ~6 block-nodes
            dtype=jnp.float32,
        )
        t0 = time.perf_counter()
        solver = AMGSolver.setup(a, cfg)
        setup_s = time.perf_counter() - t0
        rng = np.random.default_rng(42)
        b = jnp.asarray(rng.standard_normal(a.nrows), dtype=jnp.float32)
        fn = solver.compile(rtol=1e-8, maxiter=300)
        xs, info = fn(b)
        jax.block_until_ready(xs)
        t0 = time.perf_counter()
        xs, info = fn(b)
        jax.block_until_ready(xs)
        solve_s = time.perf_counter() - t0
        iters = int(info.iters)
        out.update(
            setup_s=round(setup_s, 1),
            solve_ms=round(solve_s * 1e3, 1),
            cg_iters=iters,
            converged=bool(info.converged),
        )
        print(f"# solve: setup {setup_s:.1f}s, solve {solve_s*1e3:.1f}ms, "
              f"{iters} iters, converged={bool(info.converged)}",
              file=sys.stderr, flush=True)

        # bf16-valued preconditioner cycle (f32 outer CG)
        from tpu_amg.precision import cast_preconditioner
        from tpu_amg.solvers import cg as _cg

        mg16 = cast_preconditioner(solver.preconditioner, "bf16_values")

        @jax.jit
        def solve16(op_, m_, b_):
            x_, info_ = _cg(op_, b_, m_, rtol=1e-8, maxiter=300)
            return x_, info_.iters, info_.final_res

        xs, it16, _res = solve16(solver.op, mg16, b)
        jax.block_until_ready(xs)
        t0 = time.perf_counter()
        xs, it16, _res = solve16(solver.op, mg16, b)
        jax.block_until_ready(xs)
        solve16_s = time.perf_counter() - t0
        out.update(
            solve_ms_bf16_values=round(solve16_s * 1e3, 1),
            cg_iters_bf16_values=int(it16),
        )
        print(f"# solve[bf16_values]: {solve16_s*1e3:.1f}ms, {int(it16)} "
              f"iters", file=sys.stderr, flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
