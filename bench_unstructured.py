"""Unstructured-FEM end-to-end bench: V-cycle + AMG-PCG solve wall time
on a Delaunay-triangulated FEM Laplacian (the matrix class the
reference's MFEM loader exists for, reference utils.rs:269-350).

Builds the same pseudo-unstructured system as bench.py (jittered grid,
random renumbering, Delaunay, RCM), runs the full algebraic SA setup,
and times:
  - one V-cycle (f32 and bf16_values precision modes),
  - the full PCG solve to rtol 1e-6.

Prints one JSON line naming the device.  GPU only.
Usage: python bench_unstructured.py [--side 512]        # side² dofs
       python bench_unstructured.py --dim 3 [--side 101]  # side³ dofs
--dim 3 is BASELINE.json configs[2]: ~1M-dof 3-D unstructured Poisson,
SA V-cycle + PCG, one GPU (tet-mesh band statistics: ~16 nnz/row).
"""

import argparse
import json
import sys
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", type=int, default=None,
                    help="grid side (side^dim dofs); defaults: dim 2 -> "
                         "512, dim 3 -> 101")
    ap.add_argument("--dim", type=int, default=2, choices=(2, 3))
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from tpu_amg.utils.platform import require_gpu

    dev = require_gpu()
    print(f"# {dev['card']}", file=sys.stderr, flush=True)
    side = args.side or (101 if args.dim == 3 else 512)
    reps = args.reps

    from tpu_amg.precision import cast_preconditioner
    from tpu_amg.solver import AMGSolver, SolverConfig
    from tpu_amg.solvers import cg
    from tpu_amg.sparse.csr import CSR
    from tpu_amg.utils.problems import (
        unstructured_poisson_2d,
        unstructured_poisson_3d,
    )

    t0 = time.perf_counter()
    if args.dim == 3:
        a = unstructured_poisson_3d(side)
    else:
        a = unstructured_poisson_2d(side)
    print(f"# unstructured n={a.nrows} nnz={a.nnz} "
          f"(built {time.perf_counter()-t0:.1f}s)", file=sys.stderr, flush=True)

    t0 = time.perf_counter()
    solver = AMGSolver.setup(
        a,
        SolverConfig(
            coarsening_near_null_dim=8,
            # cd=2 on a scalar isotropic problem: oc 1.64 vs 3.00 at the
            # reference-default cd=4; one smoothing step halves cycle
            # cost for a modest iteration increase
            interp_near_null_dim=2,
            smoothing_steps=1,
            smoothing_iters=10,
            coarsest_dim=1500,
            dtype=jnp.float32,
            dense_threshold=8192,  # mid levels as dense matvecs
        ),
    )
    mg = solver.preconditioner
    t_setup = time.perf_counter() - t0
    print(f"# setup {t_setup:.1f}s, "
          f"op complexity {solver.hierarchy.op_complexity():.2f}",
          file=sys.stderr, flush=True)
    # per-level device-format table (BASELINE configs[2] evidence)
    for i, lvl in enumerate(getattr(mg, "levels", ())):
        a_l = lvl.a
        fmt = type(getattr(a_l, "ell", a_l)).__name__
        print(f"# level {i}: n={a_l.shape[0]} fmt={fmt}",
              file=sys.stderr, flush=True)

    x = jnp.ones(a.nrows, dtype=jnp.float32)

    def time_cycle(m):
        @jax.jit
        def cycle_n(m_, v):
            def body(u, _):
                return m_.mv(u), None

            u, _ = jax.lax.scan(body, v, None, length=reps)
            return u

        jax.block_until_ready(cycle_n(m, x))
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(cycle_n(m, x))
            best = min(best, (time.perf_counter() - t0) / reps)
        return best

    dt_f32 = time_cycle(mg)
    print(f"# vcycle[f32]={dt_f32*1e3:.3f}ms", file=sys.stderr, flush=True)
    mg16 = cast_preconditioner(mg, "bf16_values")
    dt_16 = time_cycle(mg16)
    print(f"# vcycle[bf16_values]={dt_16*1e3:.3f}ms", file=sys.stderr,
          flush=True)

    # full solve, operators passed as arguments.
    # Manufactured rhs: the raw Laplacian is singular up to its 1e-8
    # regularization, so b = A·x_true keeps the solution representable
    # in f32 (b = ones is ~parallel to the near-null constant).
    x_true = jnp.asarray(
        np.random.default_rng(3).normal(size=a.nrows), jnp.float32
    )
    b = solver.op.mv(x_true)
    solve_times = {}
    iters = {}
    for name, m in (("f32", mg), ("bf16_values", mg16)):

        @jax.jit
        def solve(op_, m_, b_):
            x_, info = cg(op_, b_, m_, rtol=1e-6, maxiter=200)
            return x_, info.iters, info.final_res

        xs, it, res = solve(solver.op, m, b)
        jax.block_until_ready(xs)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            xs, it, res = solve(solver.op, m, b)
            jax.block_until_ready(xs)
            best = min(best, time.perf_counter() - t0)
        solve_times[name] = best
        iters[name] = int(it)
        print(f"# solve[{name}]: {best*1e3:.1f}ms, {int(it)} iters, "
              f"res {float(res):.2e}", file=sys.stderr, flush=True)

    print(
        json.dumps(
            {
                "metric": f"unstructured_fem{args.dim}d_vcycle_{a.nrows}",
                "device": {k: dev[k] for k in ("platform", "kind", "count")},
                "card": dev["card"],
                "setup_s": round(t_setup, 1),
                "value": round(dt_f32 * 1e3, 4),
                "unit": "ms",
                "vs_baseline": round(dt_f32 / dt_16, 4),
                "value_bf16_values": round(dt_16 * 1e3, 4),
                "solve_ms_f32": round(solve_times["f32"] * 1e3, 2),
                "solve_ms_bf16_values": round(
                    solve_times["bf16_values"] * 1e3, 2
                ),
                "iters_f32": iters["f32"],
                "iters_bf16_values": iters["bf16_values"],
            }
        )
    )


if __name__ == "__main__":
    main()
