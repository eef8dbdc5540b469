"""V-cycle wall-time benchmark (BASELINE.md: "V-cycle wall-time
speed-of-light per-kernel").

Builds the gather-free structured SA multigrid on a 3-D Poisson problem
(default 64³ = 262k dofs) and times one full V-cycle application on the
device, plus its speed-of-light estimate from the sum of per-kernel
minimum traffic at the measured stream rate.

Prints one JSON line naming the device (vs_baseline = SOL-estimate /
measured; 1.0 means the cycle runs at the sum-of-kernels roofline).

Usage (GPU only):  python bench_vcycle.py [--grid 64] [--reps 200]
"""

import argparse
import json
import sys
import time


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--grid", type=int, default=64, help="grid side")
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from bench import copy_bandwidth
    from tpu_amg.structured import build_structured_multigrid
    from tpu_amg.utils.platform import require_gpu
    from tpu_amg.utils.problems import poisson3d

    dev = require_gpu()
    print(f"# {dev['card']}", file=sys.stderr, flush=True)
    n_grid = args.grid
    t0 = time.time()
    a = poisson3d(n_grid)
    mg = build_structured_multigrid(
        a, (n_grid,) * 3, coarsest_dim=1500, dtype=jnp.float32
    )
    print(
        f"# setup {time.time()-t0:.1f}s: {len(mg.levels)+1} levels, "
        f"fine n={a.nrows} nnz={a.nnz}",
        file=sys.stderr, flush=True,
    )

    x = jnp.ones(a.nrows, dtype=jnp.float32)
    reps = args.reps

    @jax.jit
    def cycle_n(m, v):
        def body(u, _):
            return m.mv(u), None

        u, _ = jax.lax.scan(body, v, None, length=reps)
        return u

    jax.block_until_ready(cycle_n(mg, x))
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(cycle_n(mg, x))
        best = min(best, (time.perf_counter() - t0) / reps)

    # mixed-precision cycles (precision.py): bf16 value streams halve the
    # memory traffic of every level; measure both modes against f32
    from tpu_amg.precision import cast_preconditioner

    best16 = {}
    for mode in ("bf16_values", "bf16"):
        mg16 = cast_preconditioner(mg, mode)
        jax.block_until_ready(cycle_n(mg16, x))
        b16 = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(cycle_n(mg16, x))
            b16 = min(b16, (time.perf_counter() - t0) / reps)
        best16[mode] = b16
        print(f"# vcycle[{mode}]={b16*1e3:.3f}ms",
              file=sys.stderr, flush=True)

    # speed-of-light estimate: every level contributes
    # (pre+post smoothing = 2×deg SpMV passes + transfers + residual)
    bw = copy_bandwidth(reps)
    bytes_total = 0
    for lvl in mg.levels:
        n = lvl.a.shape[0]
        mat = getattr(lvl.a, "ell", None)
        nnz = getattr(mat, "nnz", n * n if mat is None else 7 * n)
        spmv_bytes = 4 * nnz + 8 * n
        # chebyshev degree-3 pre+post = 6 SpMVs + residual + 2 transfer
        # SpMV-equivalents (lazy smoothed P/R each contain one fine SpMV)
        bytes_total += 9 * spmv_bytes
    sol = bytes_total / bw

    print(
        f"# vcycle={best*1e3:.3f}ms sol={sol*1e3:.3f}ms bw={bw/1e9:.0f}GB/s",
        file=sys.stderr, flush=True,
    )
    solve_bench(mg, a, jax, jnp)
    out = {
        "metric": f"vcycle_wall_time_3d_poisson_{n_grid}cubed",
        "device": {k: dev[k] for k in ("platform", "kind", "count")},
        "card": dev["card"],
        "value": round(best * 1e3, 4),
        "unit": "ms",
        "vs_baseline": round(sol / best, 4),
    }
    for mode, b16 in best16.items():
        out[f"value_{mode}"] = round(b16 * 1e3, 4)
    print(json.dumps(out))


def solve_bench(mg, a, jax, jnp):
    """Full AMG-PCG solve wall time (secondary metric, stderr)."""
    from tpu_amg.linop import SparseOperator
    from tpu_amg.solvers import cg

    op = SparseOperator.from_csr(
        a, dtype=jnp.float32, dia_max_diags=160, dia_max_density=8.0
    )
    b = jnp.ones(a.nrows, dtype=jnp.float32)

    @jax.jit
    def solve(b):
        x, info = cg(op, b, mg, rtol=1e-6, maxiter=100)
        return x, info.iters, info.final_res

    x, iters, res = solve(b)
    jax.block_until_ready(x)
    dt = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        x, iters, res = solve(b)
        jax.block_until_ready(x)
        dt = min(dt, time.perf_counter() - t0)
    print(
        f"# full PCG solve: {dt*1e3:.1f}ms, {int(iters)} iters, "
        f"res {float(res):.2e}",
        file=sys.stderr, flush=True,
    )

    # same solve with a bf16-valued preconditioner cycle (f32 outer CG)
    from tpu_amg.precision import cast_preconditioner

    mg16 = cast_preconditioner(mg, "bf16_values")

    @jax.jit
    def solve16(b):
        x, info = cg(op, b, mg16, rtol=1e-6, maxiter=100)
        return x, info.iters, info.final_res

    x, iters, res = solve16(b)
    jax.block_until_ready(x)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        x, iters, res = solve16(b)
        jax.block_until_ready(x)
        best = min(best, time.perf_counter() - t0)
    print(
        f"# full PCG solve[bf16_values cycle]: {best*1e3:.1f}ms, "
        f"{int(iters)} iters, res {float(res):.2e}",
        file=sys.stderr, flush=True,
    )


if __name__ == "__main__":
    main()
