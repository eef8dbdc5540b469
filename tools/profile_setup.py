"""Profile the unstructured 262k algebraic setup on the GPU's host.

Runs AMGSolver.setup under cProfile on the same system/config as
bench_unstructured.py and prints the top cumulative-time entries plus
per-phase wall times from the hierarchy logger.

Usage (GPU only): python tools/profile_setup.py [--side 512] [--no-profile]
"""

import argparse
import cProfile
import io
import logging
import pstats
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", type=int, default=512,
                    help="grid side (mirrors bench_unstructured.py)")
    ap.add_argument("--no-profile", action="store_true")
    ap.add_argument("--top", type=int, default=40)
    args = ap.parse_args()

    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(relativeCreated)8.0fms %(name)s %(message)s")

    import jax.numpy as jnp

    from tpu_amg.solver import AMGSolver, SolverConfig
    from tpu_amg.utils.platform import require_gpu
    from tpu_amg.utils.problems import unstructured_poisson_2d

    print(f"# {require_gpu()['card']}", file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    a = unstructured_poisson_2d(args.side)
    print(f"# system n={a.nrows} nnz={a.nnz} built {time.perf_counter()-t0:.1f}s",
          file=sys.stderr, flush=True)

    cfg = SolverConfig(
        coarsening_near_null_dim=8,
        interp_near_null_dim=2,
        smoothing_steps=1,
        smoothing_iters=10,
        coarsest_dim=1500,
        dtype=jnp.float32,
        dense_threshold=8192,
    )

    t0 = time.perf_counter()
    if args.no_profile:
        AMGSolver.setup(a, cfg)
        print(f"# setup {time.perf_counter()-t0:.1f}s", file=sys.stderr)
        return
    pr = cProfile.Profile()
    pr.enable()
    AMGSolver.setup(a, cfg)
    pr.disable()
    print(f"# setup (profiled) {time.perf_counter()-t0:.1f}s", file=sys.stderr)
    s = io.StringIO()
    ps = pstats.Stats(pr, stream=s).sort_stats("cumulative")
    ps.print_stats(args.top)
    ps.sort_stats("tottime").print_stats(args.top)
    print(s.getvalue())


if __name__ == "__main__":
    main()
