"""Solve executable with the operators closed over vs passed as
arguments, on one GPU.

Sets up the 3-D 7-point Poisson of chip_smoke.py's phase A with the
default ``SolverConfig`` and builds the PCG + V-cycle program twice: once
with the system operator and preconditioner closed over (compile-time
constants of the executable), once with them passed as jit arguments
(``AMGSolver.compile``'s form).  For each it prints the compile time and
the best of three solve times, in the order constants, arguments,
arguments, constants.  The persistent compile cache is off so that every
compile is timed cold.

Usage (GPU only):  python tools/solve_paths.py [--side 100] [--seed 0]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--side", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rtol", type=float, default=1e-8)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from tpu_amg.solver import AMGSolver, SolverConfig
    from tpu_amg.solvers import cg
    from tpu_amg.utils.platform import require_gpu
    from tpu_amg.utils.problems import poisson3d

    dev = require_gpu()
    card = dev["card"]
    jax.config.update("jax_enable_compilation_cache", False)
    a = poisson3d(args.side)
    t0 = time.perf_counter()
    solver = AMGSolver.setup(a, SolverConfig(seed=args.seed))
    print(f"setup {time.perf_counter() - t0:.1f} s, n={a.nrows} [{card}]",
          flush=True)
    op, pc = solver.op, solver.preconditioner
    b = jnp.asarray(np.random.default_rng(args.seed).standard_normal(a.nrows))
    rtol = args.rtol

    def closed(b_):
        return cg(op, b_, pc, rtol=rtol, maxiter=500)

    def passed(op_, pc_, b_):
        return cg(op_, b_, pc_, rtol=rtol, maxiter=500)

    forms = {
        "constants": (closed, (b,)),
        "arguments": (passed, (op, pc, b)),
    }
    for name in ("constants", "arguments", "arguments", "constants"):
        fn, fargs = forms[name]
        t0 = time.perf_counter()
        compiled = jax.jit(fn).lower(*fargs).compile()
        t_compile = time.perf_counter() - t0
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            x, info = compiled(*fargs)
            jax.block_until_ready(x)
            best = min(best, time.perf_counter() - t0)
        mem = compiled.memory_analysis()
        const_mb = getattr(mem, "generated_code_size_in_bytes", 0) / 1e6
        print(
            f"{name}: compile {t_compile:.2f} s, solve {best * 1e3:.2f} ms, "
            f"{int(info.iters)} iterations, generated code {const_mb:.1f} MB "
            f"[{card}]",
            flush=True,
        )


if __name__ == "__main__":
    main()
