"""Per-level, per-component V-cycle attribution on one GPU for the 3-D
unstructured Poisson (or block-3 elasticity) hierarchy of BASELINE
configs[2]: times each level's A·x, smoother apply, and P/R transfer as
chained executables on the device, so the V-cycle is attributed to its
actual hot ops instead of guessed at.

Usage (GPU only): python tools/vcycle_breakdown.py [--side 101] [--elasticity]
"""
import argparse
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def jnp_zero():
    import jax.numpy as jnp

    return jnp.zeros((), jnp.float32)


def timed(op, x, reps, trials=3, apply=None):
    """Time ``op.mv`` (or ``apply(op, v)``) as a chained on-device scan,
    ``op`` passed as a jit argument."""
    import jax
    import jax.numpy as jnp

    if apply is None:
        apply = lambda o, v: o.mv(v)

    @jax.jit
    def chain(o, v):
        def body(carry, _):
            u, acc = carry
            # loop-carried data dependence for the shape-changing (P/R)
            # branch: ``bump`` is always 0.0 at runtime but depends on
            # acc (which depends on the previous fn output), so XLA's
            # while-loop invariant code motion cannot hoist the apply out
            # of the scan — without it the per-rep time could read up to
            # ``reps``x too small
            bump = jnp.where(jnp.isnan(acc), 1.0, 0.0).astype(u.dtype)
            u2 = apply(o, u + bump)
            if u2.shape != u.shape:
                # shape-changing op (P/R): keep the input shape fixed and
                # keep the output alive via the scalar accumulator so XLA
                # cannot dead-code-eliminate the op
                return (u, acc + u2.ravel()[0]), None
            return (u2, acc), None

        (u, acc), _ = jax.lax.scan(
            body, (v, jnp_zero()), None, length=reps
        )
        return u.ravel()[0] + acc

    jax.block_until_ready(chain(op, x))
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        jax.block_until_ready(chain(op, x))
        best = min(best, (time.perf_counter() - t0) / reps)
    return best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", type=int, default=101)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--elasticity", action="store_true")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from tpu_amg.utils.platform import require_gpu

    dev = require_gpu()
    print(f"# {dev['card']}", flush=True)
    reps = args.reps

    from tpu_amg.solver import AMGSolver, SolverConfig
    from tpu_amg.utils.problems import (
        unstructured_elasticity_3d,
        unstructured_poisson_3d,
    )

    a = (unstructured_elasticity_3d(args.side) if args.elasticity
         else unstructured_poisson_3d(args.side))
    # BASELINE configs[2] settings; 3-D scalar keeps cf*cd >= ~25
    # (SolverConfig note) so the smoothed-P Galerkin operators stay sparse
    cfg = SolverConfig(
        coarsening_near_null_dim=12 if args.elasticity else 8,
        interp_near_null_dim=6 if args.elasticity else 2,
        coarsening_factor=16.0,
        smoothing_steps=1,
        smoothing_iters=8 if args.elasticity else 10,
        coarsest_dim=1500,
        dtype=jnp.float32,
        dense_threshold=8192,
        sa_trunc_tol=0.05 if args.elasticity else 0.1,
        coarse_drop_tol=0.01,
    )
    t0 = time.perf_counter()
    solver = AMGSolver.setup(a, cfg)
    print(f"# setup {time.perf_counter() - t0:.1f}s", flush=True)
    mg = solver.preconditioner
    from tpu_amg.preconditioners.multigrid import Multigrid

    if not isinstance(mg, Multigrid):
        # adaptive-composite archives: attribute each Multigrid member
        members = getattr(mg, "components", None)
        if members:
            print(f"# composite preconditioner with {len(members)} "
                  f"components; attributing each", flush=True)
        else:
            print(f"# preconditioner {type(mg).__name__} has no levels "
                  "to attribute; only timing the full apply", flush=True)
    steps = getattr(mg, "smoothing_steps", cfg.smoothing_steps)
    total = 0.0
    rows = []
    for i, lvl in enumerate(getattr(mg, "levels", ())):
        n = lvl.a.shape[0]
        x = jnp.ones(n, dtype=jnp.float32)
        t_a = timed(lvl.a, x, reps)
        t_s = timed(lvl.smoother, x, reps)
        t_p = t_r = 0.0
        if lvl.p is not None:
            nc = lvl.p.shape[1]
            xc = jnp.ones(nc, dtype=jnp.float32)
            t_p = timed(lvl.p, xc, reps)
            t_r = timed(lvl.r, x, reps)
        a_l = lvl.a
        inner = getattr(a_l, "ell", a_l)
        fmt = type(inner).__name__
        nnz = getattr(getattr(a_l, "csr", None), "nnz", None)
        rows.append((i, n, t_a, t_s, t_p, t_r))
        # per V-cycle with ``steps`` pre+post smoothing sweeps: each
        # sweep is one M⁻¹ apply plus one residual A·x (Multigrid._smooth
        # computes f − A·v per step), plus the restriction residual —
        # (2·steps + 1) A·x total; the zero-initial-guess pre-smooth's
        # A·0 is assumed NOT dead-code-eliminated (scan carries make it
        # live), which slightly over-counts if XLA drops it
        total += 2 * steps * t_s + (
            (2 * steps + 1) * t_a + t_p + t_r if lvl.p is not None else 0
        )
        print(f"# level {i} n={n} fmt={fmt}: A.mv {t_a*1e3:8.3f}ms  "
              f"smoother {t_s*1e3:8.3f}ms  P {t_p*1e3:8.3f}ms  "
              f"R {t_r*1e3:8.3f}ms", flush=True)
    cs = getattr(mg, "coarse_solver", None)
    if cs is not None:
        n = cs.shape[0]
        t_c = timed(cs, jnp.ones(n, dtype=jnp.float32), reps)
        total += t_c
        print(f"# coarse solve n={n}: {t_c*1e3:.3f}ms", flush=True)
    t_full = timed(mg, jnp.ones(mg.shape[0], dtype=jnp.float32), reps)
    print(f"# sum-of-components estimate {total*1e3:.2f}ms vs full "
          f"V-cycle {t_full*1e3:.2f}ms", flush=True)


if __name__ == "__main__":
    main()
