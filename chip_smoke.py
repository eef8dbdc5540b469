"""Smoke test of the AMG main path on the GPU.

Runs ``AMGSolver.setup`` and ``AMGSolver.solve`` — the entry points a
user calls — on systems of the size AMG users solve, and checks every
answer in f64 against scipy on the host:

- phase A: 3-D 7-point Poisson, ``poisson3d(100)`` (1,000,000 dofs), the
  default ``SolverConfig`` (smoothed aggregation, f64), PCG to 1e-8;
- phase B: 3-D unstructured Poisson, ``unstructured_poisson_3d(64)``
  (262,144 dofs), RCM'd, P truncation 0.1, coarse drop 0.01, f32, PCG
  to 1e-5 for b = A x with a seeded random x.

Each phase also checks one SpMV of every device-format operator of the
hierarchy against scipy.  With ``--four`` it runs only the sharded path
on four GPUs: phase A's system and hierarchy row-sharded over a 1-D mesh,
whose PCG must match the single-GPU PCG.

Usage:
    python chip_smoke.py            # one GPU: phases A and B
    python chip_smoke.py --four     # four GPUs: sharded phase A only

It exits non-zero when JAX finds no GPU or any check fails.  The last
line of its output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time

import numpy as np

# f64 SpMV check: storage and accumulation in f64 leave ~1e-15 relative.
F64_SPMV_TOL = 1e-12
# f32 SpMV check: f32 storage and f32 accumulation over tens of terms
# leave ~1e-7 relative; a product run in TF32 would show as ~1e-3.
F32_SPMV_TOL = 1e-5
# residual checks allow 5% over the solver's rtol: PCG stops on its
# recurrence residual, the check recomputes b - A x in f64 from the CSR.
RESIDUAL_SLACK = 1.05


def rel_residual(csr, x, b) -> float:
    a = csr.to_scipy()
    x = np.asarray(x, dtype=np.float64)
    return float(np.linalg.norm(b - a @ x) / np.linalg.norm(b))


def format_name(op) -> str:
    """Device format of an operator: the matrix class behind it."""
    from tpu_amg.linop import SparseOperator, TransposeOperator

    if isinstance(op, TransposeOperator):
        return f"Transpose({format_name(op.base)})"
    if isinstance(op, SparseOperator):
        return type(op.ell).__name__
    return type(op).__name__


def check_spmv(label, op, csr, dtype, card, rng) -> None:
    """One SpMV of a device operator against scipy in f64."""
    import jax.numpy as jnp

    tol = F64_SPMV_TOL if np.dtype(dtype) == np.float64 else F32_SPMV_TOL
    x = rng.standard_normal(csr.ncols)
    y = np.asarray(op.mv(jnp.asarray(x, dtype)), dtype=np.float64)
    ref = csr.to_scipy() @ x
    err = float(np.linalg.norm(y - ref) / np.linalg.norm(ref))
    ok = err <= tol
    print(
        f"  spmv {label} {format_name(op)} {csr.shape}: rel err "
        f"{err:.2e} (tol {tol:.0e}) {'ok' if ok else 'FAIL'} [{card}]",
        flush=True,
    )
    if not ok:
        raise AssertionError(f"{label}: SpMV rel err {err:.2e} > {tol:.0e}")


def print_hierarchy(solver, mats) -> None:
    mg = solver.preconditioner
    print("  level  rows  nnz  A-format  R-format  P-format", flush=True)
    for lvl, (level, (a, _, _)) in enumerate(zip(mg.levels, mats)):
        print(
            f"  {lvl}  {a.nrows}  {a.nnz}  {format_name(level.a)}  "
            f"{format_name(level.r)}  {format_name(level.p)}",
            flush=True,
        )
    c = solver.hierarchy.get_op(solver.hierarchy.num_levels - 1)
    print(
        f"  {len(mg.levels)}  {c.nrows}  {c.nnz}  coarse "
        f"{type(mg.coarse_solver).__name__}",
        flush=True,
    )


def check_hierarchy_spmvs(solver, mats, dtype, card, rng) -> None:
    check_spmv("system", solver.op, solver.matrix, dtype, card, rng)
    for lvl, (level, (a, p, r)) in enumerate(
        zip(solver.preconditioner.levels, mats)
    ):
        check_spmv(f"L{lvl} A", level.a, a, dtype, card, rng)
        check_spmv(f"L{lvl} R", level.r, r, dtype, card, rng)
        check_spmv(f"L{lvl} P", level.p, p, dtype, card, rng)


def time_vcycle(pc, n, dtype, reps: int = 20) -> float:
    """Seconds per V-cycle application, the cycle passed as an argument."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def run(m, r):
        return jax.lax.fori_loop(0, reps, lambda _, v: m.mv(v), r)

    r = jnp.ones((n,), dtype)
    jax.block_until_ready(run(pc, r))
    t0 = time.perf_counter()
    jax.block_until_ready(run(pc, r))
    return (time.perf_counter() - t0) / reps


def solve_and_check(name, solver, a, b, rtol, dtype, card) -> None:
    import jax

    t0 = time.perf_counter()
    x, info = solver.solve(b, rtol=rtol)
    jax.block_until_ready(x)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, info = solver.solve(b, rtol=rtol)
    jax.block_until_ready(x)
    t_solve = time.perf_counter() - t0
    t_cycle = time_vcycle(solver.preconditioner, a.nrows, dtype)
    res = rel_residual(a, x, b)
    print(
        f"{name}: PCG {int(info.iters)} iterations, converged="
        f"{bool(info.converged)}; first solve (with compile) "
        f"{t_first:.2f} s; solve {t_solve * 1e3:.1f} ms; V-cycle "
        f"{t_cycle * 1e3:.3f} ms [{card}]",
        flush=True,
    )
    print(
        f"{name}: relative residual ||b - A x|| / ||b|| = {res:.3e} "
        f"(f64, scipy; limit {rtol * RESIDUAL_SLACK:.3e})",
        flush=True,
    )
    if not bool(info.converged) or res > rtol * RESIDUAL_SLACK:
        raise AssertionError(f"{name}: residual {res:.3e} above {rtol:.0e}")


def setup_timed(name, a, config, card):
    """(solver, host CSRs of its cycle levels) after a timed setup."""
    from tpu_amg.solver import AMGSolver

    t0 = time.perf_counter()
    solver = AMGSolver.setup(a, config)
    t = time.perf_counter() - t0
    print(f"{name}: setup {t:.1f} s (n={a.nrows}, nnz={a.nnz}) [{card}]",
          flush=True)
    mats = solver.level_matrices()
    print_hierarchy(solver, mats)
    return solver, mats


def phase_a(side: int, card: str, seed: int) -> None:
    """3-D 7-point Poisson, default SolverConfig (SA, f64), rtol 1e-8."""
    import jax.numpy as jnp

    from tpu_amg.solver import SolverConfig
    from tpu_amg.utils.problems import poisson3d

    a = poisson3d(side)
    solver, mats = setup_timed("phase A", a, SolverConfig(), card)
    rng = np.random.default_rng(seed)
    check_hierarchy_spmvs(solver, mats, jnp.float64, card, rng)
    b = rng.standard_normal(a.nrows)
    solve_and_check("phase A", solver, a, b, 1e-8, jnp.float64, card)


def phase_b(side: int, card: str, seed: int) -> None:
    """3-D unstructured Poisson, BASELINE configs[2] settings, f32."""
    import jax.numpy as jnp

    from tpu_amg.solver import SolverConfig
    from tpu_amg.utils.problems import unstructured_poisson_3d

    a = unstructured_poisson_3d(side, seed=seed)
    config = SolverConfig(
        reorder=True, sa_trunc_tol=0.1, coarse_drop_tol=0.01,
        dtype=jnp.float32, seed=seed,
    )
    solver, mats = setup_timed("phase B", a, config, card)
    rng = np.random.default_rng(seed)
    check_hierarchy_spmvs(solver, mats, jnp.float32, card, rng)
    # manufactured rhs: the graph Laplacian is singular up to its 1e-8
    # shift, so a random b (with a constant component) has a solution
    # ~1e8 times larger than b, which f32 cannot hold to 1e-5
    b = a.to_scipy() @ rng.standard_normal(a.nrows)
    solve_and_check("phase B", solver, a, b, 1e-5, jnp.float32, card)


def phase_four(side: int, card: str, seed: int) -> None:
    """Phase A's system and hierarchy row-sharded over four GPUs; its
    PCG must match the single-GPU PCG to 1e-10 in equal iterations."""
    import jax
    import jax.numpy as jnp

    from tpu_amg.linop import SparseOperator
    from tpu_amg.parallel import make_solver_mesh, shard_multigrid
    from tpu_amg.parallel.dist import shard_vector, try_shard_halo
    from tpu_amg.solver import SolverConfig
    from tpu_amg.solvers import cg
    from tpu_amg.utils.problems import poisson3d

    n_dev = 4
    if len(jax.devices()) < n_dev:
        raise SystemExit(f"--four needs {n_dev} GPUs, found "
                         f"{len(jax.devices())}")
    a = poisson3d(side)
    rtol = 1e-8
    solver, _ = setup_timed("four", a, SolverConfig(), card)
    rng = np.random.default_rng(seed)
    b_host = rng.standard_normal(a.nrows)

    jax.block_until_ready(solver.solve(b_host, rtol=rtol))  # compile
    t0 = time.perf_counter()
    x1, info1 = solver.solve(b_host, rtol=rtol)
    jax.block_until_ready(x1)
    t_single = time.perf_counter() - t0

    mesh = make_solver_mesh(n_dev)
    with jax.set_mesh(mesh):
        fine = try_shard_halo(solver.op.ell, mesh)
        if fine is None:
            raise AssertionError("fine level has no halo form")
        a_sh = SparseOperator(ell=fine)
        mg_sh = shard_multigrid(solver.preconditioner, mesh)
        b_sh = shard_vector(jnp.asarray(b_host), mesh)
        devices = {d.id for d in fine.data.devices()}
        if devices != {d.id for d in mesh.devices.flat}:
            raise AssertionError(f"fine level sits on devices {devices}")
        rows = sorted(
            (s.device.id, s.data.shape) for s in b_sh.addressable_shards
        )
        print(f"four: {type(fine).__name__} fine level; per-card rows "
              f"{[(d, shape[0]) for d, shape in rows]}", flush=True)
        sharded_levels = sum(
            len(lvl.a.ell.data.devices()) == n_dev
            for lvl in mg_sh.levels
            if isinstance(lvl.a, SparseOperator)
            and hasattr(lvl.a.ell, "mesh")
        )
        print(f"four: {sharded_levels} of {len(mg_sh.levels)} cycle levels "
              f"in halo form over {n_dev} cards", flush=True)

        @jax.jit
        def solve(op, m, b):
            return cg(op, b, m, rtol=rtol, maxiter=500)

        jax.block_until_ready(solve(a_sh, mg_sh, b_sh))
        t0 = time.perf_counter()
        x4, info4 = solve(a_sh, mg_sh, b_sh)
        jax.block_until_ready(x4)
        t_sharded = time.perf_counter() - t0
        x4_devices = {d.id for d in x4.devices()}

    x1 = np.asarray(x1)
    x4 = np.asarray(x4)
    diff = float(np.linalg.norm(x4 - x1) / np.linalg.norm(x1))
    it1, it4 = int(info1.iters), int(info4.iters)
    print(
        f"four: sharded PCG {it4} iterations in {t_sharded * 1e3:.1f} ms "
        f"on cards {sorted(x4_devices)}; single-card PCG {it1} iterations "
        f"in {t_single * 1e3:.1f} ms [{card}]",
        flush=True,
    )
    print(f"four: ||x4 - x1|| / ||x1|| = {diff:.3e} (limit 1e-10); "
          f"residual {rel_residual(a, x4, b_host):.3e}", flush=True)
    if diff > 1e-10 or it1 != it4 or len(x4_devices) != n_dev:
        raise AssertionError("sharded PCG does not match single-card PCG")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="sharded phase A on four GPUs, and nothing else")
    ap.add_argument("--poisson-side", type=int, default=100,
                    help="phase A grid side (side³ dofs)")
    ap.add_argument("--unstructured-side", type=int, default=64,
                    help="phase B grid side (side³ dofs)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_start = time.perf_counter()

    import jax

    from tpu_amg.ops import native
    from tpu_amg.utils.platform import require_gpu

    dev = require_gpu()
    card = dev["card"]
    print(card, flush=True)
    print(f"jax {jax.__version__}; device {dev['kind']} x {dev['count']}",
          flush=True)
    print("native setup kernels: "
          + ("C++ library loaded" if native.available()
             else "not built, numpy fallback"), flush=True)
    log = logging.getLogger("tpu_amg.solver")
    log.setLevel(logging.INFO)
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter("  %(message)s"))
    log.addHandler(handler)

    if args.four:
        phase_four(args.poisson_side, card, args.seed)
    else:
        phase_a(args.poisson_side, card, args.seed)
        phase_b(args.unstructured_side, card, args.seed)
    print(f"chip_smoke wall time {time.perf_counter() - t_start:.1f} s "
          f"[{card}]", flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": dev["platform"], "kind": dev["kind"],
                   "count": dev["count"]},
    }))


if __name__ == "__main__":
    main()
