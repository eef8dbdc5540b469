"""Weak-scaling harness: sharded halo-SpMV and PCG across a device mesh.

This harness keeps the per-device row count fixed, grows the mesh
1 → N GPUs, and reports SpMV wall-time and efficiency (t_1 / t_N;
ideal = 1.0 under weak scaling), then the same for the sharded PCG, then
the per-level communication table of the sharded hierarchy.

Usage (GPUs only):  python bench_scaling.py [--trace-dir DIR]
Prints one JSON line per mesh size plus a summary line.
"""

import argparse
import json
import sys
import time

import numpy as np


def main(rows_per_device: int = 65_536, reps: int = 30):
    import jax
    import jax.numpy as jnp

    from tpu_amg.parallel import HaloELL, halo_spmv, make_solver_mesh
    from tpu_amg.parallel.dist import shard_vector
    from tpu_amg.sparse import ELL
    from tpu_amg.utils.problems import poisson2d

    n_devices = len(jax.devices())
    results = []
    t1 = None
    for nd in [d for d in (1, 2, 4, 8, 16) if d <= n_devices]:
        n_total = rows_per_device * nd
        side = int(np.sqrt(n_total))
        # keep rows divisible by the mesh: trim side to multiple of nd
        side -= side % max(nd, 1)
        a = poisson2d(side, side)
        mesh = make_solver_mesh(nd)
        jax.set_mesh(mesh)
        ell = ELL.from_csr(a, dtype=jnp.float32)
        h = HaloELL.from_ell(ell, mesh)
        x = shard_vector(jnp.ones(a.nrows, dtype=jnp.float32), mesh)

        @jax.jit
        def spmv_n(h_, v):
            def body(u, _):
                return halo_spmv(h_, u), None

            u, _ = jax.lax.scan(body, v, None, length=reps)
            return u

        jax.block_until_ready(spmv_n(h, x))
        t0 = time.perf_counter()
        jax.block_until_ready(spmv_n(h, x))
        dt = (time.perf_counter() - t0) / reps
        if t1 is None:
            t1 = dt
        eff = t1 / dt
        results.append((nd, dt, eff))
        print(
            json.dumps(
                {
                    "metric": f"halo_spmv_weak_scaling_{nd}dev",
                    "value": round(dt * 1e3, 4),
                    "unit": "ms",
                    "vs_baseline": round(eff / 0.8, 4),
                }
            ),
            flush=True,
        )
    print(
        f"# weak scaling: {[(nd, f'{dt*1e3:.2f}ms', f'{eff:.2f}') for nd, dt, eff in results]}",
        file=sys.stderr,
    )
    solver_weak_scaling()


def solver_weak_scaling(iters: int = 40):
    """Weak scaling of the PRODUCTION sharded solve: PCG preconditioned
    by the halo-sharded V-cycle (the path shard_multigrid builds and
    dryrun_multichip certifies), fixed work per device (rtol=0 forces
    exactly ``iters`` iterations so times are comparable across mesh
    sizes)."""
    import jax
    import jax.numpy as jnp

    from tpu_amg.hierarchy import HierarchyConfig, create_weights
    from tpu_amg.interpolation import AggregationConfig, InterpolationConfig
    from tpu_amg.linop import SparseOperator
    from tpu_amg.parallel import (
        make_solver_mesh,
        shard_multigrid,
        shard_operator,
    )
    from tpu_amg.parallel.dist import shard_vector
    from tpu_amg.partition import PartitionerConfig
    from tpu_amg.preconditioners.multigrid_builder import MultigridConfig
    from tpu_amg.solvers import cg
    from tpu_amg.utils.problems import poisson2d

    n_avail = len(jax.devices())
    sides = {1: 96, 2: 136, 4: 192, 8: 272}  # ~9.2k rows per device
    results = []
    for nd in [d for d in (1, 2, 4, 8) if d <= n_avail]:
        side = sides[nd]
        a = poisson2d(side)
        nn = np.ones((a.nrows, 1))
        hier = HierarchyConfig(
            coarsest_dim=256,
            max_levels=4,
            interpolation_config=InterpolationConfig(
                kind="aggregation",
                aggregation=AggregationConfig(
                    candidate_dimension=1,
                    partitioner_config=PartitionerConfig(
                        coarsening_factor=8.0, max_improvement_iters=5
                    ),
                ),
            ),
        ).build(a, nn, create_weights(a, nn))
        mg = MultigridConfig(smoothing_steps=1, prefer_dia=True).build(hier)
        mesh = make_solver_mesh(nd)
        jax.set_mesh(mesh)
        sop = shard_operator(
            SparseOperator.from_csr(a, dtype=jnp.float64), mesh
        )
        mg_sh = shard_multigrid(mg, mesh, replicate_below=4096)
        b = shard_vector(jnp.ones(a.nrows), mesh)

        solve = jax.jit(
            lambda a_, b_, m_: cg(a_, b_, m_, rtol=0.0, maxiter=iters)
        )
        jax.block_until_ready(solve(sop, b, mg_sh))  # compile
        t0 = time.perf_counter()
        x, info = solve(sop, b, mg_sh)
        jax.block_until_ready(x)
        dt = (time.perf_counter() - t0) / iters
        results.append((nd, a.nrows, dt))
        eff = results[0][2] / dt
        print(
            json.dumps(
                {
                    "metric": f"solver_weak_scaling_{nd}dev",
                    "value": round(dt * 1e3, 3),
                    "unit": "ms/iteration",
                    "n": a.nrows,
                    "vs_baseline": round(eff / 0.8, 4),
                }
            ),
            flush=True,
        )
    print(
        f"# solver weak scaling: "
        f"{[(nd, n, f'{dt*1e3:.2f}ms') for nd, n, dt in results]}",
        file=sys.stderr,
    )


def comm_accounting(mg_sh, mesh, n_fine, axis="x"):
    """Static per-level communication table for a sharded multigrid: the
    bytes each SpMV moves between devices (ring halo slabs) vs the bytes
    an all-gather fallback would move.  Every term is exact from the
    sharded operators' static metadata, not modeled."""
    import jax.numpy as jnp

    from tpu_amg.parallel.halo import HaloDIA, HaloELL

    nd = mesh.shape[axis]
    rows = []
    for i, lvl in enumerate(getattr(mg_sh, "levels", ())):
        a = getattr(lvl.a, "ell", lvl.a)
        n = a.shape[0]
        itemsize = jnp.dtype(getattr(a, "dtype", jnp.float32)).itemsize
        if isinstance(a, (HaloELL, HaloDIA)):
            halo_b = 2 * a.halo * itemsize  # two ring slabs per device
            allg_b = (nd - 1) * (n // nd) * itemsize
            rows.append({
                "level": i, "n": n, "fmt": type(a).__name__,
                "halo": int(a.halo),
                "halo_bytes_per_spmv_per_dev": int(halo_b),
                "allgather_bytes_per_spmv_per_dev": int(allg_b),
                "comm_reduction": round(allg_b / max(halo_b, 1), 1),
            })
        else:
            rows.append({
                "level": i, "n": n, "fmt": type(a).__name__,
                "replicated": True,
            })
    return rows


def comm_table(trace_dir=None, iters: int = 3):
    """Build the dry-run production hierarchy sharded over the full
    mesh and print its per-level comm table; with ``trace_dir``, also
    write a profiler trace of one sharded solve for collective-time
    inspection."""
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as ge
    from tpu_amg.linop import SparseOperator
    from tpu_amg.parallel import make_solver_mesh, pad_ell_identity, shard_multigrid
    from tpu_amg.parallel.dist import shard_vector, try_shard_halo
    from tpu_amg.solvers import cg

    nd = len(jax.devices())
    a, op, mg = ge._build_deep_amg(nd)
    mesh = make_solver_mesh(nd)
    jax.set_mesh(mesh)
    ell = pad_ell_identity(op.ell, nd)
    halo = try_shard_halo(ell, mesh)
    a_sh = SparseOperator(ell=halo)
    mg_sh = shard_multigrid(mg, mesh, replicate_below=600)
    table = comm_accounting(mg_sh, mesh, a.nrows)
    # the fine-level operator itself (outside mg levels)
    fine = comm_accounting(
        type("L", (), {"levels": [type("V", (), {"a": a_sh})()]})(),
        mesh, a.nrows,
    )
    for row in fine:
        row["level"] = "fine(A)"
        print(json.dumps({"metric": "comm_accounting", **row}), flush=True)
    for row in table:
        print(json.dumps({"metric": "comm_accounting", **row}), flush=True)

    b = shard_vector(jnp.ones(ell.nrows, dtype=jnp.float32), mesh)
    solve = jax.jit(lambda a_, b_, m_: cg(a_, b_, m_, rtol=0.0,
                                          maxiter=iters)[0])
    jax.block_until_ready(solve(a_sh, b, mg_sh))  # compile
    if trace_dir:
        with jax.profiler.trace(trace_dir):
            jax.block_until_ready(solve(a_sh, b, mg_sh))
        print(f"# profiler trace written to {trace_dir} (collective time "
              "share: inspect ppermute/all-gather ops)", file=sys.stderr)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace-dir", default=None,
                    help="write a profiler trace of one sharded solve here")
    args = ap.parse_args()
    from tpu_amg.utils.platform import require_gpu

    dev = require_gpu()
    print(f"# {dev['card']} x {dev['count']}", file=sys.stderr, flush=True)
    main()
    comm_table(args.trace_dir)
