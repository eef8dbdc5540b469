"""End-to-end AMG CLI driver.

Equivalent of the reference's main driver (reference examples/amg/main.rs):
load or generate an SPD system, bootstrap a near-null basis, build the
hierarchy + multigrid (or the full adaptive composite), solve with PCG and
stationary iteration, and print the machine-readable final line

    cg_iters sli_iters a_norm_of_e op_complexity

(reference examples/amg/main.rs:471-474).

Problems: either an MFEM dump directory (--data-dir/--name, same file
formats as the reference) or generated anisotropic-diffusion / Poisson /
elasticity systems (the reference's coefficient datasets are MFEM dumps
of the same problem family, main.rs:123-140).
"""

import argparse
import logging
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import numpy as np

import tpu_amg  # noqa: E402,F401  (x64 and the compile cache)


def parse_args():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-dir", type=str, default=None,
                   help="MFEM system directory (expects <name>.{mtx,bdy,coords,rhs})")
    p.add_argument("--name", type=str, default="system")
    p.add_argument("--problem", type=str, default="aniso2d",
                   choices=["poisson2d", "poisson3d", "aniso2d", "elasticity3d"])
    p.add_argument("--n", type=int, default=64, help="grid points per dim")
    p.add_argument("--epsilon", type=float, default=1e-3)
    p.add_argument("--theta", type=float, default=np.pi / 6)
    p.add_argument("--coefficient", type=str, default="constant")
    p.add_argument("--block-size", type=int, default=1)
    p.add_argument("--coarsening-near-null-dim", type=int, default=64)
    p.add_argument("--interp-near-null-dim", type=int, default=4,
                   help="SA candidate dimension")
    p.add_argument("--smoothing-iters", type=int, default=20)
    p.add_argument("--interpolation", type=str, default="sa",
                   choices=["sa", "classical"])
    p.add_argument("--classical-opts", type=str, default="",
                   help="key=val,... overrides: tau=, search=, depth=, "
                        "max=, cr_target=, relax= "
                        "(reference examples/amg/main.rs:502-547)")
    p.add_argument("--coarsening-factor", type=float, default=8.0)
    p.add_argument("--sa-filter", type=float, default=None,
                   help="filtered-SA P smoothing threshold theta "
                        "(drops |a_ij| < theta*sqrt(a_ii*a_jj) during "
                        "prolongation smoothing; good for high contrast)")
    p.add_argument("--sa-trunc", type=float, default=None,
                   help="P truncation tolerance (drop |p_ij| < "
                        "tol*rowmax after smoothing, rescale survivors; "
                        "the 3-D fill control)")
    p.add_argument("--aggregation-iters", type=int, default=200,
                   help="partitioner improvement iterations")
    p.add_argument("--max-iters", type=int, default=1000)
    p.add_argument("--tol", type=float, default=1e-12)
    p.add_argument("--block-smoother-size", type=float, default=128.0)
    p.add_argument("--coarsest-dim", type=int, default=1000)
    p.add_argument("--max-levels", type=int, default=None)
    p.add_argument("--smoothing-steps", type=int, default=3)
    p.add_argument("--smoother", type=str, default="block",
                   choices=["block", "chebyshev", "l1", "l2", "jacobi"])
    p.add_argument("--chebyshev-degree", type=int, default=3)
    p.add_argument("--mu", type=int, default=None,
               help="cycle index (default: auto — 1 for SA, 2 for classical)")
    p.add_argument("--composite", type=int, default=None,
                   help="adaptive composite with N components")
    p.add_argument("--structured", action="store_true",
                   help="gather-free structured-grid multigrid (tensor-"
                        "grid problems only)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--viz-out", type=str, default=None,
                   help="write hierarchy viz JSON here (reference dumps "
                        "data/hierarchy_viz.json, main.rs:384-387)")
    p.add_argument("--skip-sli", action="store_true",
                   help="skip the stationary-iteration solve (prints -1)")
    p.add_argument("--skip-enorm", action="store_true",
                   help="skip the ||E||_A power estimate (prints nan)")
    p.add_argument("--precision", type=str, default=None,
                   choices=["bf16", "bf16_values", "f32"],
                   help="mixed-precision preconditioner cycle "
                        "(precision.py); outer PCG stays f64")
    p.add_argument("-v", "--verbose", action="store_true")
    return p.parse_args()


def load_problem(args):
    from tpu_amg.utils import problems
    from tpu_amg.utils.io import load_mfem_linear_system

    if args.data_dir:
        sys_ = load_mfem_linear_system(args.data_dir, args.name)
        a = sys_.matrix.with_block_size(args.block_size)
        rhs = sys_.rhs[:, 0] if sys_.rhs.size else np.ones(a.nrows)
        return a, rhs
    n = args.n
    if args.problem == "poisson2d":
        a = problems.poisson2d(n)
    elif args.problem == "poisson3d":
        a = problems.poisson3d(n)
    elif args.problem == "aniso2d":
        a = problems.anisotropic_diffusion_2d(
            n, epsilon=args.epsilon, theta=args.theta,
            coefficient=args.coefficient,
        )
    elif args.problem == "elasticity3d":
        a = problems.elasticity_3d(n)
    rhs = np.ones(a.nrows)
    return a, rhs


def test_composite(composite, rhs, x0, max_iters, tol):
    """Peel composite components one by one, re-solving each time, and
    format the PCG/stationary results tables
    (reference test_composite + build_composite_table,
    examples/amg/main.rs:589-702)."""
    import numpy as np

    from tpu_amg.utils.testing import test_solver

    def row(count, iters, rel_res):
        vcycles_per_iter = 2 * count - 1
        total = iters * vcycles_per_iter
        red_it = rel_res ** (1.0 / iters) if iters else 0.0
        red_vc = rel_res ** (1.0 / total) if total else 0.0
        return (count, iters, total, red_it, red_vc, rel_res)

    pcg_rows, sli_rows = [], []
    while len(composite.components) > 0:
        count = len(composite.components)
        report = test_solver(
            composite.a, composite, rhs, x0, rtol=tol, maxiter=max_iters
        )
        b_norm = float(np.linalg.norm(np.asarray(rhs)))
        pcg_rows.append(
            row(count, report.cg_iters, report.cg_history[-1] / b_norm)
        )
        sli_rows.append(
            row(count, report.sli_iters, report.sli_history[-1] / b_norm)
        )
        import dataclasses

        composite = dataclasses.replace(
            composite, components=composite.components[:-1]
        )

    def table(rows):
        sep = (
            "+------------+------------+------------+----------------------+"
            "----------------------+----------------------+"
        )
        lines = [
            sep,
            "| components | iterations | v-cycles   | reduction/iter       |"
            " reduction/v-cycle    | final rel residual   |",
            sep,
        ]
        for r in rows:
            lines.append(
                f"| {r[0]:>10} | {r[1]:>10} | {r[2]:>10} | {r[3]:>20.3f} |"
                f" {r[4]:>20.3f} | {r[5]:>20.3e} |"
            )
        lines.append(sep)
        return "\n".join(lines)

    return (
        f"Composite PCG results:\n{table(pcg_rows)}\n"
        f"Composite stationary results:\n{table(sli_rows)}"
    )


def main():
    args = parse_args()
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(levelname)s %(name)s: %(message)s",
    )
    import jax.numpy as jnp

    from tpu_amg.adaptivity import AdaptiveConfig, find_near_null
    from tpu_amg.hierarchy import HierarchyConfig, create_weights
    from tpu_amg.interpolation import AggregationConfig, InterpolationConfig
    from tpu_amg.linop import aslinearoperator
    from tpu_amg.partition import PartitionerConfig
    from tpu_amg.preconditioners.multigrid_builder import MultigridConfig
    from tpu_amg.utils.testing import approx_convergence_factor, test_solver

    a, rhs = load_problem(args)
    print(f"system: n={a.nrows} nnz={a.nnz} block_size={a.block_size}",
          file=sys.stderr)
    key = jax.random.PRNGKey(args.seed)
    t_setup = time.time()

    from tpu_amg.interpolation.classical import (
        ClassicalConfig,
        CompatibleRelaxationConfig,
        LeastSquaresConfig,
    )

    ls_cfg, cr_cfg = LeastSquaresConfig(), CompatibleRelaxationConfig()
    if args.classical_opts:
        # mini key=val parser (reference examples/amg/main.rs:502-547)
        for kv in args.classical_opts.split(","):
            k, v = kv.split("=")
            if k == "tau":
                ls_cfg.tau_threshold = float(v)
            elif k == "search":
                ls_cfg.search_depth = int(v)
            elif k == "depth":
                ls_cfg.depth_ls = int(v)
            elif k == "max":
                ls_cfg.max_interp = int(v)
            elif k == "cands":
                ls_cfg.max_candidates = int(v)
            elif k == "cr_target":
                cr_cfg.target_convergence = float(v)
            elif k == "relax":
                cr_cfg.relax_steps = int(v)
            else:
                raise SystemExit(f"unknown classical opt {k!r}")

    interp = InterpolationConfig(
        kind="aggregation" if args.interpolation == "sa" else "classical",
        aggregation=AggregationConfig(
            candidate_dimension=args.interp_near_null_dim,
            filter_theta=args.sa_filter,
            trunc_tol=args.sa_trunc,
            partitioner_config=PartitionerConfig(
                coarsening_factor=args.coarsening_factor,
                max_improvement_iters=args.aggregation_iters,
            ),
        ),
        classical=ClassicalConfig(cr_options=cr_cfg, ls_options=ls_cfg),
    )
    hier_cfg = HierarchyConfig(
        coarsest_dim=args.coarsest_dim,
        interpolation_config=interp,
        max_levels=args.max_levels,
    )
    mg_cfg = MultigridConfig(
        mu=args.mu,
        smoothing_steps=args.smoothing_steps,
        smoother=args.smoother,
        chebyshev_degree=args.chebyshev_degree,
        smoother_partitioner=PartitionerConfig(
            coarsening_factor=args.block_smoother_size,
            max_improvement_iters=50,
        ),
    )
    op = aslinearoperator(a)

    if args.structured:
        from tpu_amg.structured import build_structured_multigrid

        if args.problem in ("poisson2d", "aniso2d"):
            grid = (args.n, args.n)
        elif args.problem == "poisson3d":
            grid = (args.n,) * 3
        else:
            raise SystemExit("--structured requires a tensor-grid problem")
        t0 = time.time()
        pc = build_structured_multigrid(
            a, grid, coarsest_dim=args.coarsest_dim, dtype=jnp.float64
        )
        op_complexity = float("nan")
        print(f"structured setup: {time.time() - t0:.1f}s", file=sys.stderr)
    elif args.composite:
        cfg = AdaptiveConfig(
            hierarchy_config=hier_cfg,
            multigrid_config=mg_cfg,
            max_components=args.composite,
            test_iters=args.smoothing_iters,
            coarsening_near_null_dim=args.coarsening_near_null_dim,
        )
        pc = cfg.build(a, key)
        # component-peel study + results table
        # (reference examples/amg/main.rs:589-675)
        k_guess, key = jax.random.split(key)
        x0 = jax.random.normal(k_guess, (a.nrows,), dtype=jnp.float64)
        print(
            test_composite(
                pc, jnp.asarray(rhs), x0, args.max_iters, args.tol
            )
        )
        op_complexity = float("nan")  # per-component hierarchies
    else:
        k_nn, key = jax.random.split(key)
        nn = find_near_null(
            a, args.smoothing_iters, args.coarsening_near_null_dim - 1,
            args.block_smoother_size, k_nn,
        )
        basis, _ = np.linalg.qr(
            np.concatenate([np.ones((a.nrows, 1)), nn], axis=1)
        )
        weights = create_weights(a, basis)
        hierarchy = hier_cfg.build(a, basis, weights)
        print(repr(hierarchy), file=sys.stderr)
        if args.viz_out:
            from tpu_amg.utils.viz import dump_hierarchy_viz

            dump_hierarchy_viz(hierarchy, args.viz_out)
        pc = mg_cfg.build(hierarchy)
        op_complexity = hierarchy.op_complexity()
    if args.precision:
        from tpu_amg.precision import cast_preconditioner

        pc = cast_preconditioner(pc, args.precision)
    print(f"setup: {time.time() - t_setup:.1f}s", file=sys.stderr)

    t_solve = time.time()
    k_guess, key = jax.random.split(key)
    x0 = jax.random.normal(k_guess, (a.nrows,), dtype=jnp.float64)
    report = test_solver(
        op, pc, jnp.asarray(rhs), x0, rtol=args.tol, maxiter=args.max_iters,
        run_sli=not args.skip_sli,
    )
    print(
        f"solve: {time.time() - t_solve:.1f}s  cg_converged={report.cg_converged} "
        f"sli_converged={report.sli_converged}",
        file=sys.stderr,
    )
    a_norm_e = (float("nan") if args.skip_enorm
                else approx_convergence_factor(op, pc, key))
    # machine-readable final line (reference examples/amg/main.rs:471-474)
    print(f"{report.cg_iters} {report.sli_iters} {a_norm_e:.6f} "
          f"{op_complexity:.6f}")


if __name__ == "__main__":
    main()
