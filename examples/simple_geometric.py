"""1-D Poisson geometric-multigrid refinement study.

Equivalent of reference examples/simple_geometric.rs:176-301: hand-built
finite-difference matrices, linear-interpolation P (½[1 2 1]) and
full-weighting R (¼[1 2 1]), Jacobi(0.66) smoothing, Cholesky coarsest;
compares PCG+Jacobi vs PCG+MG vs stationary+MG across refinements and
prints the mesh-independence table (the canonical multigrid correctness
oracle, SURVEY.md §4.1).
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import tpu_amg  # noqa: E402,F401  (x64 and the compile cache)

import jax.numpy as jnp

from tpu_amg.linop import aslinearoperator
from tpu_amg.solvers import cg, stationary_iteration


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--min-refine", type=int, default=2)
    p.add_argument("--max-refine", type=int, default=10)
    p.add_argument("--coarse-elements", type=int, default=4)
    p.add_argument("--tol", type=float, default=1e-8)
    args = p.parse_args()

    from tpu_amg.preconditioners import build_smoother
    from tpu_amg.utils.geometric import build_geometric_mg

    rows = []
    for refinements in range(args.min_refine, args.max_refine + 1):
        fine, mg = build_geometric_mg(
            refinements, coarse_elements=args.coarse_elements
        )
        a = aslinearoperator(fine)
        b = jnp.ones(fine.nrows)
        jac = build_smoother("jacobi", a.ell, omega=0.66)
        _, pcg_jac = cg(a, b, jac, rtol=args.tol, maxiter=20000)
        _, pcg_mg = cg(a, b, mg, rtol=args.tol, maxiter=1000)
        _, sli_mg = stationary_iteration(a, b, mg, rtol=args.tol, maxiter=1000)
        rows.append(
            (
                refinements,
                fine.nrows,
                int(pcg_jac.iters),
                int(pcg_mg.iters),
                int(sli_mg.iters),
            )
        )
        print(
            f"refine={refinements:2d} dofs={fine.nrows:6d} "
            f"pcg+jacobi={int(pcg_jac.iters):5d} "
            f"pcg+mg={int(pcg_mg.iters):3d} "
            f"stat+mg={int(sli_mg.iters):3d}"
        )

    print("\nrefinements  dofs  pcg_jacobi  pcg_mg  stationary_mg")
    for r in rows:
        print(f"{r[0]:>10}  {r[1]:>5}  {r[2]:>9}  {r[3]:>6}  {r[4]:>12}")
    mg_iters = [r[3] for r in rows]
    print(
        f"\nmesh independence: pcg+mg iters "
        f"{mg_iters[0]} -> {mg_iters[-1]} over "
        f"{rows[-1][1] / rows[0][1]:.0f}x dof growth"
    )


if __name__ == "__main__":
    main()
