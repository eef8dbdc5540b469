"""End-to-end solve of a real-FEM fixture through the MFEM loader
(fem_square_k100: P1 stiffness of a 100:1 checkerboard diffusion problem
on an unstructured Delaunay mesh, generated from its seed by
tools/make_fem_fixture.py into a temporary directory).

This is the reference harness's consumption path (utils.rs:269-350:
boundary elimination + index maps; examples/amg/main.rs:236-248) on a
genuine coefficient-jump stiffness matrix rather than a synthetic graph
Laplacian."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

TOOL = Path(__file__).resolve().parent.parent / "tools" / "make_fem_fixture.py"


@pytest.fixture(scope="module")
def system(tmp_path_factory):
    from tpu_amg.utils.io import load_mfem_linear_system

    out = tmp_path_factory.mktemp("fem") / "fem_square_k100"
    subprocess.run(
        [sys.executable, str(TOOL), "--out", str(out), "--seed", "0"],
        check=True,
        capture_output=True,
        timeout=300,
    )
    return load_mfem_linear_system(out, "fem_square_k100")


def test_loader_shapes(system):
    # 42x42 mesh, 164 boundary dofs eliminated
    assert system.original_dimension == 1764
    assert system.matrix.nrows == 1764 - 164
    assert system.rhs.shape[0] == system.matrix.nrows
    assert system.coords.shape == (system.matrix.nrows, 2)
    # the .vtk mesh is found and parsed
    assert system.mesh_geometry is not None
    assert system.mesh_geometry.cells.shape[1] == 3
    assert system.mesh_geometry.points.shape[0] == 1764


def test_stiffness_is_spd_with_jump(system):
    a = system.matrix
    rows, cols, vals = a.coo()
    d = a.diagonal()
    # symmetric
    import scipy.sparse as sps

    sp = sps.coo_matrix((vals, (rows, cols)), shape=(a.nrows, a.nrows))
    assert abs(sp - sp.T).max() < 1e-12
    # the coefficient jump is visible in the diagonal spread
    assert d.max() / d.min() > 20.0


def test_amg_pcg_e2e(system):
    """Full pipeline: loader -> AMGSolver.setup -> PCG to 1e-8; must
    converge mesh-independently fast despite the 100:1 jump."""
    import jax.numpy as jnp

    from tpu_amg.solver import AMGSolver, SolverConfig

    a = system.matrix
    b = jnp.asarray(system.rhs[:, 0])
    solver = AMGSolver.setup(
        a,
        SolverConfig(
            coarsening_near_null_dim=8,
            smoothing_iters=10,
            coarsest_dim=100,
            aggregation_iters=20,
        ),
    )
    x, info = solver.solve(b, rtol=1e-8, maxiter=200)
    assert bool(info.converged)
    assert int(info.iters) < 60
    # true residual against an independent scipy apply
    import scipy.sparse as sps

    rows, cols, vals = a.coo()
    sp = sps.csr_matrix((vals, (rows, cols)), shape=(a.nrows, a.nrows))
    r = np.linalg.norm(sp @ np.asarray(x) - np.asarray(b))
    assert r < 1e-6 * max(np.linalg.norm(np.asarray(b)), 1.0)
