"""Generate a REAL finite-element fixture for the MFEM-loader pipeline
(data/fem_square_k100/): P1 stiffness assembly of -div(kappa grad u) = 1
on an unstructured Delaunay triangulation of the unit square with a
100:1 checkerboard coefficient jump, Dirichlet boundary, load-vector
rhs, node coordinates, and a legacy-ASCII .vtk triangle mesh.

This is the matrix class the reference's whole harness consumes
(utils.rs:269-350: mtx/bdy/coords/rhs exports of MFEM assemblies;
examples/amg/main.rs:123-140 coefficient datasets) — a genuine FEM
stiffness matrix with coefficient variation, not a graph Laplacian.

Usage: python tools/make_fem_fixture.py [--side 42] [--out data/fem_square_k100]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np


def assemble_p1(pts, tris, kappa_fn):
    """Standard P1 stiffness + load assembly: per element
    Ke = kappa * area * G G^T with G the barycentric basis gradients,
    fe = area/3 per vertex (f = 1)."""
    import scipy.sparse as sps

    n = len(pts)
    rows, cols, vals = [], [], []
    f = np.zeros(n)
    for tri in tris:
        p0, p1, p2 = pts[tri]
        j = np.column_stack([p1 - p0, p2 - p0])
        det = j[0, 0] * j[1, 1] - j[0, 1] * j[1, 0]
        area = abs(det) / 2.0
        if area < 1e-14:
            continue
        jinv = np.array([[j[1, 1], -j[0, 1]], [-j[1, 0], j[0, 0]]]) / det
        # gradients of (1-x-y, x, y) mapped to physical coords
        gref = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])
        g = gref @ jinv
        centroid = (p0 + p1 + p2) / 3.0
        ke = kappa_fn(centroid) * area * (g @ g.T)
        for a in range(3):
            f[tri[a]] += area / 3.0
            for b in range(3):
                rows.append(tri[a])
                cols.append(tri[b])
                vals.append(ke[a, b])
    a = sps.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    a.sum_duplicates()
    return a, f


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", type=int, default=42)
    ap.add_argument("--out", type=str, default="data/fem_square_k100")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    from scipy.spatial import Delaunay

    rng = np.random.default_rng(args.seed)
    s = args.side
    gx, gy = np.meshgrid(np.linspace(0, 1, s), np.linspace(0, 1, s))
    pts = np.stack([gx.ravel(), gy.ravel()], 1)
    interior = (
        (pts[:, 0] > 1e-9) & (pts[:, 0] < 1 - 1e-9)
        & (pts[:, 1] > 1e-9) & (pts[:, 1] < 1 - 1e-9)
    )
    jit = rng.uniform(-0.35, 0.35, pts.shape) / (s - 1)
    pts[interior] += jit[interior]
    tri = Delaunay(pts)

    def kappa(c):
        # 2x2 checkerboard: 100 on the main-diagonal quadrants
        return 100.0 if (c[0] < 0.5) == (c[1] < 0.5) else 1.0

    a, f = assemble_p1(pts, tri.simplices, kappa)
    boundary = np.flatnonzero(~interior)
    print(f"n={a.shape[0]} nnz={a.nnz} boundary={len(boundary)}")

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    name = out.name

    from tpu_amg.sparse.csr import CSR
    from tpu_amg.utils.io import save_mfem_linear_system

    save_mfem_linear_system(
        out, name, CSR.from_scipy(a), f.reshape(-1, 1), pts, boundary
    )
    # legacy-ASCII VTK triangle mesh alongside (find_associated_vtk)
    with open(out / f"{name}.vtk", "w") as fh:
        fh.write("# vtk DataFile Version 3.0\n")
        fh.write(f"{name} P1 mesh\nASCII\nDATASET POLYDATA\n")
        fh.write(f"POINTS {len(pts)} float\n")
        for p in pts:
            fh.write(f"{p[0]:.8f} {p[1]:.8f} 0.0\n")
        cells = tri.simplices
        fh.write(f"POLYGONS {len(cells)} {4 * len(cells)}\n")
        for c in cells:
            fh.write(f"3 {c[0]} {c[1]} {c[2]}\n")
    print(f"wrote {out}/{name}.(mtx|bdy|coords|rhs|vtk)")


if __name__ == "__main__":
    main()
