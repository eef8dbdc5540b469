"""Model-problem generators.

The reference's test surface is built from (a) a hand-assembled 1-D
Poisson finite-difference system with geometric transfer operators
(reference examples/simple_geometric.rs:62-113) and (b) 2-D
anisotropic-diffusion FEM systems loaded from MFEM dumps
(examples/amg/main.rs:123-140).  We generate the equivalents directly:
structured Poisson in 1/2/3-D, anisotropic diffusion with rotating
coefficient fields, and 3-D linear elasticity (block_size 3) for the
block-smoother path.
"""

from __future__ import annotations

import numpy as np

from tpu_amg.sparse.csr import CSR


def poisson1d(n_elements: int) -> CSR:
    """Interior-point FD discretization of -u'' on [0,1], homogeneous
    Dirichlet (reference simple_geometric.rs:96-113): n_elements-1 dofs,
    tridiag(-1, 2, -1)/h²."""
    h = 1.0 / n_elements
    n = n_elements - 1
    main = np.full(n, 2.0 / h**2)
    off = np.full(n - 1, -1.0 / h**2)
    rows = np.concatenate([np.arange(n), np.arange(n - 1), np.arange(1, n)])
    cols = np.concatenate([np.arange(n), np.arange(1, n), np.arange(n - 1)])
    vals = np.concatenate([main, off, off])
    return CSR.from_coo(rows, cols, vals, (n, n))


def _grid_idx(shape):
    return np.arange(int(np.prod(shape))).reshape(shape)


def poisson2d(nx: int, ny: int = None) -> CSR:
    """5-point Laplacian on an nx×ny interior grid, Dirichlet, h=1."""
    ny = ny or nx
    idx = _grid_idx((nx, ny))
    rows, cols, vals = [], [], []
    n = nx * ny
    rows.append(idx.ravel())
    cols.append(idx.ravel())
    vals.append(np.full(n, 4.0))
    for axis, count in ((0, nx), (1, ny)):
        lo = idx.take(np.arange(count - 1), axis=axis).ravel()
        hi = idx.take(np.arange(1, count), axis=axis).ravel()
        rows.extend([lo, hi])
        cols.extend([hi, lo])
        vals.extend([np.full(lo.size, -1.0)] * 2)
    return CSR.from_coo(
        np.concatenate(rows), np.concatenate(cols), np.concatenate(vals), (n, n)
    )


def poisson3d(nx: int, ny: int = None, nz: int = None) -> CSR:
    """7-point Laplacian on an interior grid, Dirichlet, h=1."""
    ny = ny or nx
    nz = nz or nx
    idx = _grid_idx((nx, ny, nz))
    n = nx * ny * nz
    rows, cols, vals = [idx.ravel()], [idx.ravel()], [np.full(n, 6.0)]
    for axis, count in ((0, nx), (1, ny), (2, nz)):
        lo = idx.take(np.arange(count - 1), axis=axis).ravel()
        hi = idx.take(np.arange(1, count), axis=axis).ravel()
        rows.extend([lo, hi])
        cols.extend([hi, lo])
        vals.extend([np.full(lo.size, -1.0)] * 2)
    return CSR.from_coo(
        np.concatenate(rows), np.concatenate(cols), np.concatenate(vals), (n, n)
    )


def anisotropic_diffusion_2d(
    nx: int,
    ny: int = None,
    epsilon: float = 1e-3,
    theta: float = 0.0,
    coefficient: str = "constant",
    seed: int = 0,
) -> CSR:
    """Rotated anisotropic diffusion −∇·(K∇u) on a structured grid, FEM
    (bilinear quad) stencil.

    K = Rᵀ diag(1, ε) R with rotation θ; ``coefficient`` modulates the
    scalar magnitude over space, mimicking the reference's coefficient
    datasets (examples/amg/main.rs:123-140, 479-500): "constant",
    "random" (log-uniform per cell), "layers" (horizontal bands),
    "checkerboard".
    """
    ny = ny or nx
    rng = np.random.default_rng(seed)
    c, s = np.cos(theta), np.sin(theta)
    # diffusion tensor entries
    kxx = c * c + epsilon * s * s
    kyy = s * s + epsilon * c * c
    kxy = (1.0 - epsilon) * c * s

    # per-cell scalar coefficient on an (nx+1)×(ny+1) cell grid
    cx, cy = nx + 1, ny + 1
    if coefficient == "constant":
        coef = np.ones((cx, cy))
    elif coefficient == "random":
        coef = 10.0 ** rng.uniform(-3, 3, size=(cx, cy))
    elif coefficient == "layers":
        bands = (np.arange(cx) // max(cx // 8, 1)) % 2
        coef = np.where(bands, 1e3, 1.0)[:, None] * np.ones((1, cy))
    elif coefficient == "checkerboard":
        ix, iy = np.meshgrid(np.arange(cx), np.arange(cy), indexing="ij")
        coef = np.where((ix // 4 + iy // 4) % 2 == 0, 1.0, 1e3)
    else:
        raise ValueError(f"unknown coefficient field {coefficient!r}")

    # Q1 FEM element stiffness for anisotropic K on a unit square cell
    # (exact integration of bilinear basis gradients)
    gp = np.array([-1.0, 1.0]) / np.sqrt(3.0)
    nodes_local = [(0, 0), (1, 0), (1, 1), (0, 1)]
    ke = np.zeros((4, 4))
    K = np.array([[kxx, kxy], [kxy, kyy]])
    for gx in gp:
        for gy in gp:
            # shape function gradients on [-1,1]^2 mapped to unit cell
            dn = []
            for (a, b) in nodes_local:
                sa, sb = 2 * a - 1, 2 * b - 1
                dn.append(
                    [
                        0.25 * sa * (1 + sb * gy) * 2.0,
                        0.25 * sb * (1 + sa * gx) * 2.0,
                    ]
                )
            dn = np.array(dn)  # (4, 2)
            ke += 0.25 * dn @ K @ dn.T
    # assemble over cells; interior dofs only (Dirichlet boundary removed)
    node_idx = -np.ones((cx + 1, cy + 1), dtype=np.int64)
    node_idx[1:-1, 1:-1] = np.arange(nx * ny).reshape(nx, ny)
    rows, cols, vals = [], [], []
    cell_x, cell_y = np.meshgrid(np.arange(cx), np.arange(cy), indexing="ij")
    cell_x, cell_y = cell_x.ravel(), cell_y.ravel()
    cell_coef = coef[cell_x, cell_y]
    corner = [
        node_idx[cell_x, cell_y],
        node_idx[cell_x + 1, cell_y],
        node_idx[cell_x + 1, cell_y + 1],
        node_idx[cell_x, cell_y + 1],
    ]
    for a in range(4):
        for b in range(4):
            ia, ib = corner[a], corner[b]
            ok = (ia >= 0) & (ib >= 0)
            rows.append(ia[ok])
            cols.append(ib[ok])
            vals.append(cell_coef[ok] * ke[a, b])
    return CSR.from_coo(
        np.concatenate(rows),
        np.concatenate(cols),
        np.concatenate(vals),
        (nx * ny, nx * ny),
    )


def unstructured_poisson_2d(
    side: int, seed: int = 0, jitter: float = 0.35, rcm: bool = True,
    diag_shift: float = 1e-8,
) -> CSR:
    """Pseudo-unstructured 2-D FEM-graph Laplacian: jittered side² grid
    points, randomly renumbered, Delaunay-triangulated, then
    RCM-reordered — the matrix class the reference's MFEM loader serves
    (reference utils.rs:269-350) and the hard case for a gather SpMV."""
    import scipy.sparse as sps
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    n_pts = side * side
    gx, gy = np.meshgrid(np.arange(side, dtype=np.float64),
                         np.arange(side, dtype=np.float64))
    pts = np.stack([gx.ravel(), gy.ravel()], 1)
    pts += rng.uniform(-jitter, jitter, pts.shape)
    tri = Delaunay(pts[rng.permutation(n_pts)])
    e = np.concatenate([tri.simplices[:, [0, 1]],
                        tri.simplices[:, [1, 2]],
                        tri.simplices[:, [2, 0]]])
    i = np.concatenate([e[:, 0], e[:, 1]])
    j = np.concatenate([e[:, 1], e[:, 0]])
    a = sps.coo_matrix((np.ones(len(i)), (i, j)),
                       shape=(n_pts, n_pts)).tocsr()
    a.sum_duplicates()
    a.data[:] = -1.0
    a = (
        a + sps.diags(np.asarray(-a.sum(axis=1)).ravel() + diag_shift)
    ).tocsr()
    if rcm:
        p = reverse_cuthill_mckee(a, symmetric_mode=True)
        a = a[p][:, p].tocsr()
    a.sort_indices()
    return CSR.from_scipy(a)


def unstructured_poisson_3d(
    side: int, seed: int = 0, jitter: float = 0.3, rcm: bool = True,
    return_coords: bool = False,
):
    """Pseudo-unstructured 3-D FEM-graph Laplacian: jittered side³ grid
    points, randomly renumbered, Delaunay-tetrahedralized, graph
    Laplacian over tet edges, then RCM-reordered.

    This is BASELINE.json configs[2] ("~1M-dof 3-D unstructured
    Poisson") — the matrix class the reference's MFEM loader serves
    (reference utils.rs:269-350) with genuinely 3-D band statistics
    (RCM bandwidth ~ n^(2/3), ~15 nnz/row vs ~7 in 2-D).
    """
    import scipy.sparse as sps
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    n_pts = side**3
    gx, gy, gz = np.meshgrid(*(np.arange(side, dtype=np.float64),) * 3)
    pts = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], 1)
    pts += rng.uniform(-jitter, jitter, pts.shape)
    perm = rng.permutation(n_pts)
    tri = Delaunay(pts[perm])
    s = tri.simplices
    e = np.concatenate([
        s[:, [0, 1]], s[:, [0, 2]], s[:, [0, 3]],
        s[:, [1, 2]], s[:, [1, 3]], s[:, [2, 3]],
    ])
    i = np.concatenate([e[:, 0], e[:, 1]])
    j = np.concatenate([e[:, 1], e[:, 0]])
    a = sps.coo_matrix(
        (np.ones(len(i)), (i, j)), shape=(n_pts, n_pts)
    ).tocsr()
    a.sum_duplicates()
    a.data[:] = -1.0
    a = (a + sps.diags(np.asarray(-a.sum(axis=1)).ravel() + 1e-8)).tocsr()
    coords = pts[perm]
    if rcm:
        p = reverse_cuthill_mckee(a, symmetric_mode=True)
        a = a[p][:, p].tocsr()
        coords = coords[p]
    a.sort_indices()
    csr = CSR.from_scipy(a)
    if return_coords:
        return csr, coords
    return csr


def unstructured_elasticity_3d(
    side: int, seed: int = 0, jitter: float = 0.3, k_reg: float = 0.3,
    diag_shift: float = 1e-8, rcm: bool = True, pin_face: bool = True,
) -> CSR:
    """Unstructured 3-D vector elasticity: truss (lattice-spring)
    stiffness on a jittered-grid Delaunay tet mesh, 3 dofs per node
    (``block_size = 3``).

    Each edge (i, j) with unit direction n contributes the SPD 3×3
    block K = n nᵀ + k_reg·I to the four block positions of a standard
    stiffness assembly — the classic truss/spring elasticity model,
    whose near-null space is the rigid translations (+ approximate
    rotations), i.e. exactly the vector-dof matrix class the reference
    targets (core.rs:22-36, block_smoothers.rs:326-399) on an
    UNSTRUCTURED mesh.  Ordering is block-RCM: RCM on the node graph,
    dofs grouped node-major so 3-dof blocks stay contiguous.
    """
    import scipy.sparse as sps
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    n_pts = side**3
    gx, gy, gz = np.meshgrid(*(np.arange(side, dtype=np.float64),) * 3)
    pts = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], 1)
    pts += rng.uniform(-jitter, jitter, pts.shape)
    perm0 = rng.permutation(n_pts)
    pts = pts[perm0]
    tri = Delaunay(pts)
    s = tri.simplices
    e = np.concatenate([
        s[:, [0, 1]], s[:, [0, 2]], s[:, [0, 3]],
        s[:, [1, 2]], s[:, [1, 3]], s[:, [2, 3]],
    ])
    e.sort(axis=1)
    key = e[:, 0].astype(np.int64) * n_pts + e[:, 1]
    order = np.argsort(key)
    sk = key[order]
    first = np.concatenate([[True], sk[1:] != sk[:-1]])
    e = e[order[first]]
    i, j = e[:, 0], e[:, 1]

    d = pts[j] - pts[i]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    k_blk = d[:, :, None] * d[:, None, :] + k_reg * np.eye(3)  # (E,3,3)

    # block COO: (i,i)+K (j,j)+K (i,j)-K (j,i)-K, expanded to scalars
    br = np.concatenate([i, j, i, j])
    bc = np.concatenate([i, j, j, i])
    bv = np.concatenate([k_blk, k_blk, -k_blk, -k_blk])
    a3 = np.arange(3)
    rows = (3 * br[:, None, None] + a3[None, :, None]).repeat(3, axis=2)
    cols = (3 * bc[:, None, None] + a3[None, None, :]).repeat(3, axis=1)
    a = sps.coo_matrix(
        (bv.ravel(), (rows.ravel(), cols.ravel())),
        shape=(3 * n_pts, 3 * n_pts),
    ).tocsr()
    a = a + sps.eye(3 * n_pts) * diag_shift
    if pin_face:
        # ground springs on the z~0 face (the Dirichlet analog): a
        # free-floating truss has 6 rigid near-null modes at the
        # diag_shift scale, which makes the coarsest-level factorization
        # meaningless in f32
        pinned = np.flatnonzero(pts[:, 2] < 0.6)
        dof = (3 * pinned[:, None] + a3[None, :]).ravel()
        lift = np.zeros(3 * n_pts)
        lift[dof] = 1.0
        a = a + sps.diags(lift)
    if rcm:
        # block-RCM: permute NODES (via the node adjacency), keep the
        # 3 dofs of each node contiguous
        adj = sps.coo_matrix(
            (np.ones(2 * len(i)), (np.concatenate([i, j]),
                                   np.concatenate([j, i]))),
            shape=(n_pts, n_pts),
        ).tocsr()
        p_node = reverse_cuthill_mckee(adj, symmetric_mode=True)
        p = (3 * np.asarray(p_node)[:, None] + a3[None, :]).ravel()
        a = a[p][:, p].tocsr()
    a.sort_indices()
    return CSR.from_scipy(a).with_block_size(3)


def elasticity_3d(nx: int, ny: int = None, nz: int = None, nu: float = 0.3) -> CSR:
    """3-D linear elasticity on a structured hex grid (trilinear elements),
    Dirichlet on the full boundary; 3 dofs per node, ``block_size = 3``
    (the reference's vector-dof use case, core.rs:22-36)."""
    ny = ny or nx
    nz = nz or nx
    e_mod, rho = 1.0, nu
    lam = e_mod * rho / ((1 + rho) * (1 - 2 * rho))
    mu = e_mod / (2 * (1 + rho))

    # trilinear hex element stiffness via 2-point Gauss quadrature
    gp = np.array([-1.0, 1.0]) / np.sqrt(3.0)
    corners = [
        (a, b, c) for c in (0, 1) for b in (0, 1) for a in (0, 1)
    ]
    ke = np.zeros((24, 24))
    C = np.zeros((6, 6))
    C[:3, :3] = lam
    C[np.arange(3), np.arange(3)] += 2 * mu
    C[3:, 3:] = np.eye(3) * mu
    for gx in gp:
        for gy in gp:
            for gz in gp:
                dn = []
                for (a, b, c) in corners:
                    sa, sb, sc = 2 * a - 1, 2 * b - 1, 2 * c - 1
                    dn.append(
                        [
                            0.125 * sa * (1 + sb * gy) * (1 + sc * gz) * 2,
                            0.125 * sb * (1 + sa * gx) * (1 + sc * gz) * 2,
                            0.125 * sc * (1 + sa * gx) * (1 + sb * gy) * 2,
                        ]
                    )
                dn = np.array(dn)  # (8, 3)
                B = np.zeros((6, 24))
                for i in range(8):
                    bx, by, bz = dn[i]
                    B[0, 3 * i] = bx
                    B[1, 3 * i + 1] = by
                    B[2, 3 * i + 2] = bz
                    B[3, 3 * i] = by
                    B[3, 3 * i + 1] = bx
                    B[4, 3 * i + 1] = bz
                    B[4, 3 * i + 2] = by
                    B[5, 3 * i] = bz
                    B[5, 3 * i + 2] = bx
                ke += 0.125 * B.T @ C @ B

    node_idx = -np.ones((nx + 2, ny + 2, nz + 2), dtype=np.int64)
    node_idx[1:-1, 1:-1, 1:-1] = np.arange(nx * ny * nz).reshape(nx, ny, nz)
    rows, cols, vals = [], [], []
    ex, ey, ez = np.meshgrid(
        np.arange(nx + 1), np.arange(ny + 1), np.arange(nz + 1), indexing="ij"
    )
    ex, ey, ez = ex.ravel(), ey.ravel(), ez.ravel()
    corner_nodes = [
        node_idx[ex + a, ey + b, ez + c] for (a, b, c) in corners
    ]
    for a in range(8):
        for b in range(8):
            ia, ib = corner_nodes[a], corner_nodes[b]
            ok = (ia >= 0) & (ib >= 0)
            ia, ib = ia[ok], ib[ok]
            for da in range(3):
                for db in range(3):
                    rows.append(3 * ia + da)
                    cols.append(3 * ib + db)
                    vals.append(
                        np.full(len(ia), ke[3 * a + da, 3 * b + db])
                    )
    n = 3 * nx * ny * nz
    return CSR.from_coo(
        np.concatenate(rows),
        np.concatenate(cols),
        np.concatenate(vals),
        (n, n),
        block_size=3,
    ).eliminate_zeros(1e-14)


def geometric_interpolation_1d(n_coarse: int) -> CSR:
    """Linear-interpolation P: (2·n_coarse+1) × n_coarse
    (reference simple_geometric.rs:62-75): column j has stencil
    ½[1 2 1] at rows 2j, 2j+1, 2j+2."""
    rows = np.concatenate(
        [2 * np.arange(n_coarse) + k for k in range(3)]
    )
    cols = np.tile(np.arange(n_coarse), 3)
    vals = np.concatenate(
        [
            np.full(n_coarse, 0.5),
            np.full(n_coarse, 1.0),
            np.full(n_coarse, 0.5),
        ]
    )
    return CSR.from_coo(rows, cols, vals, (2 * n_coarse + 1, n_coarse))


def geometric_restriction_1d(n_coarse: int) -> CSR:
    """Full-weighting R = ¼[1 2 1] (reference simple_geometric.rs:80-93);
    R = ½Pᵀ, satisfying the variational property up to a scalar."""
    import dataclasses

    pt = geometric_interpolation_1d(n_coarse).transpose()
    return dataclasses.replace(pt, data=pt.data * 0.5)
