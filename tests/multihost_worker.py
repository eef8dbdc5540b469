"""Worker for the 2-process multihost CPU test (run via subprocess from
tests/test_multihost.py, or by hand):

    JAX_PLATFORMS=cpu python -m tests.multihost_worker <pid> <nproc> <port>

Builds a 2x4 (process, local) mesh, runs the sharded halo PCG on
poisson2d(16), and prints the max deviation from the single-process
solution.
"""

import os
import sys


def main(process_id: int, num_processes: int, port: int) -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 4)

    from tpu_amg.parallel import multihost

    multihost.initialize(
        f"localhost:{port}",
        num_processes=num_processes,
        process_id=process_id,
    )
    import jax.numpy as jnp
    import numpy as np

    jax.config.update("jax_enable_x64", True)
    from tpu_amg.linop import SparseOperator, aslinearoperator
    from tpu_amg.parallel.dist import shard_vector, try_shard_halo
    from tpu_amg.solvers import cg
    from tpu_amg.sparse import ELL
    from tpu_amg.utils.problems import poisson2d

    mesh = multihost.process_mesh()
    assert dict(mesh.shape) == {"proc": num_processes, "x": 4}, mesh.shape
    jax.set_mesh(mesh)

    a = poisson2d(16)  # 256 dofs over 8 global devices
    # reference single-process solve on host (scipy-free dense CG oracle)
    import scipy.sparse.linalg as spla

    x_ref = spla.spsolve(a.to_scipy().tocsc(), np.ones(a.nrows))

    # halo over the flattened (process, local) row order — the ring
    # leaves a process once per process boundary
    flat = jax.sharding.Mesh(
        np.array(jax.devices()).reshape(-1), ("rows",)
    )
    jax.set_mesh(flat)
    h = try_shard_halo(ELL.from_csr(a), flat, axis="rows")
    assert h is not None, "halo path must engage"
    op = SparseOperator(ell=h)
    b = shard_vector(jnp.ones(a.nrows), flat, axis="rows")
    x, info = jax.jit(lambda a_, b_: cg(a_, b_, rtol=1e-10))(op, b)
    from jax.experimental import multihost_utils

    x_np = multihost_utils.process_allgather(x, tiled=True)
    err = float(np.max(np.abs(x_np - x_ref)))
    print(
        f"MULTIHOST p{process_id}: converged={bool(info.converged)} "
        f"iters={int(info.iters)} err={err:.2e}",
        flush=True,
    )
    assert bool(info.converged) and err < 1e-7


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))
