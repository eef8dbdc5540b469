"""SpMV format benchmark on one GPU.

Times every plain device format that applies to three fine-level
matrices, against the card's copy bandwidth measured in the same run:

- ``poisson3d``: the 3-D 7-point Poisson of chip_smoke.py's phase A
  (100³ = 1M dofs) — DIA slice-FMA and ELL gather;
- ``delaunay2d``: the 2-D jittered-Delaunay Laplacian, RCM'd
  (1024² = 1M dofs) — ELL gather;
- ``elasticity3d``: the block-3 unstructured elasticity system
  (55³ nodes, 499k dofs) — BSR block gather and ELL gather.

The format ``SparseOperator.from_csr`` picks is timed too where it is
none of these (BandedDense slabs).

Each SpMV runs ``--reps`` times inside one jitted ``fori_loop`` with the
matrix passed as an argument; the time is the best of three trials,
ended by ``block_until_ready``.  ``bound`` is the least traffic any SpMV
needs (values once, x once, y once) over the copy bandwidth, and
``share`` is that bound over the measured time.  ``format_share`` is the
same for the bytes the format itself stores (indices and padding
included): how close the kernel runs to the copy rate.

Usage (GPU only; exits non-zero without one):
    python bench.py [--poisson-side 100] [--delaunay-side 1024]
                    [--elasticity-side 55] [--reps 200] [--seed 0]
Prints one line per measurement and one JSON line last.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

COPY_BYTES = 256 * 1024 * 1024  # per array: 5x the H100's 50 MB L2


def _best_time(fn, args, trials: int = 3) -> float:
    import jax

    jax.block_until_ready(fn(*args))  # compile + warm up
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def copy_bandwidth(reps: int) -> float:
    """Bytes/s of ``v <- v + 1`` over a 256 MB f32 array (one read and
    one write per element), chained ``reps`` times in one executable."""
    import jax
    import jax.numpy as jnp

    n = COPY_BYTES // 4

    @jax.jit
    def run(v):
        return jax.lax.fori_loop(0, reps, lambda _, u: u + 1.0, v)

    t = _best_time(run, (jnp.zeros((n,), jnp.float32),))
    return 2 * COPY_BYTES * reps / t


def spmv_time(mat, x, scale: float, reps: int) -> float:
    """Seconds per SpMV of ``mat`` (passed as a jit argument)."""
    import jax

    @jax.jit
    def run(m, v):
        return jax.lax.fori_loop(0, reps, lambda _, u: m.mv(u) * scale, v)

    return _best_time(run, (mat, x)) / reps


def stored_bytes(mat) -> int:
    """Bytes of every array a device matrix holds."""
    import jax

    return sum(leaf.nbytes for leaf in jax.tree_util.tree_leaves(mat))


def formats_for(csr, dtype):
    """{label: device matrix} of the plain formats that apply."""
    from tpu_amg.linop import SparseOperator
    from tpu_amg.sparse import BSR, ELL
    from tpu_amg.sparse.dia import try_from_csr

    out = {"ell": ELL.from_csr(csr, dtype=dtype)}
    dia = try_from_csr(csr, dtype=dtype)
    if dia is not None:
        out["dia"] = dia
    if csr.block_size > 1:
        out["bsr"] = BSR.from_csr(csr, dtype=dtype)
    picked = SparseOperator.from_csr(csr, dtype=dtype).ell
    chosen = type(picked).__name__
    if chosen.lower() not in out:
        out[chosen.lower()] = picked
    return out, chosen


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--poisson-side", type=int, default=100)
    ap.add_argument("--delaunay-side", type=int, default=1024)
    ap.add_argument("--elasticity-side", type=int, default=55)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from tpu_amg.utils.platform import require_gpu
    from tpu_amg.utils.problems import (
        poisson3d,
        unstructured_elasticity_3d,
        unstructured_poisson_2d,
    )

    dev = require_gpu()
    print(f"card: {dev['card']}", flush=True)
    print(f"jax {jax.__version__} on {dev['kind']}", flush=True)
    bw = copy_bandwidth(args.reps)
    print(f"copy bandwidth: {bw / 1e9:.1f} GB/s (2 x 256 MB f32 streams)",
          flush=True)

    systems = {
        "poisson3d": lambda: poisson3d(args.poisson_side),
        "delaunay2d": lambda: unstructured_poisson_2d(
            args.delaunay_side, seed=args.seed
        ),
        "elasticity3d": lambda: unstructured_elasticity_3d(
            args.elasticity_side, seed=args.seed
        ),
    }
    results = []
    rng = np.random.default_rng(args.seed)
    for name, make in systems.items():
        csr = make()
        n, nnz = csr.nrows, csr.nnz
        scale = 1.0 / float(np.max(csr.abs_row_sums()))
        x_host = rng.standard_normal(n)
        for dtype in (jnp.float32, jnp.float64):
            itemsize = jnp.dtype(dtype).itemsize
            bound = (nnz + 2 * n) * itemsize / bw
            mats, chosen = formats_for(csr, dtype)
            x = jnp.asarray(x_host, dtype)
            for label, mat in mats.items():
                t = spmv_time(mat, x, scale, args.reps)
                fmt_t = (stored_bytes(mat) + 2 * n * itemsize) / bw
                rec = {
                    "system": name, "n": n, "nnz": nnz,
                    "dtype": jnp.dtype(dtype).name, "format": label,
                    "chosen": chosen, "us": t * 1e6,
                    "bound_us": bound * 1e6, "share": bound / t,
                    "format_share": fmt_t / t,
                }
                results.append(rec)
                print(
                    f"{name} n={n} nnz={nnz} {rec['dtype']} {label}: "
                    f"{t * 1e6:.1f} us, bound {bound * 1e6:.1f} us, "
                    f"share {bound / t:.3f}, format_share "
                    f"{fmt_t / t:.3f} (from_csr picks {chosen}) "
                    f"[{dev['card']}]",
                    flush=True,
                )
    print(json.dumps({
        "device": {k: dev[k] for k in ("platform", "kind", "count")},
        "card": dev["card"],
        "copy_gbs": bw / 1e9,
        "spmv": results,
    }))


if __name__ == "__main__":
    main()
