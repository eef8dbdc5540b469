"""Partitioner-only driver with metrics streaming.

Equivalent of reference examples/aggregation/main.rs: load/generate a
system, smooth a near-null basis (seeded), run the modularity partitioner
with a callback that records/streams per-pass partition metrics
(size cost, edge cost, modularity) and partition assignments, and dump
the final partition + metrics to JSON (live HTTP streaming to a viewer
via tpu_amg.utils.viz.VizClient when one is listening).
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import numpy as np

import tpu_amg  # noqa: E402,F401  (x64 and the compile cache)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--data-dir", type=str, default=None)
    p.add_argument("--name", type=str, default="system")
    p.add_argument("--n", type=int, default=32)
    p.add_argument("--problem", type=str, default="aniso2d")
    p.add_argument("--near-null-dim", type=int, default=8)
    p.add_argument("--smoothing-iters", type=int, default=50)
    p.add_argument("--coarsening-factor", type=float, default=8.0)
    p.add_argument("--improvement-iters", type=int, default=200)
    p.add_argument("--viz-every", type=int, default=5)
    p.add_argument("--out", type=str, default="data/aggregation.json")
    p.add_argument("--seed", type=int, default=42)
    args = p.parse_args()
    # defaults expected by the shared problem loader (examples/amg.py)
    for k, v in dict(
        epsilon=1e-3, theta=np.pi / 6, coefficient="constant", block_size=1
    ).items():
        if not hasattr(args, k):
            setattr(args, k, v)

    from examples.amg import load_problem
    from tpu_amg.adaptivity import smooth_vector
    from tpu_amg.hierarchy import create_weights
    from tpu_amg.linop import aslinearoperator
    from tpu_amg.partition import PartitionerConfig
    from tpu_amg.preconditioners import build_smoother
    from tpu_amg.utils.viz import PartitionMetrics, VizClient

    a, _ = load_problem(args)
    print(f"system: n={a.nrows} nnz={a.nnz}", file=sys.stderr)
    op = aslinearoperator(a)
    m = build_smoother("l1", op.ell)
    basis, cfs = smooth_vector(
        op, m, args.smoothing_iters, args.near_null_dim,
        jax.random.PRNGKey(args.seed),
    )
    weights = create_weights(a, basis)

    client = VizClient()
    live = client.health_check()
    if live:
        print("viz server detected; streaming", file=sys.stderr)
    metrics_log = []

    def callback(iteration, partitioner):
        if iteration % args.viz_every:
            return
        metrics = PartitionMetrics(
            iteration=iteration,
            size_cost=partitioner.total_agg_size_cost(),
            edge_cost=partitioner.total_edge_cost(),
            modularity=partitioner.modularity(),
        )
        metrics_log.append(metrics.to_dict())
        print(
            f"pass {iteration}: modularity={metrics.modularity:.4f} "
            f"edge_cost={metrics.edge_cost:.3e} "
            f"size_cost={metrics.size_cost:.3e} "
            f"{partitioner.partition.info()}",
            file=sys.stderr,
        )
        if live:
            client.update_partition(partitioner.partition.node_to_agg)
            client.update_metrics(metrics)

    cfg = PartitionerConfig(
        coarsening_factor=args.coarsening_factor,
        max_improvement_iters=args.improvement_iters,
        callback=callback,
    )
    partitioner = cfg.build(a, basis, weights)
    part = partitioner.partition
    print(f"final: {part.info()}", file=sys.stderr)

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(
        json.dumps(
            {
                "node_to_agg": part.node_to_agg.tolist(),
                "stats": dataclass_dict(part.info()),
                "metrics": metrics_log,
                "convergence_factors": np.asarray(cfs).tolist(),
            }
        )
    )
    print(f"wrote {out}")


def dataclass_dict(x):
    import dataclasses

    return dataclasses.asdict(x)


if __name__ == "__main__":
    main()
