"""Hierarchy checkpoint / resume.

The reference serializes nothing but viz JSON (SURVEY.md §5: faer is
built with serde but unused for state).  For a production solver the
hierarchy — per-level CSR + P/R + near-null basis + weights — is the
natural checkpoint artifact: setup is the expensive phase, and a saved
hierarchy lets a later job (or a different machine) rebuild the device
operators and resume solving immediately.

Format: one ``.npz`` (all arrays) + embedded JSON metadata.  Everything
is host-side numpy, so checkpoints are portable across backends.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from tpu_amg.hierarchy import Hierarchy, HierarchyConfig
from tpu_amg.partition.partition import Partition
from tpu_amg.sparse.csr import CSR


def _pack_csr(prefix: str, m: CSR, out: dict):
    out[f"{prefix}_data"] = m.data
    out[f"{prefix}_indices"] = m.indices
    out[f"{prefix}_indptr"] = m.indptr
    out[f"{prefix}_meta"] = np.array(
        [m.shape[0], m.shape[1], m.block_size], dtype=np.int64
    )


def _unpack_csr(prefix: str, z) -> CSR:
    meta = z[f"{prefix}_meta"]
    return CSR(
        data=z[f"{prefix}_data"],
        indices=z[f"{prefix}_indices"],
        indptr=z[f"{prefix}_indptr"],
        shape=(int(meta[0]), int(meta[1])),
        block_size=int(meta[2]),
    )


def _pack_hierarchy(h: Hierarchy, arrays: dict, prefix: str = "") -> dict:
    meta = {
        "num_levels": h.num_levels,
        "partition_kinds": h.partition_kinds,
        "coarsest_dim": h.config.coarsest_dim,
        "max_levels": h.config.max_levels,
    }
    for lvl in range(h.num_levels):
        _pack_csr(f"{prefix}A{lvl}", h.matrices[lvl], arrays)
        arrays[f"{prefix}nn{lvl}"] = h.near_nulls[lvl]
        arrays[f"{prefix}w{lvl}"] = h.nn_weights[lvl]
    for lvl in range(h.num_levels - 1):
        _pack_csr(f"{prefix}P{lvl}", h.interpolations[lvl], arrays)
        _pack_csr(f"{prefix}R{lvl}", h.restrictions[lvl], arrays)
        arrays[f"{prefix}part{lvl}"] = h.partitions[lvl].node_to_agg
    return meta


def _unpack_hierarchy(z, meta: dict, prefix: str = "") -> Hierarchy:
    h = Hierarchy(
        config=HierarchyConfig(
            coarsest_dim=meta["coarsest_dim"], max_levels=meta["max_levels"]
        )
    )
    num_levels = meta["num_levels"]
    for lvl in range(num_levels):
        h.matrices.append(_unpack_csr(f"{prefix}A{lvl}", z))
        h.near_nulls.append(z[f"{prefix}nn{lvl}"])
        h.nn_weights.append(z[f"{prefix}w{lvl}"])
    for lvl in range(num_levels - 1):
        h.interpolations.append(_unpack_csr(f"{prefix}P{lvl}", z))
        h.restrictions.append(_unpack_csr(f"{prefix}R{lvl}", z))
        h.partitions.append(Partition(z[f"{prefix}part{lvl}"]))
    h.partition_kinds = list(meta["partition_kinds"])
    return h


def save_hierarchy(path, h: Hierarchy) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays: dict = {}
    meta = _pack_hierarchy(h, arrays)
    meta["version"] = 1
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8
    )
    np.savez_compressed(path, **arrays)


def load_hierarchy(path) -> Hierarchy:
    z = np.load(Path(path))
    meta = json.loads(bytes(z["__meta__"]).decode())
    if "components" in meta:
        raise ValueError(
            "this is a composite checkpoint; use load_composite_hierarchies"
        )
    return _unpack_hierarchy(z, meta)


def save_composite_hierarchies(path, hierarchies) -> None:
    """Checkpoint an adaptive composite: the per-component hierarchies
    (the expensive bootstrap artifact — reference adaptivity.rs:50-165
    rebuilds it from scratch every run; we don't have to)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays: dict = {}
    metas = [
        _pack_hierarchy(h, arrays, prefix=f"c{k}_")
        for k, h in enumerate(hierarchies)
    ]
    meta = {"version": 1, "components": metas}
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8
    )
    np.savez_compressed(path, **arrays)


def load_composite_hierarchies(path):
    z = np.load(Path(path))
    meta = json.loads(bytes(z["__meta__"]).decode())
    if "components" not in meta:
        raise ValueError(
            "this is a single-hierarchy checkpoint; use load_hierarchy"
        )
    return [
        _unpack_hierarchy(z, m, prefix=f"c{k}_")
        for k, m in enumerate(meta["components"])
    ]
