"""tpu-amg: an adaptive algebraic multigrid framework on JAX, run on a GPU.

A JAX/XLA implementation of the capabilities of the Rust ``faer-amg``
reference (adaptive smoothed-aggregation + classical AMG preconditioning
for sparse SPD systems):

- sparse containers are immutable pytrees (CSR for host setup; DIA, ELL,
  BSR and dense slabs for the device compute path),
- the hot SpMV/SpMM path runs as fused XLA slice-FMAs and gathers,
- smoothers are batched dense solves,
- hierarchy setup (strength graph, modularity aggregation, tentative +
  smoothed P, Galerkin RAP) runs as host-side graph algorithms + batched
  XLA linear algebra,
- multi-chip scaling uses `jax.sharding` meshes with row-partitioned levels.

Double precision is enabled at import: the reference library is f64
throughout (faer ``SparseRowMat<usize, f64>``, reference core.rs:13-17) and
AMG setup/solve tolerances (1e-12) require it.  Device hot paths
explicitly request f32/bf16 where appropriate, and every f32 matrix
product asks for full precision (no TF32).
"""

import jax

jax.config.update("jax_enable_x64", True)

from tpu_amg.utils.platform import enable_compile_cache  # noqa: E402

enable_compile_cache()

from tpu_amg import errors, sparse  # noqa: E402


def __getattr__(name):
    # lazy top-level conveniences (avoid import cycles at package init)
    if name in ("AMGSolver", "SolverConfig"):
        from tpu_amg import solver

        return getattr(solver, name)
    if name == "Hierarchy":
        from tpu_amg.hierarchy import Hierarchy

        return Hierarchy
    if name == "HierarchyConfig":
        from tpu_amg.hierarchy import HierarchyConfig

        return HierarchyConfig
    if name == "AdaptiveConfig":
        from tpu_amg.adaptivity import AdaptiveConfig

        return AdaptiveConfig
    if name in ("cast_operator", "cast_preconditioner", "MixedPrecision"):
        from tpu_amg import precision

        return getattr(precision, name)
    raise AttributeError(f"module 'tpu_amg' has no attribute {name!r}")


from tpu_amg.linop import (  # noqa: E402
    LinearOperator,
    SparseOperator,
    DenseOperator,
    ComposedOperator,
    ScaledIdentity,
    aslinearoperator,
)

__version__ = "0.1.0"

__all__ = [
    "errors",
    "sparse",
    "AMGSolver",
    "SolverConfig",
    "Hierarchy",
    "HierarchyConfig",
    "AdaptiveConfig",
    "LinearOperator",
    "SparseOperator",
    "DenseOperator",
    "ComposedOperator",
    "ScaledIdentity",
    "aslinearoperator",
    "cast_operator",
    "cast_preconditioner",
    "MixedPrecision",
]
