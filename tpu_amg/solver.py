"""High-level solver facade: one-call setup + reusable jitted solves.

The reference exposes its pipeline only through example binaries; this
is the production API a user actually wants:

    solver = AMGSolver.setup(csr_matrix)           # expensive, once
    x, info = solver.solve(b)                      # fast, repeatable
    solver.save("hier.npz") / AMGSolver.load(...)  # checkpoint/resume

Setup runs host-side (partitioning, Galerkin products); the returned
solver holds device-side operators, and ``solve`` is a single jitted
PCG + V-cycle program reused across right-hand sides.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from tpu_amg.adaptivity import AdaptiveConfig, find_near_null
from tpu_amg.hierarchy import Hierarchy, HierarchyConfig, create_weights
from tpu_amg.interpolation import AggregationConfig, InterpolationConfig
from tpu_amg.linop import aslinearoperator
from tpu_amg.partition import PartitionerConfig
from tpu_amg.preconditioners.multigrid_builder import MultigridConfig
from tpu_amg.solvers import cg, stationary_iteration
from tpu_amg.sparse import CSR


@dataclasses.dataclass
class SolverConfig:
    """One knob set covering the reference CLI's surface
    (examples/amg/main.rs:32-121)."""

    method: str = "sa"  # "sa" | "classical" | "adaptive"
    # NOTE: the effective aggregation size is coarsening_factor *
    # interp_near_null_dim / block_size (reference mod.rs:135-137).
    # Keep it >= ~25 for 3-D scalar problems — too-small aggregates with
    # smoothed P densify the Galerkin coarse operators (high op
    # complexity).
    coarsening_near_null_dim: int = 16
    interp_near_null_dim: int = 4  # SA candidate dimension
    # filtered-SA P smoothing (interpolation/sa.py filter_matrix): smooth
    # with the strength-filtered A — sharper P, sparser Galerkin coarse
    # operators (lower op complexity), better high-contrast behavior
    sa_filter_theta: Optional[float] = None
    # P truncation (interpolation/sa.py truncate_prolongator): drop
    # |p_ij| < tol * rowmax after smoothing, rescale survivors.  The
    # fill control for 3-D meshes, where smoothed-P Galerkin stencils
    # otherwise reach the full 2-hop aggregate neighborhood.
    sa_trunc_tol: Optional[float] = None
    # non-Galerkin coarse sparsification (hierarchy.py coarse_drop_tol)
    coarse_drop_tol: Optional[float] = None
    smoothing_iters: int = 20
    coarsening_factor: float = 8.0
    aggregation_iters: int = 100
    coarsest_dim: int = 1000
    max_levels: Optional[int] = None
    smoother: str = "chebyshev"  # "block" | "chebyshev" | "l1" | ...
    smoothing_steps: int = 2
    # densify levels below this dimension (one dense matvec in place of
    # a sparse gather).  Memory is n² — 8192² f32 is 268 MB.
    dense_threshold: int = 2048
    mu: Optional[int] = None  # auto: 1 for SA, 2 for classical
    block_smoother_size: float = 128.0
    composite_components: int = 3  # for method="adaptive"
    reorder: bool = False  # RCM renumbering (utils/reorder.py) before setup
    dtype: object = jnp.float64
    # Mixed-precision preconditioning (precision.py): None keeps the
    # cycle in ``dtype``; "bf16_values" stores operator arrays in bf16
    # (vectors stay ``dtype``, FMAs accumulate f32 — halves the dominant
    # memory stream); "bf16" runs cycle vectors in bf16 too.
    cycle_precision: Optional[str] = None
    # Pin setup-phase device compute (batched SVD/QR, strength
    # filtering) to the host CPU backend, then move the finished
    # operators to the GPU.  Setup tensors are f64 and transient; for a
    # system that fills the card they can exceed device memory long
    # before the solve operators do.  Bootstrap smoothing stays on the
    # GPU either way (adaptivity.find_near_null).
    setup_on_host: bool = False
    seed: int = 0


class AMGSolver:
    def __init__(self, a: CSR, preconditioner, hierarchy=None, config=None,
                 perm=None):
        self.matrix = a
        self.op = aslinearoperator(a, dtype=getattr(config, "dtype", jnp.float64))
        self.preconditioner = preconditioner
        self.hierarchy = hierarchy
        self.config = config
        self._compiled = {}
        # RCM permutation (solve operates in the reordered numbering;
        # rhs/solution are translated transparently)
        self.perm = None if perm is None else jnp.asarray(perm)
        self.inv_perm = None
        if perm is not None:
            import numpy as _np

            inv = _np.empty(len(perm), dtype=_np.int64)
            inv[_np.asarray(perm)] = _np.arange(len(perm))
            self.inv_perm = jnp.asarray(inv)

    # ------------------------------------------------------------------
    @staticmethod
    def setup(a: CSR, config: Optional[SolverConfig] = None) -> "AMGSolver":
        config = config or SolverConfig()
        if (
            getattr(config, "setup_on_host", False)
            and jax.default_backend() != "cpu"
        ):
            try:
                cpu = jax.devices("cpu")[0]
            except RuntimeError:
                import logging

                logging.getLogger(__name__).warning(
                    "setup_on_host requested but no cpu backend is "
                    "registered (JAX_PLATFORMS=%s); running setup on the "
                    "default device",
                    jax.config.jax_platforms,
                )
                cpu = None
            if cpu is not None:
                target = jax.devices()[0]
                with jax.default_device(cpu):
                    solver = AMGSolver._setup_impl(a, config)
                solver.place(target)
                return solver
        return AMGSolver._setup_impl(a, config)

    def place(self, device) -> "AMGSolver":
        """Move the solver's device arrays (operators, preconditioner) to
        ``device``; invalidates compiled executables."""

        def put(tree):
            return jax.tree_util.tree_map(
                lambda x: jax.device_put(x, device)
                if isinstance(x, jax.Array)
                else x,
                tree,
            )

        self.op = put(self.op)
        self.preconditioner = put(self.preconditioner)
        if self.perm is not None:
            self.perm = jax.device_put(self.perm, device)
            self.inv_perm = jax.device_put(self.inv_perm, device)
        self._compiled.clear()
        return self

    @staticmethod
    def _setup_impl(a: CSR, config: SolverConfig) -> "AMGSolver":
        perm = None
        if config.reorder:
            from tpu_amg.utils.reorder import rcm_reorder

            a, perm, _ = rcm_reorder(a)
        key = jax.random.PRNGKey(config.seed)
        interp = InterpolationConfig(
            kind="aggregation" if config.method in ("sa", "adaptive") else "classical",
            aggregation=AggregationConfig(
                candidate_dimension=config.interp_near_null_dim,
                filter_theta=config.sa_filter_theta,
                trunc_tol=config.sa_trunc_tol,
                partitioner_config=PartitionerConfig(
                    coarsening_factor=config.coarsening_factor,
                    max_improvement_iters=config.aggregation_iters,
                ),
            ),
        )
        hier_cfg = HierarchyConfig(
            coarsest_dim=config.coarsest_dim,
            interpolation_config=interp,
            max_levels=config.max_levels,
            coarse_drop_tol=config.coarse_drop_tol,
        )
        mg_cfg = AMGSolver._mg_config(config)
        if config.method == "adaptive":
            pc, hierarchies = AdaptiveConfig(
                hierarchy_config=hier_cfg,
                multigrid_config=mg_cfg,
                max_components=config.composite_components,
                test_iters=config.smoothing_iters,
                coarsening_near_null_dim=config.coarsening_near_null_dim,
            ).build(a, key, return_hierarchies=True)
            pc = AMGSolver._apply_precision(pc, config)
            solver = AMGSolver(a, pc, hierarchy=None, config=config, perm=perm)
            solver.component_hierarchies = hierarchies
            return solver

        import logging
        import time as _time

        log = logging.getLogger(__name__)
        t0 = _time.perf_counter()
        nn = find_near_null(
            a,
            config.smoothing_iters,
            config.coarsening_near_null_dim - 1,
            config.block_smoother_size,
            key,
        )
        basis, _ = np.linalg.qr(
            np.concatenate([np.ones((a.nrows, 1)), nn], axis=1)
        )
        t1 = _time.perf_counter()
        log.info("setup phase: near-null smoothing + QR %.1fs", t1 - t0)
        hierarchy = hier_cfg.build(a, basis, create_weights(a, basis))
        t2 = _time.perf_counter()
        log.info("setup phase: hierarchy build %.1fs", t2 - t1)
        mg = AMGSolver._apply_precision(mg_cfg.build(hierarchy), config)
        log.info(
            "setup phase: multigrid build %.1fs", _time.perf_counter() - t2
        )
        return AMGSolver(a, mg, hierarchy=hierarchy, config=config, perm=perm)

    @staticmethod
    def _apply_precision(pc, config: SolverConfig):
        if getattr(config, "cycle_precision", None) is None:
            return pc
        from tpu_amg.precision import cast_preconditioner

        return cast_preconditioner(pc, config.cycle_precision)

    # ------------------------------------------------------------------
    def compile(self, *, rtol: float = 1e-8, maxiter: int = 500,
                method: str = "cg"):
        """Build the solve executable for (rtol, maxiter, method).

        The system operator and preconditioner are passed to the jitted
        program as arguments, not closed over as compile-time constants:
        closed over, a 262k-dof hierarchy compiled in 54 s into 3.6 GB of
        code on an H100, against 6 s and 0.3 MB, for the same solve time.
        """
        key = (rtol, maxiter, method)
        if key in self._compiled:
            return self._compiled[key]
        op, pc = self.op, self.preconditioner
        driver = cg if method == "cg" else stationary_iteration

        @jax.jit
        def solve_arg(op_, pc_, b, x0=None):
            return driver(op_, b, pc_, x0, rtol=rtol, maxiter=maxiter)

        def solve_fn(b, x0=None):
            return solve_arg(op, pc, b, x0)

        self._compiled[key] = solve_fn
        return solve_fn

    def solve(self, b, x0=None, *, rtol: float = 1e-8, maxiter: int = 500,
              method: str = "cg"):
        """PCG (default) or stationary solve via the compiled executable
        (cached per (rtol, maxiter, method))."""
        b = jnp.asarray(b)
        if self.perm is not None:
            b = b[self.perm]
            if x0 is not None:
                x0 = jnp.asarray(x0)[self.perm]
        fn = self.compile(rtol=rtol, maxiter=maxiter, method=method)
        x, info = fn(b) if x0 is None else fn(b, jnp.asarray(x0))
        if self.perm is not None:
            x = x[self.inv_perm]
        return x, info

    def apply_preconditioner(self, r):
        return self.preconditioner.mv(jnp.asarray(r))

    def level_matrices(self):
        """Host CSRs ``(a, p, r)`` each cycle level's device operators
        were built from, in the cycle's own numbering — the reference to
        check those operators against.  SA/classical solvers only."""
        if self.hierarchy is None:
            raise ValueError("solver has no single hierarchy")
        return [
            (a, p, r)
            for a, _, p, r in self._mg_config(self.config).level_csrs(
                self.hierarchy
            )
        ]

    # ------------------------------------------------------------------
    def save(self, path) -> None:
        """Checkpoint the setup artifact: the hierarchy (SA/classical) or
        the per-component hierarchies (adaptive composite)."""
        if self.hierarchy is not None:
            from tpu_amg.utils.checkpoint import save_hierarchy

            save_hierarchy(path, self.hierarchy)
            return
        hierarchies = getattr(self, "component_hierarchies", None)
        if not hierarchies:
            raise ValueError(
                "solver has neither a hierarchy nor component hierarchies"
            )
        from tpu_amg.utils.checkpoint import save_composite_hierarchies

        save_composite_hierarchies(path, hierarchies)

    @staticmethod
    def _mg_config(config: SolverConfig) -> MultigridConfig:
        return MultigridConfig(
            mu=config.mu,
            smoothing_steps=config.smoothing_steps,
            smoother=config.smoother,
            dtype=config.dtype,
            dense_threshold=getattr(config, "dense_threshold", 2048),
            smoother_partitioner=PartitionerConfig(
                coarsening_factor=config.block_smoother_size,
                max_improvement_iters=50,
            ),
        )

    @staticmethod
    def load(path, a: CSR, config: Optional[SolverConfig] = None) -> "AMGSolver":
        """Rebuild a solver from a checkpoint (single-hierarchy or
        adaptive-composite archive; the format self-identifies)."""
        import json as _json

        import numpy as _np

        from tpu_amg.utils.checkpoint import (
            load_composite_hierarchies,
            load_hierarchy,
        )

        config = config or SolverConfig()
        mg_cfg = AMGSolver._mg_config(config)
        with _np.load(path) as z:
            meta = _json.loads(bytes(z["__meta__"]).decode())
        if "components" in meta:
            from tpu_amg.preconditioners.composite import Composite

            hierarchies = load_composite_hierarchies(path)
            components = tuple(mg_cfg.build(h) for h in hierarchies)
            pc = Composite(
                a=aslinearoperator(a, dtype=config.dtype),
                components=components,
            )
            pc = AMGSolver._apply_precision(pc, config)
            solver = AMGSolver(a, pc, hierarchy=None, config=config)
            solver.component_hierarchies = hierarchies
            return solver
        hierarchy = load_hierarchy(path)
        mg = AMGSolver._apply_precision(mg_cfg.build(hierarchy), config)
        return AMGSolver(a, mg, hierarchy=hierarchy, config=config)
