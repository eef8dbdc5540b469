"""Adaptive (bootstrap) AMG: near-null discovery + composite enrichment.

Reference ``AdaptiveConfig`` / ``find_near_null`` / ``smooth_vector``
(adaptivity.rs:25-390):

1. ``find_near_null``: smooth ``near_null_dim`` random vectors with the
   l1-Jacobi error propagator E = I − M⁻¹A (QR re-orthonormalization
   between every sweep), build a BlockSmoother from the resulting basis
   (partition cf = smoothing block size), and smooth again with it.
2. Prepend the constant vector and thin-QR the basis; weights
   wₖ = 1/(vₖᵀAvₖ).
3. Build hierarchy + multigrid, wrap in a multiplicative Composite.
4. Enrichment loop: smooth fresh random vectors through the *current
   composite's* error propagator, use the smoothed basis + measured
   per-vector convergence factors as the next component's
   near-null/weights, push the component (up to max_components).

Device design: ``smooth_vector`` is a single jitted loop of
SpMM → preconditioner application → tall-skinny QR, all batched over the
candidate vectors (the setup hot path, SURVEY.md §3.1).  RNG uses
explicit JAX PRNG keys (the reference's library-side RNG is unseeded —
SURVEY.md Appendix B — which we fix).
"""

from __future__ import annotations

import dataclasses
import logging
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from tpu_amg.hierarchy import Hierarchy, HierarchyConfig, create_weights
from tpu_amg.linop import DiagonalOperator, LinearOperator, aslinearoperator
from tpu_amg.partition import PartitionerConfig
from tpu_amg.preconditioners.block_smoother import BlockSmoother
from tpu_amg.preconditioners.composite import Composite
from tpu_amg.preconditioners.multigrid_builder import MultigridConfig
from tpu_amg.preconditioners.smoothers import l1_inverse_diag
from tpu_amg.sparse import CSR

logger = logging.getLogger(__name__)
_HI = jax.lax.Precision.HIGHEST


from collections import OrderedDict

# Compiled-closure cache, keyed per *operator identity*; the closure
# itself keeps the operator alive, which guarantees ids in live keys are
# never reused.
_jit_cache: "OrderedDict[tuple, object]" = OrderedDict()
_JIT_CACHE_MAX = 128


def _cached(key, make):
    fn = _jit_cache.pop(key, None)
    if fn is None:
        fn = make()
    _jit_cache[key] = fn
    while len(_jit_cache) > _JIT_CACHE_MAX:
        _jit_cache.popitem(last=False)
    return fn


# Setup-phase executables take the operators as jit ARGUMENTS (pytrees),
# not closed-over constants: jax.jit's own cache then keys on the
# operator *structure*, so the 5-component bootstrap compiles one sweep
# for all same-shaped components, and no matrix is embedded in the HLO.
@partial(jax.jit, static_argnames=("iterations",))
def _run(a, m, x0, iterations):
    from tpu_amg.ops.qr import orthonormalize

    def body(_, x):
        ex = x - m.mm(a.mm(x))
        return orthonormalize(ex)

    x = orthonormalize(x0)
    x = jax.lax.fori_loop(0, iterations, body, x)
    ax = a.mm(x)
    w_norms = jnp.sqrt(jnp.einsum("nk,nk->k", x, ax, precision=_HI))
    ev = x - m.mm(ax)
    aev = a.mm(ev)
    ev_norms = jnp.sqrt(jnp.einsum("nk,nk->k", ev, aev, precision=_HI))
    return x, ev_norms / w_norms


def _make_run(a: LinearOperator, m: LinearOperator):
    def run(x0, iterations):
        return _run(a, m, x0, iterations)

    return run


@jax.jit
def _estep(a, c, x):
    return x - c.mm(a.mm(x))


@jax.jit
def _amm(a, x):
    return a.mm(x)


def _make_estep(a: LinearOperator, c: LinearOperator):
    def step(x):
        return _estep(a, c, x)

    return step


def _smooth_loop_composite(a, m, x0, iterations: int):
    """Product-form smoothing for a multi-component Composite.

    The composite's error propagator factors into its components'
    (E_comp = ∏ (I − MᵢA) in sweep order — the defining property of the
    multiplicative sweep, composite.rs:66-83), so each component's step
    is compiled ONCE and reused across every later bootstrap round: the
    5-component bootstrap compiles N per-component sweeps instead of
    re-tracing sweeps of growing size 1..N inside one program
    (quadratic → linear compile work).
    """
    from tpu_amg.ops.qr import orthonormalize

    order = list(reversed(m.components)) + list(m.components[1:])
    steps = [
        _cached(("estep", id(a), id(c)), partial(_make_estep, a, c))
        for c in order
    ]
    ortho = _cached(("ortho",), lambda: jax.jit(orthonormalize))
    amm = partial(_amm, a)

    def eprop(x):
        for s in steps:
            x = s(x)
        return x

    x = ortho(x0)
    for _ in range(iterations):
        x = ortho(eprop(x))
    ax = amm(x)
    w_norms = jnp.sqrt(jnp.einsum("nk,nk->k", x, ax, precision=_HI))
    ev = eprop(x)
    aev = amm(ev)
    ev_norms = jnp.sqrt(jnp.einsum("nk,nk->k", ev, aev, precision=_HI))
    return x, ev_norms / w_norms


def _smooth_loop(a: LinearOperator, m: LinearOperator, x0, iterations: int):
    """iterations × (x ← QR(E x)) plus per-column convergence factors.

    Compiled closures are cached per operator identity (re-jit hygiene);
    multi-component composites take the product-form path.
    """
    from tpu_amg.preconditioners.composite import Composite

    if isinstance(m, Composite) and len(m.components) > 1:
        return _smooth_loop_composite(a, m, x0, iterations)
    run = _cached(("loop", id(a), id(m)), partial(_make_run, a, m))
    return run(x0, iterations)


def smooth_vector(
    a: LinearOperator,
    m: LinearOperator,
    iterations: int,
    near_null_dim: int,
    key,
    dtype=jnp.float64,
):
    """Reference smooth_vector (adaptivity.rs:307-390).

    Returns (basis (n, near_null_dim) ndarray, convergence factors (k,)).
    """
    n = a.shape[0]
    x0 = jax.random.normal(key, (n, near_null_dim), dtype=dtype)
    x, cfs = _smooth_loop(a, m, x0, iterations)
    return np.asarray(x), np.asarray(cfs)


def _accel_device():
    """First non-cpu device, or None.  The setup phase may be
    host-pinned (SolverConfig.setup_on_host) while an accelerator
    exists — bootstrap smoothing is pure SpMM + QR and belongs on it."""
    try:
        for d in jax.devices():
            if d.platform != "cpu":
                return d
    except RuntimeError:
        pass
    return None


def _accel_op32(a: CSR, accel):
    """f32 operator on the accelerator for bootstrap smoothing, in the
    device format every other operator gets (``SparseOperator.from_csr``),
    or None without an accelerator.  Systems under 2**15 rows keep the
    f64 path: their sweeps cost little in either precision."""
    if accel is None or a.nrows < (1 << 15):
        return None
    from tpu_amg.linop import SparseOperator

    with jax.default_device(accel):
        return SparseOperator.from_csr(a, dtype=jnp.float32)


def _place(tree, device):
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, device)
        if isinstance(x, jax.Array) else x,
        tree,
    )


def find_near_null(
    a: CSR,
    iterations: int,
    near_null_dim: int,
    smoothing_block_size: float,
    key,
) -> np.ndarray:
    """Two-phase near-null bootstrap (reference adaptivity.rs:264-305).

    The smoothing sweeps (SpMM + tall-skinny QR, the setup hot path —
    SURVEY.md §3.1) run on the session's accelerator in f32 through the
    production device format whenever one exists, even when the rest of
    setup is host-pinned.
    """
    accel = _accel_device()
    op32 = _accel_op32(a, accel)
    k1, k2 = jax.random.split(key)
    if op32 is not None:
        l1_diag = jnp.asarray(
            1.0 / np.asarray(a.abs_row_sums()), jnp.float32
        )
        with jax.default_device(accel):
            l1 = DiagonalOperator(diag=jax.device_put(l1_diag, accel))
            basis, _ = smooth_vector(
                op32, l1, iterations, near_null_dim, k1,
                dtype=jnp.float32,
            )
    else:
        op = aslinearoperator(a)
        l1 = DiagonalOperator(diag=l1_inverse_diag(op.ell))
        basis, _ = smooth_vector(op, l1, iterations, near_null_dim, k1)

    p_cfg = PartitionerConfig(
        coarsening_factor=min(
            smoothing_block_size, max(a.nrows / a.block_size / 2.0, 1.0)
        ),
        max_improvement_iters=50,
    )
    weights = create_weights(a, basis)
    partition = p_cfg.build_partition(a, basis, weights).expand_blocks(
        a.block_size
    )
    if op32 is not None:
        block_pc = _place(
            BlockSmoother.build(a, partition, dtype=jnp.float32), accel
        )
        with jax.default_device(accel):
            basis, cfs = smooth_vector(
                op32, block_pc, iterations, near_null_dim, k2,
                dtype=jnp.float32,
            )
    else:
        block_pc = BlockSmoother.build(a, partition)
        basis, cfs = smooth_vector(op, block_pc, iterations, near_null_dim, k2)
    logger.info(
        "find_near_null: ||Ev||_A factors %s",
        np.array2string(cfs, precision=2),
    )
    return basis


@dataclasses.dataclass
class AdaptiveConfig:
    """Defaults (adaptivity.rs:36-48): max_components 5, test_iters 50,
    coarsening_near_null_dim 32, constant prepended."""

    hierarchy_config: HierarchyConfig = dataclasses.field(
        default_factory=HierarchyConfig
    )
    multigrid_config: MultigridConfig = dataclasses.field(
        default_factory=MultigridConfig
    )
    target_convergence: Optional[float] = None  # unused (parity with ref)
    max_components: int = 5
    test_iters: int = 50
    coarsening_near_null_dim: int = 32
    include_constant_first_near_null: bool = True

    def build(self, a: CSR, key=None, return_hierarchies: bool = False):
        """Reference AdaptiveConfig::build (adaptivity.rs:50-165).

        With ``return_hierarchies`` also returns the per-component
        hierarchies (the serializable setup artifact — see
        utils/checkpoint.py save_composite_hierarchies)."""
        key = key if key is not None else jax.random.PRNGKey(0)
        k_nn, k_loop = jax.random.split(key)
        dim = self.coarsening_near_null_dim
        nn = find_near_null(
            a,
            self.test_iters,
            dim - 1,
            self.multigrid_config.smoother_partitioner.coarsening_factor,
            k_nn,
        )
        if self.include_constant_first_near_null:
            with_const = np.concatenate([np.ones((a.nrows, 1)), nn], axis=1)
        else:
            with_const = np.concatenate([nn, nn[:, :1]], axis=1)
        basis, _ = np.linalg.qr(with_const)
        weights = create_weights(a, basis)
        logger.info("nn weights: %s", np.array2string(weights, precision=2))

        hierarchy = self.hierarchy_config.build(a, basis, weights)
        logger.info("hierarchy 1:\n%r", hierarchy)
        first = self.multigrid_config.build(hierarchy)
        composite = Composite(a=aslinearoperator(a), components=(first,))
        hierarchies = [hierarchy]

        # enrichment smoothing = full composite V-cycles over ``dim``
        # vectors — the solve-phase machinery.  Run it on the session's
        # accelerator (f32 components) even when the rest of setup is
        # pinned to the host.
        accel = _accel_device()
        op32 = None
        if jnp.dtype(self.multigrid_config.dtype) == jnp.dtype(
            jnp.float32
        ):
            op32 = _accel_op32(a, accel)
        comps_dev: list = []
        if op32 is not None:
            comps_dev.append(_place(first, accel))

        for n_components in range(1, self.max_components):
            k_loop, k_iter = jax.random.split(k_loop)
            iters = max(self.test_iters // (2 * n_components - 1), 1)
            if op32 is not None:
                comp_dev = Composite(
                    a=op32, components=tuple(comps_dev)
                )
                with jax.default_device(accel):
                    smoothed, cfs = smooth_vector(
                        op32, comp_dev, iters, dim, k_iter,
                        dtype=jnp.float32,
                    )
            else:
                smoothed, cfs = smooth_vector(
                    composite.a, composite, iters, dim, k_iter
                )
            n_vcycles = 2 * n_components - 1
            logger.info(
                "component %d: ||Ev||_A^(1/%d) = %s",
                n_components,
                n_vcycles,
                np.array2string(cfs ** (1.0 / n_vcycles), precision=2),
            )
            hierarchy = self.hierarchy_config.build(a, smoothed, cfs)
            logger.info("hierarchy %d:\n%r", n_components + 1, hierarchy)
            component = self.multigrid_config.build(hierarchy)
            composite = composite.push(component)
            hierarchies.append(hierarchy)
            if op32 is not None:
                comps_dev.append(_place(component, accel))
        if return_hierarchies:
            return composite, hierarchies
        return composite
