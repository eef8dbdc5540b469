"""Sharding-aware primitive helpers.

JAX's sharding-in-types cannot infer output shardings for contractions
over sharded dims (``jnp.vdot`` → dot_general), but elementwise-multiply
+ ``jnp.sum`` reduces cleanly (the reduction over the sharded axis
auto-inserts a psum across devices and yields a replicated scalar).  All
vectors in this library are real, so the inner products below are exact
replacements.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def sdot(a: jax.Array, b: jax.Array) -> jax.Array:
    """Real inner product, safe for row-sharded inputs."""
    return jnp.sum(a * b)


def snorm(a: jax.Array) -> jax.Array:
    """2-norm via sdot (safe for sharded vectors/matrices)."""
    return jnp.sqrt(jnp.sum(a * a))


def ensure_replicated(x: jax.Array) -> jax.Array:
    """Reshard ``x`` to fully-replicated when it carries a sharded spec.

    Single-chip formats (dense slabs, banded factors) use arbitrary
    ``jnp.take`` gathers whose output sharding cannot be inferred from a
    row-sharded operand; replicated coarse levels of a sharded V-cycle
    legitimately receive sharded vectors at the shard/replicate boundary
    (dist.shard_multigrid, reference multigrid.rs:152-159 analog), so
    these operators gather the vector once here — a small coarse-level
    all-gather across devices — and stay single-chip internally."""
    try:
        spec = jax.typeof(x).sharding.spec
    except Exception:  # concrete array outside jit, or no sharding info
        return x
    if any(s is not None for s in tuple(spec)):
        from jax.sharding import PartitionSpec as P

        return jax.sharding.reshard(x, P(*([None] * x.ndim)))
    return x
