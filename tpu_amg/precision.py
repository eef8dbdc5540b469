"""Mixed-precision preconditioning (beyond the reference).

Every hot kernel in the V-cycle is memory-bound: DIA
slice-FMAs stream `n_diags x n` values per apply, BandedDense slabs
stream their padded blocks, dense coarse levels stream whole matrices.
Storing those value streams in bfloat16 halves the memory traffic — the
preconditioner remains a *fixed* linear operator whatever precision it
is evaluated in, so PCG convergence is perturbed only through the
quality of M as an A⁻¹ approximation (a bf16 rounding of an AMG cycle
is far smaller than the cycle's own approximation error).  The outer
Krylov loop (residuals, dot products, AXPYs) stays in f32/f64.

The reference is f64-only end to end (faer `f64` throughout).

Two modes (``cast_preconditioner``):

- ``"bf16_values"``: only the *operator arrays* (matrix values, smoother
  diagonals, transfer slabs, coarse inverses) are stored bf16; vectors
  flowing through the cycle stay in the caller's dtype and every FMA
  accumulates in f32.  Halves the dominant traffic stream at nearly
  zero accuracy cost.
- ``"bf16"``: vectors too — the :class:`MixedPrecision` wrapper casts
  the residual to bf16 on entry and the correction back on exit, so
  x/y streams also halve.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from tpu_amg.linop import LinearOperator


def _cast_leaf(x, dtype):
    if isinstance(x, (jax.Array, np.ndarray)) and jnp.issubdtype(
        x.dtype, jnp.inexact
    ):
        return jnp.asarray(x, dtype=dtype)
    return x


def cast_operator(op: Any, dtype=jnp.bfloat16):
    """Recursively cast every floating-point array inside an operator
    pytree to ``dtype``; integer/bool index arrays and static metadata
    pass through untouched."""
    if op is None or isinstance(op, (int, float, bool, str, bytes, type)):
        return op
    if isinstance(op, (jax.Array, np.ndarray)):
        return _cast_leaf(op, dtype)
    if dataclasses.is_dataclass(op) and not isinstance(op, type):
        changes = {}
        for f in dataclasses.fields(op):
            v = getattr(op, f.name)
            nv = cast_operator(v, dtype)
            if nv is not v:
                changes[f.name] = nv
        return dataclasses.replace(op, **changes) if changes else op
    if isinstance(op, tuple):
        return type(op)(cast_operator(v, dtype) for v in op)
    if isinstance(op, list):
        return [cast_operator(v, dtype) for v in op]
    if isinstance(op, dict):
        return {k: cast_operator(v, dtype) for k, v in op.items()}
    return op


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MixedPrecision(LinearOperator):
    """Precision boundary: evaluates ``inner`` in ``compute_dtype`` and
    returns results in the input's dtype.  Wraps a (cast) preconditioner
    so the outer Krylov loop keeps full-precision vectors."""

    inner: LinearOperator
    compute_dtype: Any = dataclasses.field(
        default=jnp.bfloat16, metadata=dict(static=True)
    )

    @property
    def shape(self):
        return self.inner.shape

    def mv(self, x):
        return self.inner.mv(x.astype(self.compute_dtype)).astype(x.dtype)

    def mm(self, xs):
        return self.inner.mm(xs.astype(self.compute_dtype)).astype(xs.dtype)


def cast_preconditioner(pc: LinearOperator, mode: str) -> LinearOperator:
    """Apply a precision mode to a built preconditioner.

    ``mode``: ``"f32"``/``"f64"`` cast arrays to that dtype (no wrapper);
    ``"bf16_values"`` casts arrays only; ``"bf16"`` additionally wraps in
    :class:`MixedPrecision` so cycle vectors run bf16 too.
    """
    if mode in (None, "none"):
        return pc
    if mode in ("f32", "f64"):
        return cast_operator(
            pc, jnp.float32 if mode == "f32" else jnp.float64
        )
    if mode == "bf16_values":
        return cast_operator(pc, jnp.bfloat16)
    if mode == "bf16":
        return MixedPrecision(
            inner=cast_operator(pc, jnp.bfloat16),
            compute_dtype=jnp.bfloat16,
        )
    raise ValueError(f"unknown precision mode {mode!r}")
