"""Profiling / tracing utilities.

The reference's observability is `log`-level timing spans around
par-op construction and smooth-vector search (SURVEY.md §5).  The
equivalents here:

- :func:`trace` — context manager around ``jax.profiler`` (writes a
  TensorBoard-compatible trace when a log dir is given);
- :class:`Timer` — wall-clock span logger with device sync;
- :func:`spmv_metrics` — first-class roofline counters (nnz/s, effective
  GB/s) for a measured SpMV, the metric BASELINE.md targets.
"""

from __future__ import annotations

import contextlib
import logging
import time

import jax

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def trace(log_dir=None, name: str = "tpu_amg"):
    """jax.profiler trace context (no-op when log_dir is None)."""
    if log_dir is None:
        yield
        return
    import jax

    with jax.profiler.trace(str(log_dir)):
        with jax.profiler.TraceAnnotation(name):
            yield


class Timer:
    """Wall-clock span with forced device sync, logged at INFO
    (the reference's Instant-based trace!() spans, par_spmm.rs:86-90)."""

    def __init__(self, label: str, sync_value=None):
        self.label = label
        self.sync_value = sync_value

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync_value is not None:
            jax.block_until_ready(self.sync_value)
        self.elapsed = time.perf_counter() - self.t0
        logger.info("%s: %.3fs", self.label, self.elapsed)
        return False


def spmv_metrics(nnz: int, nrows: int, seconds: float, dtype_bytes: int = 4):
    """Roofline counters for one SpMV: nnz/s and the minimum-traffic
    effective bandwidth (values + x + y read/written once)."""
    bytes_min = dtype_bytes * (nnz + 2 * nrows)
    return {
        "nnz_per_s": nnz / seconds,
        "effective_gb_per_s": bytes_min / seconds / 1e9,
        "seconds": seconds,
    }
