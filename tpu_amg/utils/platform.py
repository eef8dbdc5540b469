"""Compile cache and GPU checks shared by the package, tests, benches and
tools.

- :func:`enable_compile_cache` keeps XLA's persistent compilation cache
  where ``JAX_COMPILATION_CACHE_DIR`` says, and otherwise at one fixed,
  gitignored path inside the checkout (the path is part of the cache key,
  so a directory that moves never hits).
- :func:`require_gpu` is the first call of every measurement script: it
  fails when JAX finds no GPU, instead of measuring the CPU backend.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

import jax

CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> None:
    """Persist compiled executables across processes.

    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX reads it itself and
    nothing is set here; otherwise the cache goes to ``CACHE_DIR``.
    """
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


def gpu_name_and_power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them;
    several identical cards read ``"<name>, <limit> x <count>"``."""
    out = subprocess.run(
        [
            "nvidia-smi",
            "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        check=True,
        capture_output=True,
        text=True,
        timeout=60,
    )
    cards = out.stdout.strip().splitlines()
    if len(set(cards)) == 1 and len(cards) > 1:
        return f"{cards[0]} x {len(cards)}"
    return "; ".join(cards)


def require_gpu() -> dict:
    """Device record of the first GPU; raises SystemExit without one.

    Returns ``{"platform", "kind", "count", "card"}`` where ``card`` is
    the ``nvidia-smi`` name and power limit, to be printed beside every
    number measured on it.
    """
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's first device is {dev.platform!r} "
            f"({dev.device_kind}); this script measures the GPU only"
        )
    return {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
        "card": gpu_name_and_power_limit(),
    }
