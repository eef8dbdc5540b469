"""Multi-host (multi-process) distribution scaffolding.

The reference is single-host shared-memory only (SURVEY.md §2.1); here
the scaling story spans hosts: one process per host, fast collectives
among a host's local devices, the network between hosts.  This module
provides the process-aware pieces:

- :func:`initialize` — ``jax.distributed.initialize`` wrapper with
  env-var defaults and single-process no-op,
- :func:`process_mesh` — a (process, local) device mesh whose
  row-ordering keeps a process's devices contiguous, so the halo ring
  (parallel/halo.py) leaves a host only at process boundaries (one slab
  per boundary per SpMV — the bandwidth-optimal layout for a
  row-partitioned hierarchy),
- :func:`global_put` — multihost-safe device placement (single-process
  ``device_put`` falls back transparently).

Launch recipe (N hosts, one process each)::

    # on host i of N (coordinator = host 0):
    python train.py  # inside, before any jax computation:
    #   from tpu_amg.parallel import multihost
    #   multihost.initialize("host0:8476", num_processes=N, process_id=i)
    #   mesh = multihost.process_mesh()

    # CPU rehearsal (2 processes x 4 virtual devices, same code path):
    JAX_PLATFORMS=cpu python -m tests.multihost_worker 0 2 &
    JAX_PLATFORMS=cpu python -m tests.multihost_worker 1 2

Verified by tests/test_multihost.py: a 2-process x 4-device CPU run of
the sharded halo PCG reproduces the single-process solution.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
) -> None:
    """Initialize the JAX distributed runtime (no-op when single-process).

    Arguments default to the standard env vars
    (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``,
    ``JAX_PROCESS_ID``); on clusters that jax autodetects all three may
    be None.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None:
        env = os.environ.get("JAX_NUM_PROCESSES")
        num_processes = int(env) if env else None
    if process_id is None:
        env = os.environ.get("JAX_PROCESS_ID")
        process_id = int(env) if env else None
    if coordinator_address is None and num_processes in (None, 1):
        return  # single-process
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )


def process_mesh(local_axis: str = "x", process_axis: str = "proc"):
    """(n_processes, devices_per_process) mesh: ``process_axis`` over
    processes, ``local_axis`` over each process's local devices.

    Row-shard solver state over ``(process_axis, local_axis)`` (pass the
    tuple as the axis to shard_ell/shard_vector): consecutive row blocks
    land on devices of one host and the halo ring leaves a host exactly
    once per process boundary.
    """
    n_proc = jax.process_count()
    devices = np.array(jax.devices())
    if len(devices) % n_proc:
        raise ValueError(
            f"{len(devices)} devices not divisible by {n_proc} processes"
        )
    return jax.sharding.Mesh(
        devices.reshape(n_proc, -1), (process_axis, local_axis)
    )


def global_put(arr, sharding):
    """Place a host array under ``sharding``, multihost-safe.

    Single-process: plain ``device_put``.  Multi-process: every process
    holds the same logical array; each contributes its addressable
    shards via ``make_array_from_callback``.
    """
    if jax.process_count() == 1:
        return jax.device_put(arr, sharding)
    import jax.numpy as jnp

    host = np.asarray(arr)
    return jax.make_array_from_callback(
        host.shape, sharding, lambda idx: jnp.asarray(host[idx])
    )
