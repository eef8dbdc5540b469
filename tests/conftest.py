"""Test configuration: force CPU with a virtual 8-device mesh so sharding
tests run anywhere (SURVEY.md §4.5)."""

import os

# Unit tests run on the CPU backend; chip_smoke.py and the benches use
# the GPU.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)

from tpu_amg.utils.platform import enable_compile_cache  # noqa: E402

# XLA compiles are slow on small machines; persist them so repeated test
# runs reuse compiled executables across processes.
enable_compile_cache()
