"""Test harness config: run on CPU with 8 virtual devices.

Multi-device sharding is validated on a virtual CPU mesh
(`xla_force_host_platform_device_count=8`), which tests domain
decomposition without a multi-GPU host. Must run before jax imports.
The GPU path is checked on the card by ``python chip_smoke.py``.
"""

import os
import resource

# XLA's CPU compile (LLVM passes, often on the calling thread) can overflow
# the default 8 MB stack on deep programs. Raise the limit BEFORE jax spawns
# any compile worker threads (their stacks are sized from the rlimit at
# pthread_create).
try:
    resource.setrlimit(resource.RLIMIT_STACK,
                       (resource.RLIM_INFINITY, resource.RLIM_INFINITY))
except (ValueError, OSError):
    pass

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_threefry_partitionable", True)

from navierstokessolver_tpu.utils import jaxcache  # noqa: E402

jaxcache.setup()

