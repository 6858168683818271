"""Test configuration: JAX on a virtual 8-device CPU mesh.

The multi-device story is tested with XLA's host-platform device
virtualization (SURVEY.md §4).  XLA_FLAGS must be set before the first
backend initialization.  The GPU lane (tests/test_gpu.py, marker `gpu`)
keeps the process's own backend when OFDM_JAX_GPU_TESTS=1; chip_smoke.py
sets it before it runs that lane in its own process.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if os.environ.get("OFDM_JAX_GPU_TESTS") != "1":
    jax.config.update("jax_platforms", "cpu")
