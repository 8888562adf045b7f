"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-chip hardware is not available in CI; sharding/collective tests use
``--xla_force_host_platform_device_count=8`` exactly as recommended for
validating `Mesh`/`shard_map` programs without real chips.

Unless ``JAX_PLATFORMS`` names a platform, the backend is pinned to the
CPU through ``jax.config.update``. ``XLA_FLAGS`` is read lazily at
backend-init time, so the env mutation works as long as no computation
ran. Tests that need a GPU carry the ``gpu`` marker and skip elsewhere
from inside a fixture; on a GPU machine run them with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()
import jax  # noqa: E402

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_threefry_partitionable", True)


def pytest_report_header(config):
    return f"jax backend: {jax.default_backend()}, devices: {jax.device_count()}"
