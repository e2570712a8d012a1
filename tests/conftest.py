"""Test config: run the suite on a virtual 8-device CPU mesh.

The suite is CPU-only: the platform is forced through ``jax.config``
before any backend is initialised (so it holds even where JAX would
otherwise pick a GPU), and 8 virtual host devices let the multi-device
sharding tests (ppermute halo exchange, shard_map) run without real cards.
Subprocesses that tests start get ``JAX_PLATFORMS=cpu`` in their
environment.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def pytest_report_header(config):
    return f"jax devices: {jax.device_count()}x {jax.devices()[0].platform}"
