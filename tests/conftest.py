"""Test configuration: an 8-virtual-device CPU platform by default.

Tests are hermetic and run on the CPU (SURVEY.md §4's "multi-node without
a real cluster" analog): sharding tests run the same jit/shard_map code on
8 virtual CPU devices via --xla_force_host_platform_device_count.  This
must happen before JAX initializes any backend.

Tests marked ``gpu`` need an NVIDIA GPU; the ``gpu`` fixture skips them
elsewhere.  Run them on a machine with a card with
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``.
"""

import os

import pytest

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])


@pytest.fixture
def gpu():
    """The first JAX device when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda,cpu on a machine with one)")
    return dev
