"""Test configuration: force the CPU platform with 8 virtual devices.

Unit tests validate numerics and multi-device sharding on a virtual
8-device CPU mesh; tests that need a GPU carry the ``gpu`` marker and skip
here (see the ``gpu`` fixture).  jax.config overrides any JAX_PLATFORMS
setting before backend initialisation.  On a machine with a GPU,
``SAF_TESTS_ON_GPU=1 python -m pytest tests -m gpu`` runs the GPU tests on
the card instead.
"""
import os

import pytest

ON_GPU = os.environ.get("SAF_TESTS_ON_GPU") == "1"

flags = os.environ.get("XLA_FLAGS", "")
if not ON_GPU and "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """Skip the test unless JAX's default backend is a GPU (decided when
    the test runs, never at import)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run with SAF_TESTS_ON_GPU=1 on the card)")
