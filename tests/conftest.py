"""Test env: force CPU with 8 virtual devices so sharding/collective tests
run without a multi-GPU host (SURVEY §4 implications).

jax may already be imported at interpreter startup, so env vars alone can
be too late — use jax.config.update before any backend is initialized.
Tests that need a GPU carry the `gpu` marker and skip here.
"""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(__file__))  # make `golden` importable
sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_sessionstart(session):
    assert jax.devices()[0].platform == "cpu", jax.devices()
    assert jax.device_count() == 8, jax.devices()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips on the CPU test backend "
        "(run on the card by `python chip_smoke.py`)")


@pytest.fixture
def gpu():
    """Skip unless JAX sees a GPU (decided at test time, never at
    import)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU")


@pytest.fixture
def rng():
    return np.random.default_rng(1234)
