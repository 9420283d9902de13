"""Test harness configuration.

The platform comes from ``JAX_PLATFORMS``; where it is unset the tests run
on the CPU, with 8 virtual devices (the multi-chip "fake backend" —
SURVEY.md §4) and float64 enabled, so numerical assertions can be tight
like the reference gtest suite.

Tests that need the card carry the ``gpu`` marker and take the ``gpu``
fixture, which skips them on any other platform.  Run them on the card
with ``JAX_PLATFORMS=cuda python -m pytest tests -m gpu``."""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: multi-minute regression tests (deselect with -m 'not slow')")
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU; skips elsewhere (run with "
        "JAX_PLATFORMS=cuda python -m pytest tests -m gpu)")


@pytest.fixture
def gpu():
    """The first JAX device, when it is a GPU; skips the test otherwise.
    Decided here, at run time, never while test modules are imported."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {dev.platform}")
    return dev
