"""Test configuration: an 8-virtual-device CPU backend by default.

Mirrors the SURVEY §4 test-strategy recommendation: the suite runs without
an accelerator, and sharding/collective tests exercise a real multi-device
mesh via ``--xla_force_host_platform_device_count``. float64 is enabled so
golden parity tests against the reference's numpy formulas are
bit-meaningful.

``JAX_PLATFORMS`` picks the backend (default ``cpu``): run the suite with
``JAX_PLATFORMS=cpu``; on a GPU machine ``python -m pytest tests/ -m gpu``
runs the tests that need the card (the ``gpu`` fixture skips them
elsewhere). jax may already be imported with another platform selected, so
the setting is also applied with ``jax.config.update`` — backends
initialize lazily, so that still takes effect before first device use.
"""

import importlib.util
import os
from pathlib import Path

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture(scope="session")
def smoke():
    """The repo-root ``chip_smoke.py`` as a module (its oracle helpers)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def gpu():
    """The first JAX device when it is a GPU; skips the test otherwise.

    Decided here, at run time, never at import: every xdist worker must
    collect the same tests."""
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX's first device is {device.platform!r});"
                    " on the card run: python -m pytest tests/ -m gpu")
    return device
