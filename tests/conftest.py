"""Test configuration.

The CPU backend gets 8 virtual devices, so the sharding tests run without
accelerators (run the suite with ``JAX_PLATFORMS=cpu``). Tests that need a
GPU carry the ``gpu`` marker and decide in a fixture whether one is present.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips elsewhere"
    )
    config.addinivalue_line("markers", "slow: long-running test")


@pytest.fixture(scope="session")
def rng():
    return np.random.RandomState(1234)


@pytest.fixture(scope="session")
def reference_dir():
    """Checkout of the reference tool (its grid.json and segmentation.py),
    named by TPU_INSPECT_REFERENCE_DIR. Skips the test when the variable is
    unset, and fails it when the variable names no such checkout."""
    import pathlib

    d = os.environ.get("TPU_INSPECT_REFERENCE_DIR", "")
    if not d:
        pytest.skip("reference tool checkout not available "
                    "(set TPU_INSPECT_REFERENCE_DIR)")
    if not (pathlib.Path(d) / "grid.json").is_file():
        pytest.fail(f"TPU_INSPECT_REFERENCE_DIR={d} holds no grid.json")
    return pathlib.Path(d)


@pytest.fixture(scope="session")
def gpu_device():
    """The first JAX device when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {dev.platform})")
    return dev
