"""Test harness config: the CPU backend with 8 virtual devices.

This is the simulated-mesh strategy from SURVEY.md §4: multi-device sharding
logic (halo exchange, channel-parallel pipelines) is validated on a virtual
CPU mesh, so no multi-GPU machine is needed to keep tests green.

The on-device gates are the one exception: ``python -m pytest -m gpu
tests/test_chip_gates.py`` leaves JAX on its default backend (the GPU), and
the ``gpu_device`` fixture skips each gate where there is no GPU.
"""

import os

import numpy as np
import pytest


def pytest_configure(config):
    if config.getoption("markexpr") == "gpu":
        return
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu_device():
    """The GPU the on-device gates run on; skips where JAX has none."""
    import jax

    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip(
            "needs a GPU: python -m pytest -m gpu tests/test_chip_gates.py"
        )
    return device
