"""Test config: force real CPU with 8 virtual devices so multi-device
sharding logic is exercised without accelerator hardware (SURVEY §4 test
plan).

Tests that need the GPU carry the ``gpu`` marker and skip here; the
``gpu_device`` fixture decides, at run time, whether a card exists.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

if not os.environ.get("NGPDE_TEST_ON_GPU"):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX has none."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip("needs a GPU: run `NGPDE_TEST_ON_GPU=1 pytest -m gpu` "
                    "on a machine with one")
    return devs[0]
