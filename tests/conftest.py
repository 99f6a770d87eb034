"""Test configuration: CPU backend with 8 virtual devices, float64 on.

The reference tests multi-CU hardware behaviour in the SDSoC emulator
without a board (SURVEY.md section 4 item 2, Makefile:103-108); here the
multi-device tests run on a simulated 8-device CPU mesh and the Triton
kernel runs in the Pallas interpreter.  Tests that need the card carry the
``gpu`` marker and skip, inside the ``gpu`` fixture, where JAX finds none.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
if os.environ["JAX_PLATFORMS"] == "cpu":
    jax.config.update("jax_num_cpu_devices", 8)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first GPU; skips the test where there is none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {dev.platform!r})")
    return dev
