"""Test environment: force the CPU backend with 8 virtual devices (the
multi-device test strategy — shardings compile and run without a card) and
enable x64 so physics comparisons run in the reference's float64."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402


REFERENCE = "/root/reference"


def reference_available() -> bool:
    return os.path.isdir(os.path.join(REFERENCE, "src"))


@pytest.fixture(scope="session")
def ref_path():
    if not reference_available():
        pytest.skip("reference tree not mounted")
    return os.path.join(REFERENCE, "src")


@pytest.fixture
def rng():
    return np.random.default_rng(0)
