"""Test configuration: force an 8-device virtual CPU mesh with x64 numerics.

The tests run on the CPU; sharding tests run against XLA's host-platform
device emulation (SURVEY §4 test-strategy item 5). The program itself runs on
the GPU: ``python chip_smoke.py`` drives it there.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest


def pytest_configure(config):
    assert jax.default_backend() == "cpu", (
        f"tests must run on CPU, got {jax.default_backend()}")
    assert len(jax.devices()) == 8, "expected 8 virtual CPU devices"


@pytest.fixture
def rng():
    return np.random.default_rng(173)
