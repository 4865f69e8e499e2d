# -*- coding: utf-8 -*-
"""Test configuration: the CPU backend with 8 virtual devices (for mesh and
sharding tests) and float64 enabled.

The CPU is forced unless ``JAX_PLATFORMS`` names another platform: the
``chip``-marked tests run on an NVIDIA GPU with
``JAX_PLATFORMS=cuda python -m pytest -m chip tests/test_chip.py``.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if os.environ.get("JAX_PLATFORMS", "cpu") in ("", "cpu"):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402


DATA = "/root/reference/Data"


@pytest.fixture(scope="session")
def data_dir():
    if not os.path.isdir(DATA):
        pytest.skip("reference data fixtures not available")
    return DATA


@pytest.fixture
def gpu():
    """Skip unless JAX runs on an NVIDIA GPU (the chip tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda)")
    return jax.devices()[0]
