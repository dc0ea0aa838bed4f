"""Test configuration: the CPU backend with 8 virtual devices, so the
multi-device sharding paths (mesh/pjit/shard_map, psum/all_to_all
collectives) run without accelerator hardware, per SURVEY.md §4's
distributed-test plan.

Tests marked ``gpu`` need an NVIDIA GPU and skip here (the ``gpu_device``
fixture decides, at run time).  On a machine with the card,
``python -m pytest -m gpu tests/`` leaves the default backend alone and keeps
the persistent compile cache (utils/cache.py); the same checks also run as
phases of ``chip_smoke.py``.
"""
import os

import jax
import pytest


def _gpu_run(config) -> bool:
    return config.getoption("markexpr", default="").strip() == "gpu"


def pytest_configure(config):
    if _gpu_run(config):
        from fusion_cryptography_tpu.utils.cache import enable_compile_cache

        enable_compile_cache()
        return
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu_device():
    """The first device, when it is an NVIDIA GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (default device is {dev.platform})")
    return dev
