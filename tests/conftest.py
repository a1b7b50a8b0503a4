"""Test harness: CPU-backed JAX with 8 virtual devices so multi-device DP
collectives run without accelerator hardware (SURVEY.md §4 test-strategy
plan).

Must run before any jax backend initialization. Platform selection is forced
in-process, so the suite runs on the CPU even on a machine with a GPU; the
checks that need the card are in ``chip_smoke.py``.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from cdlrm_tpu.utils.device import enable_compile_cache  # noqa: E402

# shard_map steps recompile per test config otherwise
enable_compile_cache()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: multi-process / long-running end-to-end tests"
    )


@pytest.fixture
def rng():
    return np.random.default_rng(0)
