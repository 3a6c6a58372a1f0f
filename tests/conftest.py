"""Test harness: force an 8-device virtual CPU platform.

Multi-"chip" behavior (dp sharding, collective loss means) is tested on a
host-platform device mesh, per SURVEY.md section 4 (rebuild implication f).
Must run before jax initializes a backend, hence the env setup at import
time of this conftest.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")

# Most of the suite's wall-clock is XLA compiles of per-test jitted
# steps; persist them so re-runs load instead of recompiling (entries
# are keyed by platform, so GPU entries in the same dir do not collide).
# Tests that re-point the cache restore it themselves.
from pspde.utils import enable_compilation_cache

enable_compilation_cache(min_compile_seconds=0.5)

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips on the CPU (the "
        "checks that need the card live in chip_smoke.py)")


@pytest.fixture(autouse=True)
def _skip_gpu_tests_off_gpu(request):
    if (request.node.get_closest_marker("gpu")
            and jax.default_backend() != "gpu"):
        pytest.skip("needs an NVIDIA GPU; this run uses the CPU")


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)
