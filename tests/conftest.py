"""Test configuration: force JAX onto a virtual 8-device CPU mesh.

Real TPU hardware is single-chip in CI; multi-chip sharding tests run against
XLA's host-platform device virtualization instead.  Must be set before JAX
initializes, hence module import order matters (pytest loads conftest first).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("JAX_NUM_CPU_DEVICES", "8")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np
import pytest

import jax

# Some dev platforms register an experimental TPU plugin that ignores
# JAX_PLATFORMS; pin computation to the (virtual 8-device) CPU backend.
try:
    _cpu = jax.local_devices(backend="cpu")
    jax.config.update("jax_default_device", _cpu[0])
except Exception:        # pragma: no cover - CPU backend always exists
    pass

from rust_raytrace_tpu.scene import reference_asset


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "needs_teapot: requires the reference teapot OBJ asset")
    config.addinivalue_line(
        "markers", "slow: interpret-mode kernel / multi-program test "
        "(minutes); fast lane = pytest -m 'not slow' (~2 min)")
    config.addinivalue_line(
        "markers", "cuda: runs the torch port's CUDA kernels; skips where "
        "torch sees no CUDA device")


def pytest_collection_modifyitems(config, items):
    if reference_asset("raytrace", "teapot_tri.obj") is None:
        skip = pytest.mark.skip(reason="reference teapot_tri.obj not available")
        for item in items:
            if "needs_teapot" in item.keywords:
                item.add_marker(skip)


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def _n_maps() -> int:
    try:
        with open("/proc/self/maps") as f:
            return sum(1 for _ in f)
    except OSError:          # pragma: no cover - non-Linux
        return 0


# Compiled executables (interpret-mode Pallas + shard_map programs) each
# hold many mmap'd code regions; a full-suite run accumulates enough to
# exhaust vm.max_map_count (65530 here), at which point LLVM aborts with
# 'Cannot allocate memory' or segfaults inside a later compile (observed
# mid-suite in the sharded-engine tests; same failure mode the soak
# harnesses rate-limit — scripts/soak_r8.py).  Shed the executable caches
# whenever the process's map count crosses a safety threshold; the rare
# recompile afterwards is cheaper than a dead suite.
_MAPS_LIMIT = 45_000


@pytest.fixture(autouse=True)
def _shed_jax_caches_near_map_limit():
    yield
    if _n_maps() > _MAPS_LIMIT:
        jax.clear_caches()
