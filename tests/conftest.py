"""Test config: run everything on a faked 8-device CPU backend.

Sharding tests use 8 virtual CPU devices (the multi-chip story the
reference never had — SURVEY.md §4). x64 is enabled so tolerances match
the reference's f64 test oracles. The platform is set through jax.config
so that the suite stays on the CPU even on a host with a GPU; tests that
need the card carry the ``gpu`` marker and use the ``gpu_device`` fixture.
"""
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)
# Persistent compilation cache: XLA CPU compiles of QR/SVD kernels dominate
# test wall-clock; cache them across pytest runs.
from corrla_rs_tpu.utils.cache import enable_persistent_cache  # noqa: E402

enable_persistent_cache()

import os  # noqa: E402

# The full suite compiles/loads thousands of XLA:CPU executables in one
# process; each holds JIT code segments in separate mmaps, and at the
# kernel default vm.max_map_count=65530 a single-process run can die
# mid-suite inside a persistent-cache read. The autouse fixture below
# drops references to compiled executables between test modules when the
# process nears that limit (re-JITs hit the persistent cache).

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def _map_headroom_low():
    """True when this process has consumed >50% of vm.max_map_count.
    Clearing jax caches costs a full re-trace + persistent-cache reload
    of every executable the next module touches (~100-200s across the
    suite), so only pay it when the map budget is actually at risk."""
    try:
        with open("/proc/sys/vm/max_map_count") as f:
            limit = int(f.read())
        with open("/proc/self/maps", "rb") as f:
            used = sum(1 for _ in f)
        return used > limit // 2
    except OSError:
        return True  # can't measure: keep the conservative behavior


@pytest.fixture(autouse=True, scope="module")
def _bound_executable_maps():
    """Release compiled executables between test modules ONLY when the
    process is approaching vm.max_map_count (see the note above)."""
    yield
    if _map_headroom_low():
        jax.clear_caches()


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu_device():
    """The first GPU visible to a fresh process, or a skip.

    The suite's own process is held to the CPU, so the check runs in a
    child process that starts JAX with its default platform.
    """
    import subprocess
    import sys

    proc = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.devices()[0].platform)"],
        capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"},
    )
    if proc.returncode != 0 or proc.stdout.strip() != "gpu":
        pytest.skip("needs a GPU (JAX's default platform here is "
                    f"{proc.stdout.strip() or 'unavailable'})")
    return "gpu"
