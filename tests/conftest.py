"""Test harness config: run on CPU with 8 virtual devices.

Multi-device tests exercise the mesh/sharding layer without accelerators,
per SURVEY.md §4(d).  The platform is pinned through ``jax.config`` as well
as the environment, *before* any backend is initialized, so an installed
GPU plugin cannot claim the test process.  Checks that need the card live
in ``chip_smoke.py``; a test that needs one takes the ``gpu`` fixture (it
skips with a reason here).
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import sys  # noqa: E402
from pathlib import Path as _Path  # noqa: E402

sys.path.insert(0, str(_Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# Persistent compile cache for the suite: the rig is single-CPU and most
# test wall-time is XLA compilation of the jitted programs (scans of
# bursts, shard_map meshes) — a warm cache cuts repeat suite runs by ~2×.
# Separate directory from the program's cache; gitignored.  Where
# JAX_COMPILATION_CACHE_DIR is set, that directory wins.
from spectralae.core.runtime import enable_compilation_cache  # noqa: E402

enable_compilation_cache(_Path(__file__).resolve().parent.parent
                         / ".jax_cache_tests")


import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless JAX sees a GPU — decided when the test runs, never at
    import or collection time, so every xdist worker collects the same
    tests.  Tests taking it carry the ``gpu`` marker."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run on the card via "
                    "`python chip_smoke.py`)")
    return jax.devices()[0]
