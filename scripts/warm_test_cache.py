"""Pre-populate the test suite's persistent XLA compile cache.

Most fast-tier (`pytest -m "not slow"`) wall time on the 1-CPU rig is
XLA compilation of a handful of heavy jitted programs — the streaming
scans, the shard_map meshes, and the fused burst.  This warmer compiles
them once into ``.jax_cache_tests`` (the same cache ``tests/conftest.py``
enables), cutting the cold 399 s run to the documented ~3 min warm time.

Usage: ``python scripts/warm_test_cache.py`` (CPU-only; safe to re-run —
cached programs are hits).
"""

import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# mirror tests/conftest.py exactly: 8 virtual CPU devices, forced CPU
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from spectralae.core.runtime import enable_compilation_cache  # noqa: E402

enable_compilation_cache(ROOT / ".jax_cache_tests")


def main():
    t0 = time.time()
    # the multichip dryrun compiles the DP/TP train steps, sharded
    # bursts (fused + unfused), spatial forward, and the streaming
    # scans over the 8-device mesh — the suite's heaviest programs
    import __graft_entry__
    __graft_entry__.dryrun_multichip(8)
    print(f"[warm] dryrun_multichip(8): {time.time()-t0:.0f}s")

    # single-device heavy hitters the dryrun does not cover: the scan-of
    # -bursts streaming trainers and the coord stream at test shapes
    import numpy as np

    from spectralae.core.config import Config, LayerParams
    from spectralae.core.types import init_params, initial_spec
    from spectralae.train.streaming import (coord_stream, fft_stream,
                                            fft_stream_sweep)

    rng = np.random.default_rng(0)
    cfg = Config(nx=32, ny=32, d=3,
                 layer=LayerParams(depth=4, lk=1, ll=1, scale=2, rmax=3.0))
    spec = initial_spec(cfg)
    spec3 = spec.add_pair(cfg.layer)
    p1 = init_params(jax.random.key(0), spec, 1.0)
    p3 = init_params(jax.random.key(0), spec3, 1.0)
    enc, dec = p1.pair(0)
    xs = rng.normal(size=(3, 3, 32, 32)).astype(np.float32)
    fft_stream(xs, enc.c, dec.c, enc.b, dec.b, iters=5)
    fft_stream_sweep(xs, p3, spec3.scales, iters=5)
    coord_stream(xs, p1, spec.scales, 0, q=2)
    print(f"[warm] streaming scans: {time.time()-t0:.0f}s total")


if __name__ == "__main__":
    main()
