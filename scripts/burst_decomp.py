"""Attribute the corr burst's fixed cost: precompute vs inner loop vs glue.

Within-process ratio measurement on one GPU (bench.py's chained-dependency
timing) of
(a) the one-time correlation precompute alone,
(b) the inner loop alone on a frozen precompute (iters=100 and 400),
(c) the full burst (precompute + loop) at iters=100/400,
at 256x256, M=10, D=3, 5x5 — the headline config.

Usage: python scripts/burst_decomp.py [--nx 256] [--links 20]
"""

import argparse
import functools
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from spectralae.core.runtime import enable_compilation_cache

enable_compilation_cache()

import jax
import jax.numpy as jnp

from spectralae.core.config import Config, LayerParams
from spectralae.core.types import initial_spec, init_params
from spectralae.model import autoencoder as model
from spectralae.train import fft_corr


import bench


def time_chained(step, x0, *, n, trials=5):
    """Best-chain seconds per link, via bench.time_chained."""
    return bench.time_chained(step, x0, n=n, trials=trials).best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=256)
    ap.add_argument("--links", type=int, default=20)
    args = ap.parse_args()
    nx = args.nx

    rng = np.random.default_rng(0)
    cfg = Config(nx=nx, ny=nx, d=3,
                 layer=LayerParams(depth=10, lk=1, ll=1, scale=2, rmax=3.0))
    spec = initial_spec(cfg)
    params = init_params(jax.random.key(0), spec, 1.0)
    enc, dec = params.pair(0)
    x0 = jax.device_put(rng.normal(size=(3, nx, nx)).astype(np.float32) * 50)
    fwd = jax.jit(lambda p, x: model.forward_fft(p, x, spec.scales))
    out0 = fwd(params, x0[None])[0]

    res = {}

    # (a) precompute alone
    pre = jax.jit(lambda x: fft_corr.corr_precompute(
        x[None], x[None], out0[None], enc.c, dec.c))

    def step_pre(x):
        T = pre(x)
        return T, x + T["E0E0"] * 0.0 + 1e-6
    res["precompute_ms"] = time_chained(step_pre, x0, n=args.links) * 1e3

    # (b) inner loop alone on a frozen precompute
    T0 = pre(x0)
    for iters in (100, 400):
        it = jax.jit(functools.partial(
            fft_corr.corr_iterate, nx=nx, ny=nx, lr=0.2, iters=iters))

        def step_it(c, it=it):
            r = it(T0, c, dec.c, enc.b, dec.b)
            return r, r.c + 1e-6
        res[f"iterate_{iters}_ms"] = time_chained(
            step_it, enc.c, n=args.links) * 1e3

    # (c) full burst
    for iters in (100, 400):
        def step_full(x, iters=iters):
            r = fft_corr.fft_burst_corr(x, x, out0, enc.c, dec.c,
                                        enc.b, dec.b, lr=0.2, iters=iters)
            return r, x + r.mses[-1] * 0.0 + 1e-6
        res[f"full_{iters}_ms"] = time_chained(
            step_full, x0, n=args.links) * 1e3

    res["glue_100_ms"] = (res["full_100_ms"] - res["precompute_ms"]
                          - res["iterate_100_ms"])
    res["per_iter_us"] = (res["iterate_400_ms"]
                          - res["iterate_100_ms"]) / 300 * 1e3
    print(json.dumps({k: round(v, 4) for k, v in res.items()}, indent=2))


if __name__ == "__main__":
    main()
