"""Attribute the corr-burst PRECOMPUTE cost at a given resolution.

Times jitted sub-stages of train/fft_corr.corr_precompute in isolation
(chained-dependency methodology, see bench.py):
  (a) rfft2 of the input/out0 signals
  (b) restricted-DFT kernel spectra (Cf0, Ff0) of the anchor kernels
  (c) the two full-resolution anchor spectral convs (H0, O0fwd)
  (d) correlation products + restricted-iDFT lag windows
  (e) the full precompute and the iterate, for reference

Usage: python scripts/precompute_decomp.py [--nx 1024] [--links 8]
"""

import argparse
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
from spectralae.ops import dft, spectral
from spectralae.train import fft_corr


import bench


def time_chained(step, x0, *, n, trials=4):
    """Best-chain seconds per link, via bench.time_chained."""
    return bench.time_chained(step, x0, n=n, trials=trials).best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=1024)
    ap.add_argument("--links", type=int, default=8)
    args = ap.parse_args()
    nx = args.nx

    cfg = Config(nx=nx, ny=nx, d=3,
                 layer=LayerParams(depth=10, lk=1, ll=1, scale=2, rmax=3.0))
    spec = initial_spec(cfg)
    params = init_params(jax.random.key(0), spec, 1.0)
    enc, dec = params.pair(0)
    rng = np.random.default_rng(0)
    x0 = jax.device_put(rng.normal(size=(3, nx, nx)).astype(np.float32) * 50)
    fwd = jax.jit(lambda p, xx, s=spec.scales: model.forward_fft(p, xx, s))
    out0 = fwd(params, x0[None])[0]
    results = {}

    # (a) the signal transforms
    @jax.jit
    def stage_fft(xx):
        X = spectral.rfft2(xx[None])
        O = spectral.rfft2(out0[None])
        return X.real.sum() + O.real.sum()
    dt = time_chained(lambda xx: (None, xx + stage_fft(xx) * 0.0 + 1e-6),
                      x0, n=args.links)
    results["a_rfft2_x_out0_ms"] = dt * 1e3

    # (b) anchor kernel spectra
    @jax.jit
    def stage_kspec(xx):
        Cf = dft.kernel_spectrum(enc.c + xx[0, 0, 0] * 0.0, nx, nx)
        Ff = dft.kernel_spectrum(dec.c, nx, nx)
        return Cf.real.sum() + Ff.real.sum()
    dt = time_chained(lambda xx: (None, xx + stage_kspec(xx) * 0.0 + 1e-6),
                      x0, n=args.links)
    results["b_kernel_spectra_ms"] = dt * 1e3

    # (c) the two anchor convs (includes (a)'s X and (b)'s spectra — the
    # marginal conv cost is c − a − b)
    @jax.jit
    def stage_convs(xx):
        X = spectral.rfft2(xx[None])
        Cf = dft.kernel_spectrum(enc.c, nx, nx)
        Ff = dft.kernel_spectrum(dec.c, nx, nx)
        zM = jnp.zeros((enc.c.shape[0],), xx.dtype)
        zD = jnp.zeros((xx.shape[0],), xx.dtype)
        H = spectral.spectral_conv(X, Cf, zM, nx, nx)
        O = spectral.spectral_conv(H, Ff, zD, nx, nx)
        return O.real.sum()
    dt = time_chained(lambda xx: (None, xx + stage_convs(xx) * 0.0 + 1e-6),
                      x0, n=args.links)
    results["c_fft_kspec_convs_ms"] = dt * 1e3

    # (d) products + lag windows on precomputed spectra shapes
    @jax.jit
    def stage_windows(xx):
        X = spectral.rfft2(xx[None])
        Xc = jnp.conj(X)
        prods = jnp.concatenate([
            (Xc[:, :, None] * X[:, None]).mean(0).reshape(-1, nx,
                                                          nx // 2 + 1)
        ] * 3, axis=0)
        win = fft_corr._corr_windows(prods, nx, nx, 8, 8)
        return win.sum()
    dt = time_chained(lambda xx: (None, xx + stage_windows(xx) * 0.0 + 1e-6),
                      x0, n=args.links)
    results["d_fft_products_windows_ms"] = dt * 1e3

    # (e) full precompute, iterate-only, full burst
    pre = jax.jit(lambda xx: fft_corr.corr_precompute(
        xx[None], xx[None], out0[None], enc.c, dec.c))
    T0 = pre(x0)

    def step_pre(xx):
        T = pre(xx)
        return T, xx + T["E0E0"] * 0.0 + 1e-6
    results["e_precompute_ms"] = time_chained(step_pre, x0,
                                              n=args.links) * 1e3

    it = jax.jit(lambda T, c: fft_corr.corr_iterate(
        T, c, dec.c, enc.b, dec.b, nx=nx, ny=nx, iters=100))

    def step_it(xx):
        r = it(T0, enc.c + xx[0, 0, 0] * 1e-12)
        return r, xx + r.mses[-1] * 0.0 + 1e-6
    results["e_iterate100_ms"] = time_chained(step_it, x0,
                                              n=args.links) * 1e3

    def step_full(xx):
        r = fft_corr.fft_burst_corr(xx, None, out0, enc.c, dec.c,
                                    enc.b, dec.b, iters=100)
        return r, xx + r.mses[-1] * 0.0 + 1e-6
    results["e_full_burst_ms"] = time_chained(step_full, x0,
                                              n=args.links) * 1e3

    import json
    results["nx"] = nx
    print(json.dumps({k: (round(v, 3) if isinstance(v, float) else v)
                      for k, v in results.items()}, indent=2), flush=True)


if __name__ == "__main__":
    main()
