"""Measure the choices core/backend.py makes for the GPU, on the GPU.

1. ``spectral_conv`` contenders — the complex einsum and the split re/im
   broadcast-sum — forward+VJP of one pointwise conv (M=10, D=3) at 256²
   b8 and 512² b4,
   then the end-to-end ``train --domain fft`` step (3-pair net, 256² b8)
   with each;
2. burst bodies — the correlation-space and the ω-space body, one
   100-iteration burst per frame size.

Times are host-clock milliseconds of warm calls ending in
``block_until_ready`` (median of ``--reps``; compilation excluded).  Prints
one JSON object per measurement and the card's name and power limit.

    python scripts/gpu_routing.py [--reps 20] [--sizes 256 512 1024 2048]
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke as cs  # noqa: E402
from spectralae.core import backend  # noqa: E402
from spectralae.core.runtime import enable_compilation_cache  # noqa: E402
from spectralae.core.types import init_opt_state  # noqa: E402
from spectralae.ops import dft, spectral  # noqa: E402
from spectralae.train.modern import train_step  # noqa: E402

IMPLS = {
    "einsum": lambda X, C, b, n: spectral.spectral_conv_einsum(X, C, b, n, n),
    "split": lambda X, C, b, n: spectral.spectral_conv_split(X, C, b, n, n),
}


def conv_contenders(reps, shapes=((256, 8), (512, 4)), step_nx=256):
    rng = np.random.default_rng(0)
    for nx, bsz in shapes:
        x = jnp.asarray(rng.normal(size=(bsz, 3, nx, nx)).astype(np.float32))
        ck = jnp.asarray(rng.normal(size=(10, 3, 5, 5)).astype(np.float32))
        bb = jnp.asarray(rng.normal(size=(10,)).astype(np.float32))
        X = jnp.fft.rfft2(x)
        C = dft.kernel_spectrum(ck, nx, nx)
        want = None
        for name, fn in IMPLS.items():
            def loss(X_, C_, b_, fn=fn):
                return jnp.sum(jnp.abs(fn(X_, C_, b_, nx)) ** 2)
            fwd = jax.jit(lambda X_, C_, b_, fn=fn: fn(X_, C_, b_, nx))
            vjp = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2)))
            out = fwd(X, C, bb)
            want = out if want is None else want
            rec = {"what": "spectral_conv", "impl": name, "nx": nx,
                   "batch": bsz,
                   "fwd_ms": 1e3 * cs.time_per_call(
                       lambda: fwd(X, C, bb), reps),
                   "fwd_vjp_ms": 1e3 * cs.time_per_call(
                       lambda: vjp(X, C, bb), reps),
                   "norm_rel_vs_einsum": cs.rel(out, want)}
            print(json.dumps(rec), flush=True)
    # end to end: the batched autodiff step, routed through each impl
    spec, params = cs.flagship(step_nx, 3)
    opt = init_opt_state(params)
    xb = jnp.asarray(rng.uniform(0, 255, size=(8, 3, step_nx, step_nx)
                                 ).astype(np.float32))
    saved = backend.spectral_conv_impl
    try:
        for name in IMPLS:
            backend.spectral_conv_impl = lambda *a, name=name, **k: name
            jax.clear_caches()
            step = lambda: train_step(params, opt, xb, spec.scales, lr=0.2,
                                      domain="fft")
            ms = 1e3 * cs.time_per_call(step, reps)
            print(json.dumps({"what": "train_step_fft", "impl": name,
                              "nx": step_nx, "batch": 8, "pairs": 3,
                              "ms_per_step": ms,
                              "loss": float(step().loss)}), flush=True)
    finally:
        backend.spectral_conv_impl = saved
        jax.clear_caches()


def burst_bodies(sizes, reps):
    for nx in sizes:
        x, out0, enc, dec = cs.burst_pair(nx)
        bodies = cs._bodies(x, out0, enc, dec, 100)
        rec = {"what": "burst_100", "nx": nx}
        for name in ("corr", "omega"):
            rec[f"{name}_ms"] = 1e3 * cs.time_per_call(bodies[name], reps)
        print(json.dumps(rec), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sizes", type=int, nargs="+",
                    default=[256, 512, 1024, 2048])
    args = ap.parse_args()
    if jax.default_backend() != "gpu":
        raise SystemExit(f"measures the GPU; backend is "
                         f"{jax.default_backend()!r}")
    enable_compilation_cache()
    print("nvidia-smi name, power.limit:", cs.gpu_name_and_power_limit(),
          flush=True)
    conv_contenders(args.reps)
    burst_bodies(args.sizes, max(3, args.reps // 4))


if __name__ == "__main__":
    main()
