"""Benchmark harness: prints ONE JSON line with the headline metric.

Headline: momentum-space (FFT) backprop inner-iterations/sec at 256×256,
M=10, D=3, 5×5 kernels — the reference's hot training loop
(source/fft_backproplib.cu:1446: 100 iterations per keypress).

``vs_baseline``: the reference publishes no numbers.  The denominator is a
documented *estimate* of the reference GPU's inner-loop rate: each
iteration runs a gradient kernel over M·D·256·129 bins, four full-size
cuFFT execs, two conv kernels, a Thrust reduce with device→host sync, and
a console print, on an sm_50-class part — ≈100 it/s is a generous
estimate (≥10 ms/iter).

Runs on an NVIDIA GPU and fails elsewhere.  Timing: each timed call's
input is a function of the previous call's output (a dependent chain), the
chain ends in ``block_until_ready``, and the host-clock time is divided by
the chain length.  Each row keeps the best and the median of several
chains; the headline row is re-measured in several windows spread across
the run and reported as the median of the window bests.

Utilization: every row carries a roofline entry (``util[...]`` keys) —
FLOPs and bytes from XLA's cost analysis of the compiled program
(spectralae/core/roofline.py) against the device's published peaks,
keyed by ``device_kind``.

Tiers: the default run includes the large-frame bursts, the all-pairs
sweep, coord/DP streaming, M=50 and 13×13.  ``--quick`` keeps only the
headline windows and the small-config rows.

Extended results go to bench_details.json (written incrementally, so a
late-row failure cannot lose the completed rows).
"""

import argparse
import json
import platform
import sys
import time
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from spectralae.core.runtime import enable_compilation_cache

enable_compilation_cache()

from spectralae.core import roofline
from spectralae.core.config import Config, LayerParams
from spectralae.core.types import initial_spec, init_params, init_opt_state
from spectralae.model import autoencoder as model
from spectralae.train.fft import fft_burst
from spectralae.train.fft_corr import fft_burst_corr
from spectralae.train.coord import coord_step
from spectralae.train.modern import train_step

REFERENCE_FFT_ITERS_PER_SEC_ESTIMATE = 100.0

PEAKS: roofline.Peaks | None = None     # set by main() from the device


class Timing(NamedTuple):
    best: float     # fastest of the trial chains, seconds per call
    median: float   # median trial, seconds per call


def time_chained(step, x0, n=20, warmup=1, trials=5) -> Timing:
    """Seconds/call for ``step(x) -> (result, next_x)`` chains of length n.

    The chain's data dependency forces sequential execution, and the final
    ``block_until_ready`` waits for every link.  Warmup calls (which
    compile) are off the clock."""
    x = x0
    for _ in range(warmup):
        r, x = step(x)
    jax.block_until_ready(x)
    samples = []
    for _ in range(trials):
        x = x0
        t0 = time.perf_counter()
        for _ in range(n):
            r, x = step(x)
        jax.block_until_ready(x)
        samples.append((time.perf_counter() - t0) / n)
    return Timing(best=min(samples), median=float(np.median(samples)))


class Bench:
    """Row recorder: timings + roofline utilization, flushed to
    bench_details.json after every row."""

    def __init__(self, path="bench_details.json"):
        self.results = {}
        self.path = path

    def flush(self):
        with open(self.path, "w") as f:
            json.dump(self.results, f, indent=2)

    def record(self, timing: Timing, ms_key: str, rate_key: str | None = None,
               rate_num: float = 1.0, cost=None, analytic_bytes=None):
        """Persist a timing row (best-chain basis) with its roofline entry.

        ``cost``: optional (flops, bytes) for util[ms_key];
        ``analytic_bytes``: an analytic byte bound (roofline.*_bytes),
        reported beside XLA's bytes-accessed, which overcounts fused
        handovers.  Returns the basis seconds."""
        results = self.results
        basis = timing.best
        results[ms_key] = basis * 1e3
        results[ms_key + ":median"] = timing.median * 1e3
        if rate_key:
            results[rate_key] = rate_num / basis
        if cost is not None and (cost[0] is not None or cost[1] is not None):
            util = roofline.utilization(cost[0], cost[1], basis, PEAKS)
            if analytic_bytes is not None:
                util["analytic_gb"] = round(analytic_bytes / 1e9, 3)
                util["pct_peak_bw_analytic"] = round(
                    100.0 * analytic_bytes / basis / PEAKS.hbm, 2)
            results[f"util[{ms_key}]"] = util
        self.flush()
        return basis

    def fail(self, key: str, err: Exception):
        """A row whose program could not compile/run on this device —
        record the failure reason instead of silently skipping."""
        msg = f"{type(err).__name__}: {err}"
        self.results[key] = None
        self.results[key + ":error"] = msg[:400]
        print(f"# FAILED {key}: {msg[:200]}", file=sys.stderr)
        self.flush()


def _versions():
    import jaxlib
    v = {"python": platform.python_version(),
         "jax": jax.__version__, "jaxlib": jaxlib.__version__,
         "numpy": np.__version__}
    from importlib import metadata
    for dist in ("jax-cuda12-plugin", "jax-cuda12-pjrt",
                 "jax-cuda13-plugin", "jax-cuda13-pjrt"):
        try:
            v[dist] = metadata.version(dist)
        except metadata.PackageNotFoundError:
            pass
    try:
        import optax
        v["optax"] = optax.__version__
    except ImportError:
        pass
    return v


def scaled(cost, k):
    """Scale a scan-over-frames row's cost by the trip count (XLA costs
    while bodies once; see roofline.compiled_cost)."""
    fl, by = cost
    return (fl * k if fl is not None else None,
            by * k if by is not None else None)


def burst_cost(x, out0, enc, dec, iters):
    """(flops, bytes) for an fft_burst_corr row: XLA cost analysis plus the
    inner fori_loop's per-iteration arithmetic (while bodies are costed
    once)."""
    fl, by = roofline.compiled_cost(
        fft_burst_corr, x, None, out0, enc.c, dec.c, enc.b, dec.b,
        lr=0.2, iters=iters)
    if fl is not None:
        M, D, nk, nl = enc.c.shape
        fl += roofline.corr_iter_flops(D, M, nk, nl, iters)
    return fl, by


def device_info() -> dict:
    """Platform, device kind and count as JAX reports them, and the card's
    name and power limit as ``nvidia-smi`` reports them."""
    from spectralae.cli.main import gpu_name_and_power_limit
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "nvidia_smi": gpu_name_and_power_limit()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="headline windows + small-config rows only "
                         "(skip the ≥2048² bursts / sweep / streaming tier)")
    args = ap.parse_args()

    if jax.default_backend() != "gpu":
        raise SystemExit(f"bench.py measures an NVIDIA GPU; JAX's backend "
                         f"is {jax.default_backend()!r}")
    global PEAKS
    PEAKS = roofline.device_peaks()

    bench = Bench()
    results = bench.results
    results["versions"] = _versions()
    results["device"] = device_info()
    results["peaks"] = PEAKS._asdict()

    rng = np.random.default_rng(0)
    cfg = Config(nx=256, ny=256, d=3,
                 layer=LayerParams(depth=10, lk=1, ll=1, scale=2, rmax=3.0))
    spec = initial_spec(cfg)
    spec3 = spec.add_pair(cfg.layer).add_pair(cfg.layer)
    params1 = init_params(jax.random.key(0), spec, 1.0)
    params3 = init_params(jax.random.key(0), spec3, 1.0)

    def frame(b=None):
        shape = (3, 256, 256) if b is None else (b, 3, 256, 256)
        return jax.device_put(rng.normal(size=shape).astype(np.float32) * 50)

    # ---- headline: FFT backprop burst at 256×256 (stage pair 0) ----
    enc, dec = params1.pair(0)
    fwd1 = jax.jit(lambda p, x: model.forward_fft(p, x, spec.scales))
    x0 = frame()
    out0 = fwd1(params1, x0[None])[0]
    burst_iters = 100

    impls = {
        "corr": lambda x: fft_burst_corr(
            x, None, out0, enc.c, dec.c, enc.b, dec.b, lr=0.2,
            iters=burst_iters),
        "dft": lambda x: fft_burst(
            x, x, out0, enc.c, dec.c, enc.b, dec.b, lr=0.2,
            iters=burst_iters, impl="dft"),
        "fft": lambda x: fft_burst(
            x, x, out0, enc.c, dec.c, enc.b, dec.b, lr=0.2,
            iters=burst_iters, impl="fft"),
    }
    headline_floor, headline_median = {}, {}

    # --- window 1: all implementations ---
    for impl, fn in impls.items():
        def burst_step(x, fn=fn):
            r = fn(x)
            return r, x + r.mses[-1] * 0.0 + 1e-6
        t = time_chained(burst_step, x0)
        cost = (burst_cost(x0, out0, enc, dec, burst_iters)
                if impl == "corr" else None)
        bench.record(t, f"fft_burst_100_ms[{impl}]",
                     f"fft_backprop_iters_per_sec_256[{impl}]",
                     burst_iters, cost=cost)
        results[f"fft_backprop_iters_per_sec_256_median[{impl}]"] = \
            burst_iters / t.median
        if impl in ("corr", "dft"):
            headline_floor[impl] = burst_iters / t.best
            headline_median[impl] = burst_iters / t.median
    best_impl = (max(headline_floor, key=headline_floor.get)
                 if headline_floor else None)
    windows_floor, windows_median = [], []
    if best_impl:
        windows_floor.append(headline_floor[best_impl])
        windows_median.append(headline_median[best_impl])

    def headline_window(tag):
        """Re-measure the fastest impl in a later, time-separated window."""
        if not best_impl:
            return
        def step(x, fn=impls[best_impl]):
            r = fn(x)
            return r, x + r.mses[-1] * 0.0 + 1e-6
        t = time_chained(step, x0)
        windows_floor.append(burst_iters / t.best)
        windows_median.append(burst_iters / t.median)
        results[f"headline_window[{tag}]"] = {
            "floor_iters_per_sec": burst_iters / t.best,
            "median_iters_per_sec": burst_iters / t.median}
        bench.flush()

    # ---- 400-iteration burst: amortizes the one-time correlation
    # precompute (the corr burst's per-iteration cost is resolution- and
    # batch-independent) ----
    def burst400(x):
        r = fft_burst_corr(x, None, out0, enc.c, dec.c, enc.b, dec.b,
                           lr=0.2, iters=400)
        return r, x + r.mses[-1] * 0.0 + 1e-6
    bench.record(time_chained(burst400, x0, n=10),
                 "fft_burst_400_ms[corr]",
                 "fft_backprop_iters_per_sec_256_x400", 400,
                 cost=burst_cost(x0, out0, enc, dec, 400))

    # ---- streaming: 32-frame × 100-iter on-device scan (one dispatch
    # per stream; per-frame fused re-anchoring — train/streaming.py) ----
    from spectralae.train.streaming import fft_stream
    xs32 = jax.device_put(
        rng.normal(size=(32, 3, 256, 256)).astype(np.float32) * 50)

    def stream_step(xs):
        r = fft_stream(xs, enc.c, dec.c, enc.b, dec.b, iters=100)
        return r, xs + r.mses[-1, -1] * 0.0 + 1e-6
    bench.record(time_chained(stream_step, xs32, n=3, trials=5),
                 "fft_stream_32x100_ms",
                 "fft_stream_iters_per_sec_sustained", 32 * 100,
                 cost=scaled(roofline.compiled_cost(
                     fft_stream, xs32, enc.c, dec.c, enc.b, dec.b,
                     iters=100), 32))

    # --- window 6 (interleaved: more windows tighten the median's IQR) ---
    headline_window("w6")

    # ---- headline at 512² and 1024² (scaling) ----
    for nxy, nlinks in ((512, 10), (1024, 8)):
        cfgB = Config(nx=nxy, ny=nxy, d=3,
                      layer=LayerParams(depth=10, lk=1, ll=1, scale=2,
                                        rmax=3.0))
        specB = initial_spec(cfgB)
        paramsB = init_params(jax.random.key(0), specB, 1.0)
        encB, decB = paramsB.pair(0)
        fwdB = jax.jit(lambda p, x, s=specB.scales:
                       model.forward_fft(p, x, s))
        xb0 = jax.device_put(
            rng.normal(size=(3, nxy, nxy)).astype(np.float32) * 50)
        outB = fwdB(paramsB, xb0[None])[0]

        def burst_big(x, o=outB, e=encB, d_=decB):
            r = fft_burst_corr(x, None, o, e.c, d_.c, e.b, d_.b, lr=0.2,
                               iters=burst_iters)
            return r, x + r.mses[-1] * 0.0 + 1e-6
        bench.record(time_chained(burst_big, xb0, n=nlinks),
                     f"fft_burst_100_ms_{nxy}",
                     f"fft_backprop_iters_per_sec_{nxy}", burst_iters,
                     cost=burst_cost(xb0, outB, encB, decB, burst_iters),
                     analytic_bytes=roofline.corr_burst_bytes(
                         1, 3, nxy, nxy))

    # --- window 2 ---
    headline_window("w2")

    # ---- ≥2048² fused-anchor bursts: 2048² (4.2 MP) / 4096² (16.8 MP) /
    # 8192² (67 MP), XLA's FFT and fusions throughout ----
    big_sizes = [2048] if args.quick else [2048, 4096, 8192]
    for nxy in big_sizes:
        cfgN = Config(nx=nxy, ny=nxy, d=3,
                      layer=LayerParams(depth=10, lk=1, ll=1, scale=2,
                                        rmax=3.0))
        paramsN = init_params(jax.random.key(0), initial_spec(cfgN), 1.0)
        encN, decN = paramsN.pair(0)
        key = f"fft_burst_100_ms_{nxy}"
        try:
            xN = jax.device_put(rng.standard_normal(
                size=(3, nxy, nxy), dtype=np.float32) * 50)

            def burst_n(x, e=encN, d_=decN):
                r = fft_burst_corr(x, None, None, e.c, d_.c, e.b, d_.b,
                                   lr=0.2, iters=burst_iters)
                return r, x + r.mses[-1] * 0.0 + 1e-6
            nlinks = {2048: 5, 4096: 3, 8192: 2}[nxy]
            timing = time_chained(burst_n, xN, n=nlinks,
                                  trials=3 if nxy > 2048 else 5)
            bench.record(timing,
                         key, f"fft_backprop_iters_per_sec_{nxy}",
                         burst_iters,
                         cost=burst_cost(xN, None, encN, decN, burst_iters))
            del xN
        except Exception as e:      # noqa: BLE001 — record the wall
            bench.fail(key, e)

    if not args.quick:
        cfg2b = Config(nx=2048, ny=2048, d=3,
                       layer=LayerParams(depth=10, lk=1, ll=1, scale=2,
                                         rmax=3.0))
        params2b = init_params(jax.random.key(0), initial_spec(cfg2b), 1.0)
        enc2b, dec2b = params2b.pair(0)

        # ---- streaming @2048²: 4-frame × 100-iter on-device scan of the
        # fused-anchor burst (weights+momentum carried) ----
        xs2k = jax.device_put(
            rng.normal(size=(4, 3, 2048, 2048)).astype(np.float32) * 50)

        def stream2k_step(xs, e=enc2b, d_=dec2b):
            r = fft_stream(xs, e.c, d_.c, e.b, d_.b, iters=100)
            return r, xs + r.mses[-1, -1] * 0.0 + 1e-6
        try:
            bench.record(time_chained(stream2k_step, xs2k, n=2, trials=3),
                         "fft_stream_2048_4x100_ms",
                         "fft_stream_2048_iters_per_sec_sustained", 4 * 100,
                         cost=scaled(roofline.compiled_cost(
                             fft_stream, xs2k, enc2b.c, dec2b.c, enc2b.b,
                             dec2b.b, iters=100), 4))
        except Exception as e:      # noqa: BLE001
            bench.fail("fft_stream_2048_4x100_ms", e)

        del xs2k

    # --- window 3: after the big-burst tier ---
    headline_window("w3")

    # ---- forward passes, 3-layer net, batch 1 ----
    fwd_fft3 = jax.jit(lambda x: model.forward_fft(params3, x, spec3.scales))

    def fwd_fft_step(x):
        out = fwd_fft3(x)
        return out, x + out * 1e-9
    x1 = frame(b=1)
    bench.record(time_chained(fwd_fft_step, x1),
                 "forward_fft_3layer_256_ms", "forward_fft_3layer_256_fps",
                 1.0, cost=roofline.compiled_cost(fwd_fft3, x1))

    fwd_coord3 = jax.jit(
        lambda x: model.forward_coord(params3, x, spec3.scales)[-1])

    def fwd_coord_step(x):
        out = fwd_coord3(x)
        return out, x + out * 1e-9
    bench.record(time_chained(fwd_coord_step, frame(b=1)),
                 "forward_coord_3layer_256_ms",
                 cost=roofline.compiled_cost(fwd_coord3, x1))

    # ---- coordinate-space reference train step (pair 0, full frame) ----
    acts = jax.jit(lambda x: model.forward_coord(
        params1, x, spec.scales, tap_mode="ref_gpu"))(x0[None])
    mom = tuple(jnp.zeros_like(t) for t in (enc.c, dec.c, enc.b, dec.b))
    hin = acts[2][0]
    outp = acts[-2][0]

    def cstep(in_s):
        r = coord_step(in_s, outp, hin, enc.c, dec.c, enc.b, dec.b,
                       mom, mom, lr=0.2)
        return r, in_s + r.mse * 0.0 + 1e-6
    xc = jax.device_put(
        rng.normal(size=(3, 128, 128)).astype(np.float32) * 50)
    bench.record(time_chained(cstep, xc),
                 "coord_step_128_ms", "coord_steps_per_sec", 1.0,
                 cost=roofline.compiled_cost(
                     coord_step, xc, outp, hin, enc.c, dec.c, enc.b,
                     dec.b, mom, mom, lr=0.2))

    # --- window 7 ---
    headline_window("w7")

    # ---- modern batched train step (3-layer, batch 8, fft domain) ----
    opt3 = init_opt_state(params3)

    def mstep(x):
        r = train_step(params3, opt3, x, spec3.scales, lr=0.2, domain="fft")
        return r, x + r.loss * 0.0 + 1e-6
    x8 = frame(b=8)
    bench.record(time_chained(mstep, x8, n=5),
                 "modern_fft_step_b8_ms", "modern_fft_frames_per_sec", 8.0,
                 cost=roofline.compiled_cost(
                     train_step, params3, opt3, x8, spec3.scales, lr=0.2,
                     domain="fft"),
                 analytic_bytes=roofline.fft_step_bytes(8, 3, 10, 256, 256,
                                                        pairs=3))

    # ---- data-parallel burst throughput (8 frames, one shared pair) ----
    from spectralae.train.fft_dp import fft_burst_dp

    def dp_step(x):
        r = fft_burst_dp(x, None, out8, enc.c, dec.c, enc.b, dec.b,
                         lr=0.2, iters=100)
        return r, x + r.mses[-1] * 0.0 + 1e-6
    out8 = fwd1(params1, x8)
    bench.record(time_chained(dp_step, x8, n=5),
                 "fft_burst_dp_b8_100_ms",
                 "fft_burst_dp_frame_iters_per_sec", 8 * 100,
                 cost=roofline.compiled_cost(
                     fft_burst_dp, x8, None, out8, enc.c, dec.c, enc.b,
                     dec.b, lr=0.2, iters=100))

    # ---- spectral-vs-coord conv speedup across kernel sizes ----
    # The reference's qualitative claim (README.md:5-6) quantified: one
    # M=10 conv layer at 256², coordinate (lax conv) vs momentum space
    # (rfft2 + pointwise complex conv + irfft2), batch 8.
    from spectralae.ops import coord as coord_ops
    from spectralae.ops import spectral as spectral_ops
    for lk in (1, 5, 15):   # 5×5, 13×13, 33×33 kernels
        nk = 2 * (lk + 1) + 1
        ck = jax.device_put(
            rng.normal(size=(10, 3, nk, nk)).astype(np.float32))
        bb = jax.device_put(rng.normal(size=(10,)).astype(np.float32))

        @jax.jit
        def conv_coord(x, ck=ck, bb=bb):
            return coord_ops.conv2d(x, ck, bb, tap_mode="centered")

        @jax.jit
        def conv_fftd(x, ck=ck, bb=bb):
            X = spectral_ops.rfft2(x)
            C = spectral_ops.kernel_rfft(ck, 256, 256)
            return spectral_ops.irfft2(
                spectral_ops.spectral_conv(X, C, bb, 256, 256), (256, 256))

        def step_c(x):
            out = conv_coord(x)
            return out, x + out[:, :3] * 1e-9

        def step_f(x):
            out = conv_fftd(x)
            return out, x + out[:, :3] * 1e-9
        tc = time_chained(step_c, frame(b=8), n=8)
        tf = time_chained(step_f, frame(b=8), n=8)
        ok_c = bench.record(tc, f"conv_coord_{nk}x{nk}_b8_ms",
                            cost=roofline.compiled_cost(conv_coord, x8))
        ok_f = bench.record(tf, f"conv_spectral_{nk}x{nk}_b8_ms",
                            cost=roofline.compiled_cost(conv_fftd, x8),
                            analytic_bytes=roofline.spectral_conv_bytes(
                                8, 3, 10, 256, 256))
        results[f"spectral_speedup_{nk}x{nk}"] = ok_c / ok_f
        bench.flush()


    # --- window 4 ---
    headline_window("w4")

    # ---- 512×512 deep config, batch 4 ----
    cfg512 = Config(nx=512, ny=512, d=3,
                    layer=LayerParams(depth=10, lk=1, ll=1, scale=2,
                                      rmax=3.0))
    spec512 = initial_spec(cfg512).add_pair(cfg512.layer).add_pair(
        cfg512.layer)
    params512 = init_params(jax.random.key(0), spec512, 1.0)
    opt512 = init_opt_state(params512)

    def mstep512(x):
        r = train_step(params512, opt512, x, spec512.scales, lr=0.2,
                       domain="fft")
        return r, x + r.loss * 0.0 + 1e-6
    x512 = jax.device_put(
        rng.normal(size=(4, 3, 512, 512)).astype(np.float32) * 50)
    bench.record(time_chained(mstep512, x512, n=5),
                 "modern_fft_step_512_b4_ms", "modern_fft_512_frames_per_sec",
                 4.0, cost=roofline.compiled_cost(
                     train_step, params512, opt512, x512, spec512.scales,
                     lr=0.2, domain="fft"),
                 analytic_bytes=roofline.fft_step_bytes(4, 3, 10, 512, 512,
                                                        pairs=3))

    # ---- 1024×1024 deep config, batch 2 (fused-conv scaling) ----
    cfg1k = Config(nx=1024, ny=1024, d=3,
                   layer=LayerParams(depth=10, lk=1, ll=1, scale=2,
                                     rmax=3.0))
    spec1k = initial_spec(cfg1k).add_pair(cfg1k.layer).add_pair(cfg1k.layer)
    params1k = init_params(jax.random.key(0), spec1k, 1.0)
    opt1k = init_opt_state(params1k)

    def mstep1k(x):
        r = train_step(params1k, opt1k, x, spec1k.scales, lr=0.2,
                       domain="fft")
        return r, x + r.loss * 0.0 + 1e-6
    x1k = jax.device_put(
        rng.normal(size=(2, 3, 1024, 1024)).astype(np.float32) * 50)
    bench.record(time_chained(mstep1k, x1k, n=5),
                 "modern_fft_step_1024_b2_ms", "modern_fft_1024_frames_per_sec",
                 2.0, cost=roofline.compiled_cost(
                     train_step, params1k, opt1k, x1k, spec1k.scales,
                     lr=0.2, domain="fft"),
                 analytic_bytes=roofline.fft_step_bytes(2, 3, 10, 1024, 1024,
                                                        pairs=3))

    # --- window 8 ---
    headline_window("w8")

    # =================== full tier ============
    if not args.quick:
        from spectralae.train.streaming import fft_stream_sweep, coord_stream

        # ---- per-frame all-pairs stream sweep, 3-pair net @256²
        # (K=8 frames, 100 iters per pair-burst; every pair trained on
        # every frame inside one scan — CLI `--train-pair all
        # --pair-sweep frame`) ----
        xs8 = jax.device_put(
            rng.normal(size=(8, 3, 256, 256)).astype(np.float32) * 50)

        def sweep_step(xs):
            r = fft_stream_sweep(xs, params3, spec3.scales, iters=100)
            return r, xs + r.mses[-1, -1, -1] * 0.0 + 1e-6
        bench.record(time_chained(sweep_step, xs8, n=3, trials=5),
                     "fft_sweep_8x3x100_ms",
                     "fft_sweep_iters_per_sec_sustained", 8 * 3 * 100,
                     cost=scaled(roofline.compiled_cost(
                         fft_stream_sweep, xs8, params3, spec3.scales,
                         iters=100), 8))

        # ---- coord-domain streaming: 32 frames × [full 256² forward +
        # coord step], q=2, pair 0, one scan ----
        def coord_stream_step(xs):
            r = coord_stream(xs, params1, spec.scales, 0, q=2)
            return r, xs + r.mses[-1] * 0.0 + 1e-6
        bench.record(time_chained(coord_stream_step, xs32, n=3, trials=5),
                     "coord_stream_32_ms", "coord_stream_steps_per_sec",
                     32.0, cost=scaled(roofline.compiled_cost(
                         coord_stream, xs32, params1, spec.scales, 0, q=2),
                         32))

        # ---- data-parallel burst at streaming scale: B=32 @256² and
        # B=8 @512² (the batch only enters the correlation precompute) ----
        out32 = fwd1(params1, xs32)

        def dp32_step(x):
            r = fft_burst_dp(x, None, out32, enc.c, dec.c, enc.b, dec.b,
                             lr=0.2, iters=100)
            return r, x + r.mses[-1] * 0.0 + 1e-6
        bench.record(time_chained(dp32_step, xs32, n=4, trials=5),
                     "fft_burst_dp_b32_100_ms",
                     "fft_burst_dp_b32_frame_iters_per_sec", 32 * 100,
                     cost=roofline.compiled_cost(
                         fft_burst_dp, xs32, None, out32, enc.c, dec.c,
                         enc.b, dec.b, lr=0.2, iters=100))

        cfg5 = Config(nx=512, ny=512, d=3,
                      layer=LayerParams(depth=10, lk=1, ll=1, scale=2,
                                        rmax=3.0))
        spec5 = initial_spec(cfg5)
        params5 = init_params(jax.random.key(0), spec5, 1.0)
        enc5, dec5 = params5.pair(0)
        x8_512 = jax.device_put(
            rng.normal(size=(8, 3, 512, 512)).astype(np.float32) * 50)
        fwd5 = jax.jit(lambda p, x: model.forward_fft(p, x, spec5.scales))
        out8_512 = fwd5(params5, x8_512)

        def dp512_step(x):
            r = fft_burst_dp(x, None, out8_512, enc5.c, dec5.c, enc5.b,
                             dec5.b, lr=0.2, iters=100)
            return r, x + r.mses[-1] * 0.0 + 1e-6
        bench.record(time_chained(dp512_step, x8_512, n=3, trials=5),
                     "fft_burst_dp_512_b8_100_ms",
                     "fft_burst_dp_512_b8_frame_iters_per_sec", 8 * 100,
                     cost=roofline.compiled_cost(
                         fft_burst_dp, x8_512, None, out8_512, enc5.c,
                         dec5.c, enc5.b, dec5.b, lr=0.2, iters=100))

        # --- window 9 ---
        headline_window("w9")

        # ---- M=50 (the reference source's default depth) @256² ----
        cfg50 = Config(nx=256, ny=256, d=3,
                       layer=LayerParams(depth=50, lk=1, ll=1, scale=2,
                                         rmax=3.0))
        spec50 = initial_spec(cfg50)
        params50 = init_params(jax.random.key(0), spec50, 1.0)
        enc50, dec50 = params50.pair(0)
        fwd50 = jax.jit(lambda p, x: model.forward_fft(p, x, spec50.scales))
        out50 = fwd50(params50, x0[None])[0]

        def burst50(x):
            r = fft_burst_corr(x, None, out50, enc50.c, dec50.c, enc50.b,
                               dec50.b, lr=0.2, iters=burst_iters)
            return r, x + r.mses[-1] * 0.0 + 1e-6
        bench.record(time_chained(burst50, x0, n=10),
                     "fft_burst_100_ms_m50",
                     "fft_backprop_iters_per_sec_256_m50", burst_iters,
                     cost=burst_cost(x0, out50, enc50, dec50, burst_iters))

        # ---- 13×13-kernel burst @256² (large-kernel coverage: the corr
        # burst's lag tensors grow as (4h+1)², netlib.cpp:325 tap
        # parameterization) ----
        cfg13 = Config(nx=256, ny=256, d=3,
                       layer=LayerParams(depth=10, lk=5, ll=5, scale=2,
                                         rmax=3.0))
        spec13 = initial_spec(cfg13)
        params13 = init_params(jax.random.key(0), spec13, 1.0)
        enc13, dec13 = params13.pair(0)
        fwd13 = jax.jit(lambda p, x: model.forward_fft(p, x, spec13.scales))
        out13 = fwd13(params13, x0[None])[0]

        def burst13_corr(x):
            r = fft_burst_corr(x, None, out13, enc13.c, dec13.c, enc13.b,
                               dec13.b, lr=0.2, iters=burst_iters)
            return r, x + r.mses[-1] * 0.0 + 1e-6

        bench.record(time_chained(burst13_corr, x0, n=8),
                     "fft_burst_100_ms_13x13[corr]",
                     "fft_backprop_iters_per_sec_256_13x13[corr]",
                     burst_iters,
                     cost=burst_cost(x0, out13, enc13, dec13, burst_iters))

    # --- window 5: end of run ---
    headline_window("w5")

    # headline = MEDIAN of the time-separated window bests; spread_pct is
    # the interquartile band of the window bests over that median
    fft_steps_per_sec = (float(np.median(windows_floor))
                         if windows_floor else None)
    fft_steps_per_sec_median = (float(np.median(windows_median))
                                if windows_median else None)
    spread_pct = range_pct = None
    if fft_steps_per_sec:
        q25, q75 = np.percentile(windows_floor, [25, 75])
        spread_pct = 100.0 * (q75 - q25) / fft_steps_per_sec
        range_pct = (100.0 * (max(windows_floor) - min(windows_floor))
                     / fft_steps_per_sec)
    results["headline_windows_floor"] = windows_floor
    results["headline_windows_median"] = windows_median
    results["headline_range_pct"] = range_pct
    results["headline_basis"] = (
        "median of the window bests from up to nine time-separated "
        "windows spread across the run, fastest impl; each window best = "
        "best of 5 chained trials ending in block_until_ready.  "
        "spread_pct = IQR/median of the window bests; range_pct = "
        "(max-min)/median.  Per-impl bests in *_ms keys, medians in "
        "*_ms:median and *_median keys; per-row roofline in util[...] keys")
    bench.flush()

    rnd = lambda v, n: round(v, n) if v is not None else None
    print(json.dumps({
        "metric": "fft_backprop_iters_per_sec_256",
        "device": results["device"],
        "value": rnd(fft_steps_per_sec, 1),
        "unit": "iters/s",
        "vs_baseline": rnd(
            fft_steps_per_sec / REFERENCE_FFT_ITERS_PER_SEC_ESTIMATE
            if fft_steps_per_sec is not None else None, 2),
        "median": rnd(fft_steps_per_sec_median, 1),
        "spread_pct": rnd(spread_pct, 1),
        "stream_sustained": (
            round(results["fft_stream_iters_per_sec_sustained"], 1)
            if results.get("fft_stream_iters_per_sec_sustained") else None),
    }))


if __name__ == "__main__":
    main()
