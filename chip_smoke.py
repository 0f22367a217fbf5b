"""Run spectralae's main path once on one NVIDIA GPU and check every result.

    python chip_smoke.py          # phases 0-5 on one card
    python chip_smoke.py --four   # only the multi-card path, on four cards

Phases, all at the reference net's full width (256×256×3 frames, M=10,
5×5 kernels, pooling 2, three stage pairs; weights random from a seed):

0. preamble — the card (``nvidia-smi``), JAX, the backend; no GPU, no run;
1. forward — ``forward_fft``/``forward_coord`` at batch 4 vs the numpy
   oracle (tests/oracle.py) on one frame;
2. burst bodies — the correlation-space and the ω-space body, 100
   iterations on one 256² frame, vs the plain f32 reference burst; their
   times per burst; and the same once at default matmul precision;
3. CLI — ``spectralae train`` (burst, stream, fft and coord steps) and
   ``spectralae run`` in-process, plus the streaming scan vs sequential
   fused bursts;
4. large frame — a fused-anchor burst at 2048² vs the ω-space reference,
   with the compiled burst's memory analysis;
5. serving — a CUDA export of the forward served over HTTP in-process.

``--four`` runs the data-parallel burst, the DP/TP train step and the DP
streaming scan over four cards against one card.  Every comparison runs
under ``jax.default_matmul_precision("highest")``.  A phase that fails is
reported and the script exits non-zero without the final line; the final
line, printed only when every phase passed, is one JSON object
``{"ok": true, "device": {"platform", "kind", "count"}}``.  Times are
host-clock seconds; each says whether it includes compilation.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))   # the numpy oracle

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import oracle  # noqa: E402
from spectralae.cli.main import gpu_name_and_power_limit  # noqa: E402
from spectralae.core.config import Config, LayerParams  # noqa: E402
from spectralae.core.runtime import enable_compilation_cache  # noqa: E402
from spectralae.core.types import init_params, initial_spec  # noqa: E402
from spectralae.model import autoencoder as model  # noqa: E402
from spectralae.train.fft import fft_burst  # noqa: E402
from spectralae.train.fft_corr import (_true_forward,  # noqa: E402
                                       fft_burst_corr)

FLAGSHIP = LayerParams(depth=10, lk=1, ll=1, scale=2, rmax=3.0)
HIGHEST = "highest"


def log(*a):
    print(*a, flush=True)


def rel(a, b) -> float:
    """Norm-relative error ‖a−b‖/‖b‖ (elementwise-relative inflates
    near-zero entries)."""
    a = np.asarray(a, np.float64) if not np.iscomplexobj(a) else np.asarray(a)
    b = np.asarray(b, np.float64) if not np.iscomplexobj(b) else np.asarray(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def flagship(nx: int, pairs: int = 3, seed: int = 0):
    """(spec, params) of the reference net at ``nx``² with ``pairs``
    stage pairs."""
    cfg = Config(nx=nx, ny=nx, d=3, layer=FLAGSHIP)
    spec = initial_spec(cfg)
    for _ in range(pairs - 1):
        spec = spec.add_pair(FLAGSHIP)
    return spec, init_params(jax.random.key(seed), spec, FLAGSHIP.rmax)


def burst_pair(nx: int, seed: int = 0, batch: int | None = None):
    """One frozen-input burst problem at the reference width: pair 0 of
    an unpooled net (the burst trains a pair on its pooled input), input
    ~N(0, 50²), anchor = the model's own forward.  Returns
    (x, out0, enc, dec)."""
    cfg = Config(nx=nx, ny=nx, d=3,
                 layer=LayerParams(depth=10, lk=1, ll=1, scale=1, rmax=0.5))
    spec = initial_spec(cfg)
    params = init_params(jax.random.key(seed), spec, 0.5)
    shape = (3, nx, nx) if batch is None else (batch, 3, nx, nx)
    x = jnp.asarray(np.random.default_rng(seed).normal(
        size=shape).astype(np.float32) * 50)
    out0 = jax.jit(lambda p, v: model.forward_fft(p, v, spec.scales))(
        params, x if batch else x[None])
    enc, dec = params.pair(0)
    return x, (out0 if batch else out0[0]), enc, dec


def burst_close(got, ref) -> dict:
    """The CPU suite's bounds for burst bodies (tests/test_fft_corr.py):
    MSE trajectory rtol 5e-3, kernels and biases rtol 1e-3 / atol 1e-4
    (allclose semantics).  Returns each field's worst |a−b|/(atol+rtol|b|)
    — ≤ 1 passes — and its norm-relative error."""
    out = {}
    for name, rtol in (("mses", 5e-3), ("c", 1e-3), ("f", 1e-3),
                       ("b", 1e-3), ("p", 1e-3)):
        a = np.asarray(getattr(got, name), np.float64)
        b = np.asarray(getattr(ref, name), np.float64)
        viol = float(np.max(np.abs(a - b) / (1e-4 + rtol * np.abs(b))))
        out[name] = {"worst_over_bound": viol, "norm_rel": rel(a, b)}
    return out


def burst_ok(report: dict) -> bool:
    return all(v["worst_over_bound"] <= 1.0 for v in report.values())


def time_per_call(fn, reps: int = 10) -> float:
    """Median host-clock seconds of a warm ``fn()`` ending in
    ``block_until_ready`` (compilation excluded)."""
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


# --------------------------------------------------------------- phases

def phase_forward(nx=256, batch=4, pairs=3, seed=0) -> dict:
    """forward_fft and forward_coord of the flagship net vs the oracle on
    frame 0 (norm-relative ≤ 1e-5)."""
    spec, params = flagship(nx, pairs, seed)
    x = jnp.asarray(np.random.default_rng(seed).uniform(
        0, 255, size=(batch, 3, nx, nx)).astype(np.float32))
    t0 = time.perf_counter()
    with jax.default_matmul_precision(HIGHEST):
        y_fft = jax.jit(lambda p, v: model.forward_fft(p, v, spec.scales))(
            params, x)
        y_crd = jax.jit(lambda p, v: model.forward_coord(
            p, v, spec.scales)[-1])(params, x)
        jax.block_until_ready((y_fft, y_crd))
    wall = time.perf_counter() - t0
    stages = [(np.asarray(s.c, np.float64), np.asarray(s.b, np.float64))
              for s in params.stages]
    x0 = np.asarray(x[0], np.float64)
    want_fft = oracle.forward_fft_ref(stages, x0, spec.scales)
    want_crd = oracle.forward_coord_ref(stages, x0, spec.scales)
    res = {"shape": list(y_fft.shape),
           "fft_norm_rel": rel(y_fft[0], want_fft),
           "coord_norm_rel": rel(y_crd[0], want_crd),
           "finite": bool(np.isfinite(np.asarray(y_fft)).all()
                          and np.isfinite(np.asarray(y_crd)).all()),
           "wall_s_incl_compile": wall}
    res["ok"] = (res["finite"] and tuple(y_fft.shape) == x.shape
                 and tuple(y_crd.shape) == x.shape
                 and res["fft_norm_rel"] <= 1e-5
                 and res["coord_norm_rel"] <= 1e-5)
    return res


def _bodies(x, out0, enc, dec, iters):
    kw = dict(lr=0.2, iters=iters)
    args = (enc.c, dec.c, enc.b, dec.b)
    return {
        "ref": lambda: fft_burst(x, x, out0, *args, impl="fft", **kw),
        "corr": lambda: fft_burst_corr(x, None, out0, *args, **kw),
        "omega": lambda: fft_burst(x, x, out0, *args, impl="dft", **kw),
    }


def phase_bursts(nx=256, iters=100, reps=10, seed=0) -> dict:
    """Both burst bodies vs the plain f32 reference burst, their times per
    burst (the routing measurement), and the default-precision finding."""
    x, out0, enc, dec = burst_pair(nx, seed)
    res = {}
    with jax.default_matmul_precision(HIGHEST):
        bodies = _bodies(x, out0, enc, dec, iters)
        t0 = time.perf_counter()
        out = {k: fn() for k, fn in bodies.items()}
        jax.block_until_ready(out)
        res["wall_s_incl_compile"] = time.perf_counter() - t0
        for k in ("corr", "omega"):
            res[k] = burst_close(out[k], out["ref"])
        res["ms_per_burst"] = {k: 1e3 * time_per_call(fn, reps)
                               for k, fn in bodies.items()}
    m = np.asarray(out["ref"].mses)
    res["ref_mse_first_last"] = [float(m[0]), float(m[-1])]
    res["ok"] = bool(burst_ok(res["corr"]) and burst_ok(res["omega"])
                     and np.isfinite(m).all() and m[-1] < m[0])
    # finding, not a criterion: the same bodies at default matmul
    # precision (every package dot pins HIGHEST, so any difference is an
    # unpinned op), and what an unpinned f32 matmul of the same data loses
    dflt = {k: fn() for k, fn in _bodies(x, out0, enc, dec, iters).items()}
    res["default_precision"] = {
        k: {f: burst_close(dflt[k], out["ref"])[f]["norm_rel"]
            for f in ("mses", "c")} for k in ("corr", "omega", "ref")}
    a = jnp.asarray(np.random.default_rng(1).normal(
        size=(3 * 10 * 5, nx)).astype(np.float32))
    b = jnp.asarray(np.random.default_rng(2).normal(
        size=(nx, nx // 2 + 1)).astype(np.float32))
    hi = jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)
    lo = jnp.matmul(a, b, precision=jax.lax.Precision.DEFAULT)
    res["default_precision"]["unpinned_f32_matmul_norm_rel"] = rel(lo, hi)
    return res


def _run_cli(argv) -> tuple[str, float]:
    from spectralae.cli.main import main
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue(), time.perf_counter() - t0


def _finite_numbers(text: str) -> tuple[int, bool]:
    """Count the JSON metric records (and the engine's ``mse:`` values)
    in a CLI transcript; True when every number in them is finite."""
    nums, n = [], 0
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("{"):
            rec = json.loads(line)
            n += 1
            for v in rec.values():
                vs = v if isinstance(v, list) else [v]
                nums += [float(u) for u in vs
                         if isinstance(u, (int, float))]
        for mm in re.finditer(r"mse: (\S+)", line):
            n += 1
            nums.append(float(mm.group(1)))
    return n, bool(np.isfinite(nums).all())


def phase_cli(nx=256, layers=3, steps=2, batch=2, stream_k=8, iters=100,
              seed=0) -> dict:
    """The CLI trainers and the interactive engine, in-process, plus the
    streaming scan vs sequential fused bursts (norm-relative ≤ 1e-3)."""
    common = ["--nx", str(nx), "--layers", str(layers), "--seed", str(seed)]
    train = ["train", *common, "--batch", str(batch), "--log-every", "1",
             "--iters", str(iters)]
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        runs = {
            "train_burst": [*train, "--steps", str(steps),
                            "--mode", "burst"],
            "train_stream": [*train, "--steps", str(stream_k),
                             "--mode", "stream", "--stream-k", str(stream_k)],
            "train_fft_step": [*train, "--steps", str(steps),
                               "--domain", "fft"],
            "train_coord_step": [*train, "--steps", str(steps),
                                 "--domain", "coord"],
            "run": ["run", *common, "--frames", "4", "--keys", "1",
                    "--outdir", str(Path(tmp) / "views")],
        }
        for name, argv in runs.items():
            out, wall = _run_cli(argv)
            n, finite = _finite_numbers(out)
            res[name] = {"records": n, "finite": finite,
                         "wall_s_incl_compile": wall}
    # the streaming scan vs sequential fused bursts
    from spectralae.train.streaming import fft_stream
    x4 = jnp.asarray(np.random.default_rng(seed).normal(
        size=(4, 3, nx, nx)).astype(np.float32) * 50)
    _, _, enc, dec = burst_pair(nx, seed)
    with jax.default_matmul_precision(HIGHEST):
        r_st = fft_stream(x4, enc.c, dec.c, enc.b, dec.b, iters=5)
        cc, ff, bb, pp, mo = enc.c, dec.c, enc.b, dec.b, None
        for k in range(x4.shape[0]):
            r = fft_burst_corr(x4[k], None, None, cc, ff, bb, pp, mo,
                               lr=0.2, iters=5)
            cc, ff, bb, pp, mo = r.c, r.f, r.b, r.p, r.mom
    res["stream_vs_sequential_norm_rel"] = max(rel(r_st.c, cc),
                                               rel(r_st.f, ff))
    res["ok"] = (all(v["records"] > 0 and v["finite"]
                     for k, v in res.items() if isinstance(v, dict))
                 and res["stream_vs_sequential_norm_rel"] <= 1e-3)
    return res


def phase_large(nx=2048, iters=5, seed=0) -> dict:
    """Fused-anchor burst (out0=None) vs the ω-space reference anchored on
    the model's own forward; the burst's compiled memory analysis."""
    x, _, enc, dec = burst_pair(nx, seed)
    args = (enc.c, dec.c, enc.b, dec.b)
    res = {}
    with jax.default_matmul_precision(HIGHEST):
        t0 = time.perf_counter()
        got = fft_burst_corr(x, None, None, *args, lr=0.2, iters=iters)
        jax.block_until_ready(got)
        res["wall_s_incl_compile"] = time.perf_counter() - t0
        out0 = jax.jit(_true_forward, static_argnums=5)(
            x[None], *args, True)[0]
        ref = fft_burst(x, x, out0, *args, lr=0.2, iters=iters, impl="fft")
        res["vs_omega_reference"] = burst_close(got, ref)
        res["ms_per_burst"] = 1e3 * time_per_call(
            lambda: fft_burst_corr(x, None, None, *args, lr=0.2,
                                   iters=iters), 5)
        ma = fft_burst_corr.lower(x, None, None, *args, lr=0.2,
                                  iters=iters).compile().memory_analysis()
    res["memory_analysis"] = {
        k: getattr(ma, k) for k in ("argument_size_in_bytes",
                                    "output_size_in_bytes",
                                    "temp_size_in_bytes",
                                    "generated_code_size_in_bytes",
                                    "peak_memory_in_bytes")
        if hasattr(ma, k)} if ma is not None else None
    res["ok"] = burst_ok(res["vs_omega_reference"])
    return res


def phase_serve(nx=256, layers=3, batch=2, requests=3, seed=0,
                platform="cuda") -> dict:
    """``spectralae export --platforms`` of the forward (batch-polymorphic),
    loaded with ``ServingModel.load`` and served over HTTP (io/server.py)
    in this process; three POST /infer requests from a client thread vs an
    in-process forward_fft (≤ 1e-5)."""
    import urllib.request

    from spectralae.cli.main import _make_engine
    from spectralae.io.export import ServingModel
    from spectralae.io.server import InferenceServer

    args = argparse.Namespace(nx=nx, ny=None, depth=3, seed=seed,
                              param_file=None, layers=layers)
    eng = _make_engine(args)
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        art = str(Path(tmp) / "art")
        _run_cli(["export", "--nx", str(nx), "--layers", str(layers),
                  "--seed", str(seed), "--out", art, "--platforms", platform])
        served = ServingModel.load(art)
        res["export_wall_s_incl_compile"] = time.perf_counter() - t0
        res["platforms"] = served.manifest["platforms"]
        res["batch"] = served.manifest["batch"]
        srv = InferenceServer(served, port=0, warmup=True)
        srv.start()
        xs = [np.random.default_rng(seed + i).uniform(
            0, 255, size=(batch, 3, nx, nx)).astype(np.float32)
            for i in range(requests)]
        outs, errors = [None] * requests, []

        def client():
            try:
                for i, x in enumerate(xs):
                    buf = io.BytesIO()
                    np.save(buf, x)
                    req = urllib.request.Request(
                        f"http://127.0.0.1:{srv.port}/infer",
                        data=buf.getvalue(), method="POST")
                    with urllib.request.urlopen(req, timeout=600) as r:
                        outs[i] = np.load(io.BytesIO(r.read()),
                                          allow_pickle=False)
            except Exception as e:      # reported through `errors`
                errors.append(repr(e))

        t0 = time.perf_counter()
        th = threading.Thread(target=client)
        th.start()
        th.join()
        res["requests_wall_s_incl_compile"] = time.perf_counter() - t0
        srv.shutdown()
    if errors:
        raise RuntimeError(f"client failed: {errors}")
    fwd = jax.jit(lambda p, v: model.forward_fft(p, v, eng.spec.scales))
    with jax.default_matmul_precision(HIGHEST):
        res["norm_rel"] = [rel(o, fwd(eng.params, jnp.asarray(x)))
                           for o, x in zip(outs, xs)]
    res["ok"] = (res["batch"] is None
                 and all(o.shape == x.shape for o, x in zip(outs, xs))
                 and max(res["norm_rel"]) <= 1e-5)
    return res


def phase_four(nx=256, batch=8, iters=100, frames=4, devices=None,
               seed=0) -> dict:
    """The multi-device path vs one device (norm-relative ≤ 1e-4, the
    pmean reorders the sums): the DP burst on a 4×1 mesh, the
    distributed train step on 4×1 and 2×2 meshes, the DP streaming scan."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from spectralae.core.types import init_opt_state
    from spectralae.dist import mesh as dist
    from spectralae.train.fft_dp import distributed_burst, fft_burst_dp
    from spectralae.train.modern import train_step
    from spectralae.train.streaming import StreamResult, stream_bursts

    devices = list(devices or jax.devices()[:4])
    if len(devices) != 4:
        raise RuntimeError(f"--four needs 4 devices, found {len(devices)}")
    res = {"devices": len(devices)}
    errs = []
    with jax.default_matmul_precision(HIGHEST):
        # DP burst, batch over a 4×1 mesh
        m41 = dist.make_mesh(n_data=4, n_model=1, devices=devices)
        x, out0, enc, dec = burst_pair(nx, seed, batch=batch)
        args = (enc.c, dec.c, enc.b, dec.b)
        one = fft_burst_dp(x, None, out0, *args, lr=0.2, iters=iters,
                           body="corr")
        run = distributed_burst(m41, lr=0.2, iters=iters)
        got = run(dist.shard_batch(np.asarray(x), m41), None,
                  dist.shard_batch(np.asarray(out0), m41), *args)
        res["dp_burst_4x1"] = max(rel(getattr(got, f), getattr(one, f))
                                  for f in ("mses", "c", "f", "b", "p"))
        errs.append(res["dp_burst_4x1"])
        # distributed train step (fft domain) on 4×1 and 2×2
        spec, params = flagship(nx, 3, seed)
        opt = init_opt_state(params)
        xb = jnp.asarray(np.random.default_rng(seed).uniform(
            0, 255, size=(batch, 3, nx, nx)).astype(np.float32))
        ref = train_step(params, opt, xb, spec.scales, lr=0.2, domain="fft")
        for n_data, n_model in ((4, 1), (2, 2)):
            m = dist.make_mesh(n_data=n_data, n_model=n_model,
                               devices=devices)
            step = dist.distributed_train_step(m)
            r = step(dist.shard_params(params, m),
                     dist.shard_opt_state(opt, params, m),
                     dist.shard_batch(np.asarray(xb), m), spec.scales,
                     lr=0.2, domain="fft")
            e = max([rel(r.loss, ref.loss)]
                    + [rel(a, b) for a, b in zip(jax.tree.leaves(r.params),
                                                 jax.tree.leaves(ref.params))])
            res[f"train_step_{n_data}x{n_model}"] = e
            errs.append(e)
        # DP streaming scan: frames × batch, batch over 'data'
        xs = jnp.asarray(np.random.default_rng(seed + 1).normal(
            size=(frames, batch, 3, nx, nx)).astype(np.float32) * 50)
        one_s = jax.jit(lambda v, *a: stream_bursts(v, *a, iters=iters))(
            xs, *args)
        sharded = shard_map(
            lambda v, c, f, b, p: stream_bursts(v, c, f, b, p, iters=iters,
                                                axis_name="data"),
            mesh=m41, in_specs=(P(None, "data"), P(), P(), P(), P()),
            out_specs=StreamResult(c=P(), f=P(), b=P(), p=P(),
                                   mom=(P(), P(), P(), P()), mses=P()),
            check_vma=False)
        got_s = jax.jit(sharded)(xs, *args)
        res["dp_stream_4x1"] = max(rel(getattr(got_s, f), getattr(one_s, f))
                                   for f in ("mses", "c", "f", "b", "p"))
        errs.append(res["dp_stream_4x1"])
    res["ok"] = max(errs) <= 1e-4
    return res


# ---------------------------------------------------------------- driver

def device_record() -> dict:
    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d)}


def ok_line(device: dict) -> str:
    return json.dumps({"ok": True, "device": device})


def preamble() -> str | None:
    """Print the card, JAX and the backend; return the nvidia-smi line."""
    smi = gpu_name_and_power_limit()
    log(f"nvidia-smi name, power.limit: {smi}")
    log(f"jax {jax.__version__}; default_backend {jax.default_backend()}; "
        f"device_kind {jax.devices()[0].device_kind}; "
        f"device_count {len(jax.devices())}")
    return smi


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card path and its one-card "
                         "comparisons")
    args = ap.parse_args(argv)
    smi = preamble()
    if jax.default_backend() != "gpu":
        log(f"FAIL: JAX finds no GPU (backend {jax.default_backend()!r})")
        return 2
    enable_compilation_cache()
    if args.four:
        phases = {"four": phase_four}
    else:
        phases = {"forward": phase_forward, "bursts": phase_bursts,
                  "cli": phase_cli, "large": phase_large,
                  "serve": phase_serve}
    failed = []
    for name, fn in phases.items():
        t0 = time.perf_counter()
        try:
            res = fn()
        except Exception:
            res = {"ok": False, "error": traceback.format_exc()[-3000:]}
        res["phase_wall_s_incl_compile"] = time.perf_counter() - t0
        log(f"phase {name}: " + json.dumps(res, default=str))
        if not res.get("ok"):
            failed.append(name)
    log(f"nvidia-smi name, power.limit: {smi}")
    if failed:
        log(f"FAILED phases: {failed}")
        return 1
    log(ok_line(device_record()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
