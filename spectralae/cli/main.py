"""Command-line interface: run / train / bench / info / export / serve.

The reference's interactive OpenCV app becomes:
  - ``spectralae run``    — the live loop on a frame source, with the 20
    keyboard commands read from stdin (works headless; views dumped as PNGs).
  - ``spectralae train``  — headless batched training (modern path) with
    checkpointing and JSONL metrics.
  - ``spectralae info``   — print the network structure ('i' key).
  - ``spectralae bench``  — the benchmark harness.
  - ``spectralae eval``   — reconstruction MSE/PSNR over a frame source.
  - ``spectralae export`` — AOT-compile a serving artifact (jax.export).
  - ``spectralae serve``  — run inference from an exported artifact
    (local loop or HTTP endpoint).
  - ``spectralae doctor`` — environment diagnostic.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def _add_common(p):
    p.add_argument("--nx", type=int, default=256)
    p.add_argument("--ny", type=int, default=None,
                   help="frame cols; defaults to --nx (square)")
    p.add_argument("--depth", type=int, default=3,
                   help="input channels (D)")
    p.add_argument("--param-file", type=str, default=None,
                   help="reference-format New_Layer_Param.txt")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--layers", type=int, default=1,
                   help="number of conv stage pairs")


def _make_engine(args):
    from ..core.config import Config
    from ..model.engine import Engine
    if args.ny is None:
        args.ny = args.nx
    cfg = Config(nx=args.nx, ny=args.ny, d=args.depth)
    eng = Engine(cfg, seed=args.seed, param_file=args.param_file)
    for _ in range(args.layers - 1):
        eng.add_layer()
    eng.select_layer(0)
    return eng


def _source(args):
    from ..data import pipeline
    if args.ny is None:
        args.ny = args.nx
    if args.source == "synthetic":
        return pipeline.synthetic_frames(args.nx, args.ny, seed=args.seed)
    if args.source == "camera":
        return pipeline.camera_frames()
    if args.source.endswith(".y4m"):
        return pipeline.y4m_video(args.source)
    if Path(args.source).is_dir():
        return pipeline.image_dir_frames(
            args.source, loop=True,
            channel_order=getattr(args, "png_order", "rgb"))
    if args.source.endswith((".npy", ".npz")):
        return pipeline.npy_video(args.source)
    # anything else: let OpenCV demux it (mp4/avi/mkv/...)
    return pipeline.video_file_frames(args.source, loop=True)


def _run_gui(eng, src, args):
    """Literal reference UX: four live OpenCV windows + waitKey dispatch
    (source/autoencoder.cpp:55-66 window setup, 211-246 imshow/waitKey).

    Headless-safe: exits with a clear message when no display/GUI backend
    is available (cv2.error on the first namedWindow).
    """
    from ..data import pipeline
    from ..model.engine import dispatch_key
    try:
        import cv2
    except ImportError as e:
        raise SystemExit(f"--gui requires OpenCV (cv2): {e}")
    # window name, position — the reference's exact layout
    windows = (("input", (100, 100)), ("output", (400, 100)),
               ("feature map", (100, 400)), ("kernel", (400, 400)))
    try:
        for name, (wx, wy) in windows:
            cv2.namedWindow(name, cv2.WINDOW_NORMAL)
            cv2.moveWindow(name, wx, wy)
            cv2.resizeWindow(name, 200, 200)
    except cv2.error as e:
        raise SystemExit(
            f"--gui needs a display (cv2 backend failed: {e}); use --tui "
            "or --dump-every for headless operation")
    view_to_window = {"input": "input", "output": "output",
                      "feature_map": "feature map", "kernel": "kernel"}
    try:
        for i in range(args.frames):
            frame = next(src)
            x = pipeline.frame_to_tensor(
                pipeline.resize_nn(frame, args.nx, args.ny))
            eng.step(x)
            if eng.last_mse is not None:
                print(f"frame {i}  mse: {eng.last_mse:.6g}", flush=True)
            views = eng.current_views()
            for vk, wname in view_to_window.items():
                img = views[vk]
                if img.ndim == 2:
                    img = img[:, :, None].repeat(3, axis=2)
                cv2.imshow(wname, img)
            # extra 'g'-mode views get their own windows, like the
            # reference's per-layer streams (fft_backproplib.cu:1344-1361)
            for vk, img in views.items():
                if vk not in view_to_window:
                    cv2.imshow(vk, img)
            ch = cv2.waitKey(10)
            # mask like the dispatch below — some GUI backends return the
            # keycode with modifier/high bits set (−1 = no key)
            if ch >= 0 and (ch & 0xFF) == 27:  # Esc (autoencoder.cpp:246)
                break
            if ch > 0:
                try:
                    r = dispatch_key(eng, chr(ch & 0xFF))
                    if r is not None:
                        print(f"key '{chr(ch & 0xFF)}' -> {r}", flush=True)
                except (OSError, ValueError) as e:
                    print(f"key failed: {e}", flush=True)
    finally:
        cv2.destroyAllWindows()


def cmd_run(args):
    from ..data import pipeline
    from ..model.engine import dispatch_key
    from ..viz.png import write_png
    eng = _make_engine(args)
    src = _source(args)
    if args.gui:
        return _run_gui(eng, src, args)
    if args.tui:
        from .tui import run_tui
        return run_tui(eng, src, nx=args.nx, ny=args.ny,
                       frames=args.frames or None)
    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    print("commands: same keys as the reference (1..9,0,f,g,q,w,m,z,x,e,c,"
          "p,s,l,n,d,i; Esc/Q quits); enter to step", flush=True)
    for i in range(args.frames):
        frame = next(src)
        x = pipeline.frame_to_tensor(pipeline.resize_nn(frame, args.nx, args.ny))
        t0 = time.perf_counter()
        eng.step(x)
        dt = time.perf_counter() - t0
        if eng.last_mse is not None:
            print(f"frame {i}: {dt*1e3:.1f} ms  mse: {eng.last_mse:.6g}",
                  flush=True)
        if args.dump_every and i % args.dump_every == 0:
            for name, img in eng.current_views().items():
                write_png(outdir / f"{name}_{i:05d}.png", img)
        def _dispatch(k):
            # a failed command (e.g. 'l' with no saved weights) reports and
            # keeps the loop alive, like the reference's interactive app
            try:
                r = dispatch_key(eng, k)
                print(f"key '{k}' -> {r}", flush=True)
            except (OSError, ValueError) as e:
                print(f"key '{k}' failed: {e}", flush=True)

        if args.keys and i < len(args.keys):
            _dispatch(args.keys[i])
        elif args.interactive:
            line = sys.stdin.readline().strip()
            if line in ("\x1b", "Q"):
                break
            for k in line:
                _dispatch(k)


_METRICS_LOGGERS: dict = {}


def _emit(rec: dict, metrics: Path | None) -> None:
    """One metrics record: JSON line to stdout + optional JSONL append —
    delegated to core.profiling.MetricsLogger (one open handle per file,
    not an open/close syscall pair per record)."""
    from ..core.profiling import MetricsLogger
    key = str(metrics) if metrics else None
    lg = _METRICS_LOGGERS.get(key)
    if lg is None:
        lg = _METRICS_LOGGERS[key] = MetricsLogger(metrics, echo=True)
    lg.log(**rec)


def _resume_or_engine(args):
    """Start params/spec/step for the burst/stream trainers: --resume
    restores them from a checkpoint (the net structure comes from the
    checkpoint, not the CLI flags); otherwise a fresh engine."""
    if args.resume:
        from ..io import checkpoint as ckpt
        params, spec, _, extra = ckpt.load(args.resume)
        start = int(extra.get("step", 0))
        _sync_args_to_spec(args, spec)
        print(f"resumed from {args.resume} at step {start}", flush=True)
        return params, spec, start
    eng = _make_engine(args)
    return eng.params, eng.spec, 0


def _sync_args_to_spec(args, spec):
    """Resuming continues THAT training run: the frame pipeline must feed
    the checkpoint's resolution/depth, not the CLI defaults — spectral ops
    are resolution-agnostic, so a mismatch would otherwise silently train
    at the wrong resolution while the manifest still records the old one."""
    if (args.nx, args.ny or args.nx, args.depth) != (spec.nx, spec.ny,
                                                     spec.d):
        print(f"resume: using the checkpoint's geometry "
              f"{spec.d}x{spec.nx}x{spec.ny} (CLI asked for "
              f"{args.depth}x{args.nx}x{args.ny or args.nx})", flush=True)
    args.nx, args.ny, args.depth = spec.nx, spec.ny, spec.d


def _ckpt_dispatch(args, path, params, spec, opt, step_n, *, final=False,
                   extra_files=None):
    """The one checkpoint policy for every trainer: rotating history /
    async mid-run / plain sync, with optional sidecar files (optax state).

    A final save FIRST drains the async worker — writing the final
    checkpoint concurrently with a still-queued mid-run save to the same
    directory could interleave their files (a step-N manifest over
    step-M arrays)."""
    from ..io import checkpoint as ckpt
    if final:
        ckpt.wait_pending_saves()
    if args.ckpt_history > 0:
        ckpt.save_rotating(path, params, spec, opt,
                           extra={"step": step_n}, step=step_n,
                           keep=args.ckpt_history, extra_files=extra_files)
    elif extra_files is not None:
        # sidecars have no async variant: write synchronously
        ckpt.save(path, params, spec, opt, extra={"step": step_n})
        extra_files(Path(path))
    elif args.ckpt_async and not final:
        ckpt.save_async(path, params, spec, opt, extra={"step": step_n})
    else:
        ckpt.save(path, params, spec, opt, extra={"step": step_n})


def _save_params_ckpt(args, params, spec, step_n, final=False):
    """Burst/stream trainer checkpointing (no optimizer state — burst
    momentum is per-pair and restarts on resume; coord stream momentum
    carries within a run only)."""
    _ckpt_dispatch(args, args.ckpt, params, spec, None, step_n,
                   final=final)
    if final:
        print(f"checkpoint written to {args.ckpt} at step {step_n}",
              flush=True)


def _reject_bf16(args):
    """Burst and stream training run the f32 correlation/ω-space bodies
    end to end; a --bf16 that would change nothing is an error."""
    if args.bf16:
        raise SystemExit("--bf16 applies to batched autodiff steps "
                         "(--mode step); burst and stream modes train "
                         "in f32")


def gpu_name_and_power_limit() -> str | None:
    """``nvidia-smi --query-gpu=name,power.limit`` (one line per card), or
    None where there is no ``nvidia-smi``."""
    import shutil
    import subprocess
    if shutil.which("nvidia-smi") is None:
        return None
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip() or None


def _train_bursts(args):
    """Headless reference-style training: per-batch frozen-input FFT bursts
    with batch-averaged gradients (train/fft_dp).

    The burst's internal model is the pool-free two-stage spectral conv, so
    — as in ``Engine._train`` and the reference (autoencoder.cpp:158-197) —
    the selected pair trains on its *pooled* input activation and the
    pre-unpool decoder output, not the full-resolution frame/reconstruction.
    """
    import jax
    from ..data import pipeline
    from ..model import autoencoder as model
    from ..train.fft_dp import fft_burst_dp
    from ..core.types import ConvStage
    _reject_bf16(args)
    params, spec, start_step = _resume_or_engine(args)
    if args.train_pair == "all":
        pairs = list(range(spec.n_pairs))
    else:
        n_l = int(args.train_pair)
        if not 0 <= n_l < spec.n_pairs:
            raise SystemExit(f"--train-pair {n_l} out of range "
                             f"(net has {spec.n_pairs} pairs)")
        pairs = [n_l]
    fwd = jax.jit(lambda p, x: model.forward_fft(p, x, spec.scales,
                                                 return_layers=True))
    pf = pipeline.DevicePrefetcher(_source(args), args.nx, args.ny,
                                   batch=args.batch)
    metrics = Path(args.metrics) if args.metrics else None
    # zeroed per burst (reference semantics) unless --carry-momentum
    moms = {n_l: None for n_l in pairs}
    # failure detection (SURVEY.md §5.3), as in _train_steps: params/moms
    # last verified finite at a log step — rolled back to (and saved) on
    # divergence.  The mses fetch is a host↔device sync, so the check
    # rides the log cadence only
    good_params, good_moms, good_step = params, dict(moms), start_step
    last_step = start_step
    diverged = False
    for step_i, batch in enumerate(pf, start=start_step):
        if step_i >= args.steps or diverged:
            break
        last_step = step_i + 1
        for n_l in pairs:
            # refresh activations between pairs — an inner pair's burst
            # changes every outer pair's target (the reference user's
            # manual 'z'/'x' + '1' sweep, autoencoder.cpp:279-310)
            _, layers = fwd(params, batch)
            in_b = layers[2 * n_l + 1]
            out_b = layers[len(layers) - 2 - 2 * n_l]
            enc, dec = params.pair(n_l)
            res = fft_burst_dp(in_b, None, out_b, enc.c, dec.c,
                               enc.b, dec.b, moms[n_l], lr=args.lr,
                               alpha=args.alpha, iters=args.iters,
                               maxdiff=args.maxdiff,
                               reanchor_every=args.reanchor or None)
            if args.carry_momentum:
                moms[n_l] = res.mom
            params = params.replace_pair(n_l, ConvStage(c=res.c, b=res.b),
                                         ConvStage(c=res.f, b=res.p))
            if step_i % args.log_every == 0:
                # per-inner-iteration MSE trajectory, the reference's
                # per-iter "n: ... mse: ..." stream
                # (fft_backproplib.cu:1463-1464) — collected on-device,
                # emitted once per burst
                mses = np.asarray(res.mses, dtype=np.float64)
                if not np.isfinite(mses).all():
                    # the trajectory certifies this burst's updates; a
                    # non-finite entry poisons res.c/f/b/p — roll back
                    print(json.dumps({"step": step_i, "pair": n_l,
                                      "error": "non-finite mse",
                                      "mseN": float(mses[-1])}),
                          flush=True)
                    params, moms = good_params, good_moms
                    last_step = good_step
                    diverged = True
                    break
                _emit({"step": step_i, "pair": n_l,
                       "mse0": float(mses[0]), "mseN": float(mses[-1]),
                       "mses": [float(v) for v in mses]}, metrics)
        if not diverged and step_i % args.log_every == 0:
            good_params, good_moms, good_step = (params, dict(moms),
                                                 last_step)
        if (args.ckpt and args.ckpt_every > 0 and not diverged and step_i
                and step_i % args.ckpt_every == 0):
            _save_params_ckpt(args, params, spec, last_step)
    pf.close()
    if args.ckpt:
        _save_params_ckpt(args, params, spec, last_step, final=True)


def _train_stream(args):
    """Streaming burst training: K frames × one fused burst each, in ONE
    on-device ``lax.scan`` (train/streaming.py — one dispatch per flush
    block instead of one per burst).

    Contract: trains the selected stage pair on its pooled input
    activation — ``forward_fft``'s ``layers[2·n_l+1]``, i.e. SPECTRAL
    pooling, the same activation burst mode trains on and the forward
    pass produces — with the anchor output being the pair's own
    two-stage forward (the fused re-anchoring each frame).  Pair 0 with
    unit pooling scale feeds on the frames directly (the pooling is the
    identity there); every other case computes the activation from the
    frozen outer encoder stages *inside* the scan
    (train/streaming.py::stream_bursts_pair / _pair_input).  ``--train-pair all`` round-robins
    the pairs one flush block at a time (outer stages stay frozen within
    each block; each block sees every previously trained pair — the
    engine user's 'z'/'x' + '1' sweep at stream throughput).  This
    differs from ``--mode burst`` only in the anchor: burst mode anchors
    on the full-net reconstruction (pool-mismatched by reference design,
    autoencoder.cpp:169), stream mode on the pair's exact forward — the
    steady-state contract the correlation burst's precision
    decomposition is built for.
    """
    import jax.numpy as jnp
    from ..core.types import ConvStage
    from ..data import pipeline
    from ..train.streaming import (coord_stream, fft_stream,
                                   fft_stream_pair, fft_stream_sweep)
    params, spec, start_step = _resume_or_engine(args)
    sweep = args.train_pair == "all"
    frame_sweep = sweep and args.pair_sweep == "frame"
    coord_domain = args.domain == "coord"
    _reject_bf16(args)
    if args.pair_sweep == "frame" and not sweep:
        raise SystemExit("--pair-sweep frame requires --train-pair all "
                         "(a single selected pair has nothing to sweep)")
    if coord_domain and frame_sweep:
        raise SystemExit("--pair-sweep frame is momentum-domain only; "
                         "coord streaming sweeps pairs per flush block "
                         "(--pair-sweep block)")
    if sweep:
        pairs = list(range(spec.n_pairs))
    else:
        n_sel = int(args.train_pair)
        if not 0 <= n_sel < spec.n_pairs:
            raise SystemExit(f"--train-pair {n_sel} out of range "
                             f"(net has {spec.n_pairs} pairs)")
        pairs = [n_sel]
    pf = pipeline.DevicePrefetcher(_source(args), args.nx, args.ny,
                                   batch=args.batch)
    metrics = Path(args.metrics) if args.metrics else None
    k_frames = args.stream_k
    # per-pair momentum (zeroed on pair switch unless carried — the
    # engine's _reset_pair_opt_state semantics, burst mode's moms dict)
    moms = {n: None for n in pairs}
    sweep_moms = None   # frame-sweep mode: per-pair tuples, pair order
    coord_state = {n: (None, None) for n in pairs}  # (mom, prev_grad)
    step_i = start_step
    block_i = 0     # sweep mode round-robins one pair per flush block
    buf = []

    def flush_coord(xs, n_l):
        """--domain coord: one reference coord step per frame in one scan
        (train/streaming.py::stream_coord_steps).

        Momentum ALWAYS carries across flush blocks (per pair): the
        reference coord loop carries dc/df continuously between frames
        (the engine's persistent _mom), and block-boundary zeroing would
        make trained weights depend on --stream-k, a pure performance
        knob.  --carry-momentum is an FFT-burst concept (the reference
        zeroes per burst); it does not apply here."""
        nonlocal params, step_i
        mo, pg = coord_state[n_l]
        r = coord_stream(xs, params, spec.scales, n_l, q=args.patch_q,
                         lr=args.lr, alpha=args.alpha, mom=mo,
                         prev_grad=pg)
        mses = np.asarray(r.mses, dtype=np.float64)
        if not np.isfinite(mses).all():
            bad = int(np.argwhere(~np.isfinite(mses))[0, 0])
            print(json.dumps({"step": step_i + bad, "pair": n_l,
                              "error": "non-finite mse",
                              "mse": float(mses[bad])}), flush=True)
            return False
        params = r.params
        coord_state[n_l] = (r.mom, r.prev_grad)
        for k in range(xs.shape[0]):
            if (step_i + k) % args.log_every == 0:
                _emit({"step": step_i + k, "pair": n_l,
                       "mse": float(mses[k])}, metrics)
        step_i += xs.shape[0]
        return True

    def flush_frame_sweep(xs):
        """--pair-sweep frame: every pair trains on every frame, inside
        one scan (train/streaming.py::stream_bursts_sweep)."""
        nonlocal params, sweep_moms, step_i
        r = fft_stream_sweep(xs, params, spec.scales, moms=sweep_moms,
                             lr=args.lr, alpha=args.alpha, iters=args.iters,
                             maxdiff=args.maxdiff,
                             carry_momentum=args.carry_momentum,
                             reanchor_every=args.reanchor or None)
        mses = np.asarray(r.mses, dtype=np.float64)   # [K, n_pairs, it+1]
        if not np.isfinite(mses).all():
            bad = int(np.argwhere(
                ~np.isfinite(mses).all(axis=(1, 2)))[0, 0])
            print(json.dumps({"step": step_i + bad, "pair": "all",
                              "error": "non-finite mse",
                              "mseN": float(mses[bad, -1, -1])}),
                  flush=True)
            return False
        params = r.params
        if args.carry_momentum:
            sweep_moms = r.moms
        for k in range(xs.shape[0]):
            if (step_i + k) % args.log_every == 0:
                for n_l in pairs:
                    _emit({"step": step_i + k, "pair": n_l,
                           "mse0": float(mses[k, n_l, 0]),
                           "mseN": float(mses[k, n_l, -1])}, metrics)
        step_i += xs.shape[0]
        return True

    def flush():
        nonlocal params, step_i, block_i, buf
        xs = jnp.stack(buf)
        buf = []
        if frame_sweep:
            return flush_frame_sweep(xs)
        n_l = pairs[block_i % len(pairs)]
        block_i += 1
        if coord_domain:
            return flush_coord(xs, n_l)
        if pool0_direct:
            # pair 0 with unit pooling scale: the frames ARE its input
            # activation (spectral_pool at scale 1 is the identity) — no
            # per-frame transform inside the scan at all
            enc, dec = params.pair(0)
            r = fft_stream(xs, enc.c, dec.c, enc.b, dec.b, moms[0],
                           lr=args.lr, alpha=args.alpha, iters=args.iters,
                           maxdiff=args.maxdiff,
                           carry_momentum=args.carry_momentum,
                           reanchor_every=args.reanchor or None)
        else:
            # the pair's activation comes from the frozen outer stages,
            # computed per frame inside the scan (sweep blocks see every
            # previously trained pair through the updated params tree)
            r = fft_stream_pair(xs, params, spec.scales, n_l,
                                mom=moms[n_l], lr=args.lr,
                                alpha=args.alpha, iters=args.iters,
                                maxdiff=args.maxdiff,
                                carry_momentum=args.carry_momentum,
                                reanchor_every=args.reanchor or None)
        mses = np.asarray(r.mses, dtype=np.float64)
        if not np.isfinite(mses).all():
            # failure detection (SURVEY.md §5.3): the per-frame MSE
            # trajectories certify the block's updates — on a non-finite
            # entry keep the block-start weights (params/moms untouched)
            # so the final checkpoint stays finite, and halt
            bad = int(np.argwhere(~np.isfinite(mses).all(axis=1))[0, 0])
            print(json.dumps({"step": step_i + bad, "pair": n_l,
                              "error": "non-finite mse",
                              "mseN": float(mses[bad, -1])}), flush=True)
            return False
        params = params.replace_pair(n_l, ConvStage(c=r.c, b=r.b),
                                     ConvStage(c=r.f, b=r.p))
        if args.carry_momentum:
            moms[n_l] = r.mom
        for k in range(xs.shape[0]):
            if (step_i + k) % args.log_every == 0:
                _emit({"step": step_i + k, "pair": n_l,
                       "mse0": float(mses[k, 0]),
                       "mseN": float(mses[k, -1])}, metrics)
        step_i += xs.shape[0]
        return True

    # pair 0's true input is the SPECTRAL pooling of the frame (what the
    # forward pass, burst mode, and eval all use) — feeding frames
    # directly is only exact when the pooling scale is 1; any other scale
    # goes through _pair_input inside the scan like every inner pair
    pool0_direct = (not sweep and pairs[0] == 0
                    and abs(spec.scales[0]) == 1)
    diverged = False
    # ckpt_every <= 0 disables mid-run saves (the final save still runs)
    next_ckpt = (start_step + args.ckpt_every if args.ckpt_every > 0
                 else float("inf"))
    for batch in pf:
        if step_i >= args.steps:
            break
        buf.append(batch)
        if len(buf) < k_frames and step_i + len(buf) < args.steps:
            continue
        if not flush():
            diverged = True
            break
        if args.ckpt and step_i >= next_ckpt:
            # mid-run checkpoint at block granularity (a flush advances
            # step_i by up to K frames)
            _save_params_ckpt(args, params, spec, step_i)
            next_ckpt += args.ckpt_every * (
                (step_i - next_ckpt) // args.ckpt_every + 1)
    if buf and not diverged:
        # a finite source ended mid-block: train on the remainder rather
        # than dropping buffered frames
        flush()
    pf.close()
    if args.ckpt:
        _save_params_ckpt(args, params, spec, step_i, final=True)


def cmd_train(args):
    import contextlib
    from ..core.profiling import device_trace
    trace_ctx = (device_trace(args.trace) if getattr(args, "trace", "")
                 else contextlib.nullcontext())
    with trace_ctx:
        if args.mode == "burst":
            return _train_bursts(args)
        if args.mode == "stream":
            return _train_stream(args)
        return _train_steps(args)


def _train_steps(args):
    import jax
    import jax.numpy as jnp
    from ..core.types import init_opt_state
    from ..data import pipeline
    from ..io import checkpoint as ckpt
    from ..ops.coord import leaky_relu
    from ..train.modern import (make_optax_train_step, make_optimizer,
                                train_step)
    use_optax = args.optimizer != "reference"
    act = leaky_relu if args.activation == "leaky_relu" else None
    cdtype = jnp.bfloat16 if args.bf16 else None
    if use_optax:
        optimizer = make_optimizer(args.optimizer, args.lr,
                                   schedule=args.lr_schedule,
                                   warmup_steps=args.warmup,
                                   total_steps=args.steps)
        optax_step = make_optax_train_step(
            optimizer, domain=args.domain, act=act, compute_dtype=cdtype,
            remat=args.remat, accum_steps=args.accum)
    start_step = 0
    if args.resume:
        params, spec, opt, extra = ckpt.load(args.resume)
        if use_optax:
            opt = optimizer.init(params)
            optax_file = ckpt.resolve(args.resume) / "optax.npz"
            if optax_file.exists():
                opt = ckpt.load_optax_state(optax_file, opt)
        elif opt is None:
            opt = init_opt_state(params)
        start_step = int(extra.get("step", 0))
        _sync_args_to_spec(args, spec)
        print(f"resumed from {args.resume} at step {start_step}", flush=True)
    else:
        eng = _make_engine(args)
        params, spec = eng.params, eng.spec
        opt = (optimizer.init(params) if use_optax
               else init_opt_state(params))

    def save_ckpt(path, step_n, final=False):
        # optax state is written via extra_files so it lands in the
        # step dir BEFORE the LATEST marker moves — a crash between
        # the two can't expose a checkpoint with missing opt state
        sidecar = ((lambda d: ckpt.save_optax_state(
            Path(d) / "optax.npz", opt)) if use_optax else None)
        _ckpt_dispatch(args, path, params, spec,
                       None if use_optax else opt, step_n, final=final,
                       extra_files=sidecar)

    src = _source(args)
    metrics = Path(args.metrics) if args.metrics else None
    pf = pipeline.DevicePrefetcher(src, args.nx, args.ny, batch=args.batch)
    t_start = time.perf_counter()
    last_step = start_step
    # last params/opt verified finite at a log step — what we roll back to
    # (and save) on divergence, so NaN updates applied between log steps
    # can never reach the final checkpoint
    good_params, good_opt, good_step = params, opt, start_step
    for step_i, batch in enumerate(pf, start=start_step):
        if step_i >= args.steps:
            break
        if use_optax:
            res = optax_step(params, opt, batch, spec.scales)
        else:
            res = train_step(params, opt, batch, spec.scales, lr=args.lr,
                             alpha=args.alpha, domain=args.domain,
                             compute_dtype=cdtype, act=act,
                             remat=args.remat, accum_steps=args.accum)
        # failure detection (SURVEY.md §5.3): halt on divergence, keep the
        # last good checkpoint.  The float() fetch is a host↔device sync,
        # so check only on log steps — off-step dispatch stays pipelined
        # behind the prefetcher
        if step_i % args.log_every == 0:
            if not np.isfinite(float(res.loss)):
                print(json.dumps({"step": step_i,
                                  "error": "non-finite loss",
                                  "loss": float(res.loss)}), flush=True)
                params, opt, last_step = good_params, good_opt, good_step
                break
            # res.loss is the loss of the params going INTO this step, so
            # a finite value certifies the pre-update params
            good_params, good_opt, good_step = params, opt, last_step
        params, opt = res.params, res.opt
        last_step = step_i + 1
        if step_i % args.log_every == 0:
            _emit({"step": step_i, "loss": float(res.loss),
                   "domain": args.domain,
                   "steps_per_sec": (step_i + 1) /
                                    (time.perf_counter() - t_start)},
                  metrics)
        if (args.ckpt and args.ckpt_every > 0 and step_i
                and step_i % args.ckpt_every == 0):
            # stamp the step REACHED (params already applied step_i's
            # update): stamping step_i made resume replay that update
            save_ckpt(args.ckpt, last_step)
    pf.close()
    if args.ckpt:
        # stamped with the step actually REACHED (divergence break or an
        # exhausted source must not fake completion — resume would no-op)
        save_ckpt(args.ckpt, last_step, final=True)
        print(f"checkpoint written to {args.ckpt} at step {last_step}",
              flush=True)


def cmd_info(args):
    eng = _make_engine(args)
    print(eng.info())


def cmd_eval(args):
    """Reconstruction quality over a frame source: per-pixel MSE + PSNR.

    Evaluates either a training checkpoint (--from-ckpt, forward in the
    chosen domain) or an AOT serving artifact (--model).
    """
    import jax
    from ..data import pipeline
    eng_fwd = None
    if args.model:
        from ..io.export import ServingModel
        m = ServingModel.load(args.model)
        if m.manifest["what"] != "forward":
            raise SystemExit("eval needs a 'forward' artifact "
                             f"(got {m.manifest['what']!r})")
        d, nx, ny = m.input_shape
        fwd = m
    else:
        from ..io import checkpoint as ckpt
        from ..model import autoencoder as model
        if args.from_ckpt:
            params, spec, _, _ = ckpt.load(args.from_ckpt)
        else:
            eng = _make_engine(args)
            params, spec = eng.params, eng.spec
        nx, ny, d = spec.nx, spec.ny, spec.d
        if args.domain == "fft":
            fwd = jax.jit(lambda x: model.forward_fft(params, x, spec.scales))
        else:
            fwd = jax.jit(
                lambda x: model.forward_coord(params, x, spec.scales)[-1])
    args.nx, args.ny = nx, ny
    src = _source(args)
    pf = pipeline.DevicePrefetcher(src, nx, ny, batch=args.batch)
    sq_sum = 0.0
    n_frames = 0
    t0 = time.perf_counter()
    for i, batch in enumerate(pf):
        if i >= args.steps:
            break
        out = np.asarray(fwd(batch), dtype=np.float64)
        sq_sum += float(np.sum((out - np.asarray(batch,
                                                 dtype=np.float64)) ** 2))
        n_frames += batch.shape[0]
    pf.close()
    dt = time.perf_counter() - t0
    if n_frames == 0:
        raise SystemExit("eval: source produced no frames")
    mse = sq_sum / (n_frames * d * nx * ny)
    psnr = 10.0 * np.log10(255.0 ** 2 / mse) if mse > 0 else float("inf")
    print(json.dumps({"frames": n_frames, "mse_per_pixel": round(mse, 6),
                      "psnr_db": round(psnr, 3),
                      "fps": round(n_frames / dt, 2)}), flush=True)


def cmd_export(args):
    """AOT-export a serving artifact from a checkpoint (or a fresh net)."""
    from ..io import checkpoint as ckpt
    from ..io.export import export_model
    if args.from_ckpt:
        params, spec, _, _ = ckpt.load(args.from_ckpt)
    else:
        eng = _make_engine(args)
        params, spec = eng.params, eng.spec
    platforms = (tuple(args.platforms.split(","))
                 if args.platforms else None)
    whats = (("forward", "encode") if args.what == "both"
             else (args.what,))
    for what in whats:
        # 'both' gets per-function subdirectories — each artifact owns its
        # manifest, so neither export orphans the other
        dest = (Path(args.out) / what) if len(whats) > 1 else args.out
        out = export_model(params, spec, dest, what=what,
                           domain=args.domain, batch=args.batch,
                           platforms=platforms,
                           tap_mode=args.tap_mode)
        print(f"exported {what} ({args.domain}) -> {out}", flush=True)


def cmd_serve(args):
    """Run inference from an exported artifact over a frame source, or
    expose it over HTTP (--http PORT)."""
    from ..data import pipeline
    from ..io.export import ServingModel
    from ..viz.png import write_png
    m = ServingModel.load(args.model)
    if args.http is not None:
        from ..io.server import InferenceServer
        srv = InferenceServer(m, port=args.http, warmup=True,
                              batch_window_ms=args.http_batch_ms)
        print(json.dumps({"serving": args.model, "port": srv.port,
                          "routes": ["/healthz", "/infer"]}), flush=True)
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            srv.shutdown()
        return
    d, nx, ny = m.input_shape
    args.nx, args.ny = nx, ny
    src = _source(args)
    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    pf = pipeline.DevicePrefetcher(src, nx, ny, batch=args.batch)
    t0 = time.perf_counter()
    n_frames = 0
    for i, batch in enumerate(pf):
        if i >= args.steps:
            break
        out = np.asarray(m(batch))
        n_frames += out.shape[0]
        if args.dump_every and i % args.dump_every == 0:
            if out.shape[1] == 3:  # reconstruction -> displayable frame
                img = pipeline.tensor_to_frame(out[0])
            else:  # feature maps -> first channel, wrap-cast
                img = pipeline.feature_to_image(out[0, 0])
            write_png(outdir / f"serve_{i:05d}.png", img)
    pf.close()
    dt = time.perf_counter() - t0
    print(json.dumps({"frames": n_frames, "seconds": round(dt, 4),
                      "fps": round(n_frames / dt, 2),
                      "what": m.manifest["what"],
                      "platforms": m.manifest["platforms"]}), flush=True)


def _probe_backend(timeout_s: float) -> dict:
    """Backend init (jax.devices()) in a daemon thread with a deadline.

    A device whose driver does not answer can hang PJRT client init — a
    diagnostic tool must report that, not become a hung process itself.
    The thread is a daemon so a timed-out probe can't block interpreter
    exit."""
    import threading
    out = {}

    def probe():
        try:
            import jax
            out["backend"] = jax.default_backend()
            out["devices"] = [str(d) for d in jax.devices()]
            out["device_kind"] = jax.devices()[0].device_kind
            out["device_count"] = len(jax.devices())
            out["process"] = f"{jax.process_index()}/{jax.process_count()}"
        except Exception as e:          # report, never raise — diagnostic
            out["backend_error"] = f"{type(e).__name__}: {e}"

    th = threading.Thread(target=probe, daemon=True)
    th.start()
    th.join(timeout_s)
    if th.is_alive():
        return {"backend_error": f"backend init still hung after "
                                 f"{timeout_s:g}s (retry, or use "
                                 "JAX_PLATFORMS=cpu)"}
    return out


def cmd_doctor(args):
    """Environment diagnostic: devices, compile cache, native lib, deps —
    the card's name and power limit as ``nvidia-smi`` reports them — and
    (unless --no-device) a tiny jitted matmul round-trip to prove the
    device path end to end.  Backend init is time-bounded so a device
    that does not answer yields a report, not a hang."""
    import jax
    from ..core.runtime import cache_dir
    from ..data import native
    info = {
        "jax": jax.__version__,
        "numpy": np.__version__,
        "compile_cache": str(cache_dir()),
        "native_lib": {
            "available": native.available(),
            "batch_stage": native.has_batch(),
            "yuv_decode": native.has_yuv(),
            "png_unfilter": native.has_png_unfilter(),
        },
    }
    info.update(_probe_backend(args.device_timeout))
    info["gpu"] = gpu_name_and_power_limit()
    try:
        import optax
        info["optax"] = optax.__version__
    except ImportError:
        info["optax"] = None
    try:
        import cv2
        info["opencv"] = cv2.__version__
    except ImportError:
        info["opencv"] = None
    if not args.no_device and "devices" in info:
        import time as _t
        import jax.numpy as jnp
        t0 = _t.perf_counter()
        v = float(jnp.sum(jax.jit(lambda a: a @ a)(jnp.ones((128, 128)))))
        info["device_check"] = {"ok": v == 128.0 * 128 * 128,
                                "round_trip_s": round(_t.perf_counter() - t0,
                                                      3)}
    print(json.dumps(info, indent=2), flush=True)


def cmd_bench(args):
    # bench.py lives at the repo root (a harness, not a wheel module) —
    # resolve it for installed console scripts too
    try:
        import bench
    except ImportError:
        import sys as _sys
        root = Path(__file__).resolve().parents[2]
        if not (root / "bench.py").exists():
            raise SystemExit(
                "bench.py not found — run from a source checkout "
                f"(looked in {root})")
        _sys.path.insert(0, str(root))
        import bench
    bench.main()


def main(argv=None):
    from ..core.runtime import enable_compilation_cache
    enable_compilation_cache()
    ap = argparse.ArgumentParser(prog="spectralae")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="interactive/streaming loop")
    _add_common(p)
    p.add_argument("--source", default="synthetic",
                   help="synthetic | camera | a .y4m video (cv2-free) | any "
                        "OpenCV-demuxable video (mp4/avi/mkv/...) | a "
                        ".npy/.npz frame stack | a directory of .png "
                        "images (RGB by default; see --png-order)")
    p.add_argument("--png-order", choices=("rgb", "bgr"), default="rgb",
                   help="channel order of .png dataset files: 'rgb' for "
                        "standard external PNGs (reversed to the "
                        "pipeline's BGR), 'bgr' for this framework's own "
                        "viz dumps (pass-through)")
    p.add_argument("--frames", type=int, default=100)
    p.add_argument("--outdir", default="./views")
    p.add_argument("--dump-every", type=int, default=0)
    p.add_argument("--interactive", action="store_true")
    p.add_argument("--tui", action="store_true",
                   help="live ANSI terminal UI with single-key commands")
    p.add_argument("--gui", action="store_true",
                   help="the reference's four live OpenCV windows with "
                        "waitKey keyboard control (needs a display)")
    p.add_argument("--keys", default="",
                   help="scripted key sequence, one key per frame")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("train", help="headless batched training")
    _add_common(p)
    p.add_argument("--source", default="synthetic")
    p.add_argument("--png-order", choices=("rgb", "bgr"), default="rgb")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--lr", type=float, default=0.2)
    p.add_argument("--alpha", type=float, default=0.9)
    p.add_argument("--optimizer",
                   choices=("reference", "adam", "adamw", "sgd"),
                   default="reference",
                   help="'reference' = the normalized-gradient inertia "
                        "update; the rest are optax optimizers (step mode "
                        "only; optax state checkpoints to optax.npz)")
    p.add_argument("--domain", choices=("fft", "coord"), default="fft",
                   help="step mode: autodiff domain; stream mode: 'coord' "
                        "streams one reference coordinate step per frame "
                        "(the '1'-with-fft-off loop) instead of FFT bursts")
    p.add_argument("--mode", choices=("step", "burst", "stream"),
                   default="step",
                   help="step: batched autodiff training; burst: the "
                        "reference's per-frame 100-iteration FFT bursts; "
                        "stream: K frames x one fused burst each in a "
                        "single on-device scan (fastest steady-state "
                        "trainer)")
    p.add_argument("--stream-k", type=int, default=16,
                   help="stream mode: frames per on-device scan")
    p.add_argument("--train-pair", default="0",
                   help="burst/stream mode: stage pair to train (the "
                        "'z'/'x' focus); 'all' round-robins every pair — "
                        "per batch in burst mode, per flush block in "
                        "stream mode; inner pairs' activations come from "
                        "the frozen outer stages")
    p.add_argument("--patch-q", type=int, default=1,
                   help="stream --domain coord: center-crop factor for "
                        "the training patch (the reference's '2'/'3' "
                        "keys, netlib.cpp Portion)")
    p.add_argument("--pair-sweep", choices=("block", "frame"),
                   default="block",
                   help="stream mode with --train-pair all: 'block' "
                        "round-robins one pair per flush block; 'frame' "
                        "trains EVERY pair on EVERY frame inside the scan "
                        "(the keyboard 'z'/'x' sweep per frame, one jit "
                        "for the whole block)")
    p.add_argument("--iters", type=int, default=100,
                   help="burst mode: inner iterations per burst (the "
                        "reference hard-codes 100, fft_backproplib.cu:1446)")
    p.add_argument("--carry-momentum", action="store_true",
                   help="burst/stream (fft): carry optimizer momentum "
                        "across bursts instead of zeroing per burst "
                        "(reference zeroes: fft_backproplib.cu:1420-1423)."
                        "  Coord streaming always carries momentum — the "
                        "reference coord loop does (engine _mom)")
    p.add_argument("--maxdiff", action="store_true",
                   help="burst mode: multiobjective kernel-diversity "
                        "objective (the 'm' key; w0=1, w1=10 as "
                        "fft_backproplib.cu:1252)")
    p.add_argument("--reanchor", type=int, default=0,
                   help="burst mode: re-anchor the correlation "
                        "decomposition every N inner iterations (keeps "
                        "ultra-converged long bursts fp32-accurate; "
                        "0 = never)")
    p.add_argument("--bf16", action="store_true",
                   help="batched autodiff steps (--mode step) only: bf16 "
                        "forward in the coord domain; bf16 operand "
                        "streaming with f32 accumulation through the "
                        "pointwise convs in the fft domain.  Burst and "
                        "stream modes train in f32 and reject it")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize per-stage blocks in the backward "
                        "(trades recompute for activation memory at "
                        "high resolution)")
    p.add_argument("--accum", type=int, default=1,
                   help="gradient-accumulation microbatches per step "
                        "(batch must divide evenly)")
    p.add_argument("--lr-schedule", choices=("constant", "cosine", "linear"),
                   default="constant",
                   help="optax learning-rate schedule (optax optimizers "
                        "only; decays over --steps)")
    p.add_argument("--warmup", type=int, default=0,
                   help="linear lr warmup steps (optax optimizers only)")
    p.add_argument("--activation", choices=("identity", "leaky_relu"),
                   default="identity")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--ckpt", default="")
    p.add_argument("--ckpt-every", type=int, default=100)
    p.add_argument("--ckpt-history", type=int, default=0, metavar="N",
                   help="keep a rotating history of the newest N "
                        "step-stamped checkpoints under --ckpt (0 = one "
                        "directory, overwritten)")
    p.add_argument("--ckpt-async", action="store_true",
                   help="write mid-run checkpoints on a background worker "
                        "(final checkpoint is always synchronous)")
    p.add_argument("--resume", default="",
                   help="checkpoint dir to resume params/step from (all "
                        "modes; step mode also restores optimizer state, "
                        "burst/stream momentum restarts per reference "
                        "zeroing semantics)")
    p.add_argument("--metrics", default="")
    p.add_argument("--trace", default="",
                   help="capture a jax.profiler device trace of the run "
                        "into this directory (view with XProf/TensorBoard)")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("info", help="print network structure")
    _add_common(p)
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("eval",
                       help="reconstruction MSE/PSNR over a frame source")
    p.add_argument("--from-ckpt", default="",
                   help="checkpoint dir to evaluate (else a fresh net)")
    p.add_argument("--model", default="",
                   help="AOT artifact dir to evaluate instead of a ckpt")
    p.add_argument("--domain", choices=("fft", "coord"), default="fft")
    p.add_argument("--source", default="synthetic")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--nx", type=int, default=256)
    p.add_argument("--ny", type=int, default=None)
    p.add_argument("--depth", type=int, default=3)
    p.add_argument("--param-file", type=str, default=None)
    p.add_argument("--layers", type=int, default=1)
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("export",
                       help="AOT-export a serving artifact (jax.export)")
    _add_common(p)
    p.add_argument("--from-ckpt", default="",
                   help="checkpoint dir to export from (else a fresh net)")
    p.add_argument("--out", required=True, help="artifact directory")
    p.add_argument("--what", choices=("forward", "encode", "both"),
                   default="forward")
    p.add_argument("--domain", choices=("fft", "coord"), default="fft")
    p.add_argument("--batch", type=int, default=None,
                   help="fixed batch size; omit for batch-polymorphic")
    p.add_argument("--platforms", default="",
                   help="comma-separated lowering platforms, e.g. "
                        "cpu,cuda (default: ambient platform)")
    p.add_argument("--tap-mode",
                   choices=("ref_gpu", "ref_cpu", "centered"), default=None,
                   help="coord-domain tap window baked into the artifact "
                        "(default ref_gpu — the engine's training default; "
                        "match what the net was trained with)")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("serve",
                       help="run inference from an exported artifact")
    p.add_argument("--model", required=True, help="artifact directory")
    p.add_argument("--source", default="synthetic")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--outdir", default="./views")
    p.add_argument("--dump-every", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--http", type=int, default=None, metavar="PORT",
                   help="serve the artifact over HTTP instead of a local "
                        "loop (GET /healthz, POST /infer with .npy body; "
                        "0 picks a free port)")
    p.add_argument("--http-batch-ms", type=float, default=0.0,
                   help="dynamic batching window for concurrent /infer "
                        "requests (batch-polymorphic artifacts only; "
                        "0 disables)")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("doctor", help="environment diagnostic (devices, "
                                      "cache, native lib, deps)")
    p.add_argument("--no-device", action="store_true",
                   help="skip the jitted device round-trip check")
    p.add_argument("--device-timeout", type=float, default=60.0,
                   help="seconds to wait for backend init before reporting "
                        "the device path as hung")
    p.set_defaults(fn=cmd_doctor)

    p = sub.add_parser("bench", help="run the benchmark harness")
    p.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
