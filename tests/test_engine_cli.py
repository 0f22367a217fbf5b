"""Engine (interactive runtime) and CLI behavior."""

import numpy as np
import pytest

from spectralae.core.config import Config, LayerParams, save_layer_params
from spectralae.model.engine import Engine, dispatch_key, KEYMAP
from spectralae.data import pipeline


def make_engine(nx=16, m=4, fft_iters=5, **kw):
    cfg = Config(nx=nx, ny=nx, d=3,
                 layer=LayerParams(depth=m, lk=0, ll=0, scale=2, rmax=0.5),
                 fft_iters=fft_iters)
    return Engine(cfg, seed=0, **kw)


def frame(nx=16, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(100, 40, size=(3, nx, nx)).astype(np.float32)


def test_step_and_views_both_domains():
    eng = make_engine()
    out = eng.step(frame())
    assert out.shape == (3, 16, 16)
    views = eng.current_views()
    assert views["input"].shape == (16, 16, 3)
    assert views["feature_map"].shape == (8, 8)
    assert views["kernel"].shape == (3, 9)  # Nl x (D*Nk) for 3x3 kernels
    eng.toggle_fft()
    out2 = eng.step(frame())
    assert out2.shape == (3, 16, 16)


def test_fft_training_disarms_after_burst():
    eng = make_engine()
    eng.toggle_training()
    assert eng.flags.sel
    eng.step(frame())
    assert not eng.flags.sel            # one burst per arm (A5 semantics)
    assert eng.last_mse is not None and np.isfinite(eng.last_mse)


def test_coord_training_stays_armed_and_learns():
    eng = make_engine()
    eng.toggle_fft()                    # coord mode
    eng.toggle_training()
    first = None
    for i in range(20):
        eng.step(frame())
        assert eng.flags.sel            # stays armed every frame
        if first is None:
            first = eng.last_mse
    assert eng.last_mse < first


def test_layer_mutation_roundtrip():
    eng = make_engine(nx=32)
    assert eng.spec.n_pairs == 1
    eng.add_layer()
    assert eng.spec.n_pairs == 2
    assert eng.flags.n_l == 1           # new layer selected (A9)
    out = eng.step(frame(32))
    assert out.shape == (3, 32, 32)
    eng.drop_layer()
    assert eng.spec.n_pairs == 1 and eng.flags.n_l == 0
    out = eng.step(frame(32))
    assert out.shape == (3, 32, 32)
    # cannot drop below one pair
    eng.drop_layer()
    assert eng.spec.n_pairs == 1


def test_lr_stepping_log_scale():
    eng = make_engine()
    assert eng.flags.lr == 0.2
    dispatch_key(eng, "4")
    assert abs(eng.flags.lr - 0.3) < 1e-9
    for _ in range(10):
        dispatch_key(eng, "5")
    assert eng.flags.lr >= 0.0
    # step size shrinks at decade boundaries
    eng.flags.lr, eng.flags.dlr = 0.011, 0.01
    dispatch_key(eng, "5")
    # 0.011-0.01 rounds just below 0.001, landing in the next decade —
    # same as the reference's float arithmetic (autoencoder.cpp:260-268)
    assert abs(eng.flags.lr - 0.001) < 1e-9
    assert eng.flags.dlr == 0.0001


def test_feature_and_layer_cycling_resets_state():
    eng = make_engine()
    eng.add_layer()
    eng.flags.feat = 2
    dispatch_key(eng, "z")
    assert eng.flags.feat == 0
    mom0 = eng._mom
    assert all(float(np.abs(np.asarray(t)).sum()) == 0 for t in mom0)


def test_symmetric_tie():
    eng = make_engine()
    dispatch_key(eng, "p")
    enc, dec = eng.params.pair(0)
    np.testing.assert_array_equal(
        np.asarray(dec.c), np.asarray(enc.c).transpose(1, 0, 2, 3))


def test_save_load_weights(tmp_path):
    eng = make_engine()
    eng.save_weights(tmp_path)
    old = np.asarray(eng.params.stages[0].c).copy()
    eng.reinit_weights()
    assert not np.array_equal(np.asarray(eng.params.stages[0].c), old)
    eng.load_weights(tmp_path)
    np.testing.assert_array_equal(np.asarray(eng.params.stages[0].c), old)


def test_param_file_reload(tmp_path):
    pf = tmp_path / "New_Layer_Param.txt"
    save_layer_params(LayerParams(depth=6, lk=1, ll=1, scale=2, rmax=2.0), pf)
    eng = Engine(Config(nx=32, ny=32, d=3), seed=0, param_file=pf)
    assert eng.params.stages[0].m == 6
    assert eng.params.stages[0].nk == 5
    eng.add_layer()
    assert eng.params.stages[1].m == 6


def test_all_keys_dispatch(tmp_path):
    eng = make_engine(nx=16)
    eng.step(frame())
    import os
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        for key in KEYMAP:
            if key == "l":
                dispatch_key(eng, "s")  # ensure files exist before load
            dispatch_key(eng, key)
    finally:
        os.chdir(cwd)
    eng.step(frame())


def test_fft_layers_toggle_gates_tape_and_adds_views():
    """'g' (fft_l) gates the per-layer irfft tax in step() and adds the
    per-layer / spectrum streams to the views (fft_backproplib.cu:1344-1361)."""
    eng = make_engine()
    eng.step(frame())
    assert eng.layers is None          # fast path: no viz tax per frame
    v = eng.current_views()            # lazy tape recompute on demand
    assert v["feature_map"].shape == (8, 8)
    assert "layer_0" not in v and "spectrum" not in v
    dispatch_key(eng, "g")
    eng.step(frame())
    assert eng.layers is not None      # 'g' computes the tape every frame
    v = eng.current_views()
    n_entries = 2 * eng.params.n_stages + 1
    for i in range(n_entries):
        assert f"layer_{i}" in v
    assert v["spectrum"].shape == (16, 16)
    dispatch_key(eng, "g")
    eng.step(frame())
    assert eng.layers is None


def test_active_lr_toggle_changes_coord_training():
    """'9' flows into coord_step: the intended |Δw/Δg| adaptive rule
    produces different weights than the fixed lr (the reference's flag is
    dead code — backproplib.cu:34 — so default stays off)."""
    def run(active):
        eng = make_engine()
        eng.toggle_fft()               # coord mode
        if active:
            dispatch_key(eng, "9")
        assert eng.flags.active is active
        eng.toggle_training()
        for i in range(3):
            eng.step(frame(seed=i))
        return np.asarray(eng.params.stages[0].c)
    c_off, c_on = run(False), run(True)
    assert not np.allclose(c_off, c_on)


def test_fft_with_gpu_off_routes_to_cpu_coord_backprop():
    """gpu==0 falls through to the CPU coordinate backprop even with fft on,
    staying armed (autoencoder.cpp:182-200); the CPU path has no inertia."""
    eng = make_engine()
    dispatch_key(eng, "0")             # gpu off, fft still on
    assert eng.flags.fft and not eng.flags.gpu
    eng.toggle_training()
    old = np.asarray(eng.params.stages[0].c).copy()
    eng.step(frame())
    assert eng.flags.sel               # stays armed (not the one-shot burst)
    assert np.isfinite(eng.last_mse)
    assert not np.array_equal(np.asarray(eng.params.stages[0].c), old)


def test_prev_feature_reference_wrap_quirk():
    """'w' wraps feat==1 to M-1 (never reaching 0 going down), reproducing
    `(feat-1)>0 ? feat-1 : M-1` (autoencoder.cpp:277)."""
    eng = make_engine(m=4)
    eng.flags.feat = 1
    assert dispatch_key(eng, "w") == 3
    assert dispatch_key(eng, "w") == 2
    assert dispatch_key(eng, "w") == 1
    assert dispatch_key(eng, "w") == 3


def test_info_structure():
    eng = make_engine(nx=32)
    eng.add_layer()
    text = eng.info()
    assert "Network structure" in text
    assert "C=0" in text and "C=3" in text
    assert "S=2" in text and "S=-2" in text


def test_cli_train_and_info(tmp_path, capsys):
    from spectralae.cli.main import main
    main(["info", "--nx", "16", "--layers", "2", "--depth", "3"])
    out = capsys.readouterr().out
    assert "Network structure" in out
    metrics = tmp_path / "m.jsonl"
    main(["train", "--nx", "16", "--steps", "5", "--batch", "2",
          "--log-every", "1", "--metrics", str(metrics),
          "--ckpt", str(tmp_path / "ck")])
    lines = metrics.read_text().strip().splitlines()
    assert len(lines) == 5
    from spectralae.io import checkpoint as ckpt
    params, spec, opt, extra = ckpt.load(tmp_path / "ck")
    assert extra["step"] == 5


def test_cli_train_trace_writes_profile(tmp_path, capsys):
    from spectralae.cli.main import main
    trace_dir = tmp_path / "trace"
    main(["train", "--nx", "16", "--steps", "2", "--batch", "2",
          "--log-every", "1", "--trace", str(trace_dir)])
    capsys.readouterr()
    # jax.profiler writes plugins/profile/<ts>/*.xplane.pb under the dir
    assert list(trace_dir.rglob("*.xplane.pb")), "no trace artifacts"


def test_cli_run_with_scripted_keys(tmp_path, capsys):
    from spectralae.cli.main import main
    main(["run", "--nx", "16", "--frames", "4", "--keys", "1ifq",
          "--outdir", str(tmp_path), "--dump-every", "2"])
    out = capsys.readouterr().out
    assert "key '1' -> True" in out
    assert (tmp_path / "input_00000.png").exists()


def test_png_roundtrip(tmp_path):
    from spectralae.viz.png import write_png, read_png
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(9, 7, 3), dtype=np.uint8)
    write_png(tmp_path / "t.png", img)
    np.testing.assert_array_equal(read_png(tmp_path / "t.png"), img)
    gray = rng.integers(0, 256, size=(5, 6), dtype=np.uint8)
    write_png(tmp_path / "g.png", gray)
    np.testing.assert_array_equal(read_png(tmp_path / "g.png"), gray)


def test_cli_train_resume(tmp_path, capsys):
    from spectralae.cli.main import main
    main(["train", "--nx", "16", "--steps", "3", "--batch", "2",
          "--log-every", "1", "--ckpt", str(tmp_path / "ck")])
    main(["train", "--nx", "16", "--steps", "5", "--batch", "2",
          "--log-every", "1", "--resume", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert "resumed from" in out and '"step": 4' in out


def test_spectrum_view_matches_fft_magnitude():
    import numpy as np
    from spectralae.viz.spectrum import magnitude, shift_magnitude
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, 8)).astype(np.float32)
    spec = np.fft.rfft2(x)
    mag = magnitude(spec, 8, 8)
    full = np.abs(np.fft.fft2(x))
    np.testing.assert_allclose(mag, np.sqrt(full / x.size), rtol=1e-5, atol=1e-6)
    sh = shift_magnitude(mag)
    assert sh.shape == mag.shape
    np.testing.assert_allclose(sh[..., 4, 4], mag[..., 0, 0])


def test_direct_layer_selection_resets_opt_state():
    """Regression: switching focus pairs without select_layer must not
    carry mismatched momentum shapes into the coord train step."""
    eng = make_engine(nx=32)
    eng.add_layer()              # focus moves to pair 1 (8x8 inner)
    eng.flags.n_l = 0            # direct assignment, stale opt state
    eng.toggle_fft()             # coord mode
    eng.toggle_training()
    eng.step(frame(32))          # must not raise
    assert np.isfinite(eng.last_mse)
    eng2 = make_engine(nx=32)
    eng2.add_layer()
    eng2.select_layer(0)
    assert eng2._mom[0].shape == eng2.params.stages[0].c.shape


def test_direct_selection_between_same_shape_pairs_resets_opt_state():
    """Inner pairs of an M-uniform net share kernel shapes, so the old
    shape-equality guard let a direct n_l reassignment apply pair 1's
    accumulated momentum to pair 2 — the pair-index check must reset."""
    eng = make_engine(nx=64)
    eng.add_layer()
    eng.add_layer()              # pairs 1 and 2: same inner kernel shapes
    eng.select_layer(1)
    eng.toggle_fft()             # coord mode (momentum persists per step)
    eng.toggle_training()
    eng.step(frame(64))          # accumulates momentum for pair 1
    assert any(float(np.abs(np.asarray(t)).sum()) > 0 for t in eng._mom)
    enc1, _ = eng.params.pair(1)
    enc2, _ = eng.params.pair(2)
    assert enc1.c.shape == enc2.c.shape   # the guard can't rely on shape
    eng.flags.n_l = 2            # direct assignment, bypasses select_layer
    eng.step(frame(64))
    assert eng._mom_pair == 2    # state was re-zeroed for pair 2's step


def test_inner_layer_burst_trains_at_reduced_resolution():
    """'z' to the inner pair, then an fft burst at that pair's resolution."""
    eng = make_engine(nx=32)
    eng.add_layer()                 # inner pair at 8x8
    assert eng.flags.n_l == 1
    eng.step(frame(32))
    eng.toggle_training()
    old = np.asarray(eng.params.stages[1].c).copy()
    eng.step(frame(32))
    assert np.isfinite(eng.last_mse)
    assert not np.array_equal(np.asarray(eng.params.stages[1].c), old)
    # outer pair untouched
    eng2 = make_engine(nx=32)
    eng2.add_layer()
    np.testing.assert_array_equal(np.asarray(eng.params.stages[0].c),
                                  np.asarray(eng2.params.stages[0].c))


def test_cli_train_halts_on_divergence(tmp_path, capsys, monkeypatch):
    from spectralae.cli import main as cli
    calls = {"n": 0}
    from spectralae.train import modern

    class FakeRes:
        def __init__(self, loss, params, opt):
            self.loss = loss
            self.params = params
            self.opt = opt

    orig = modern.train_step

    def bad_step(params, opt, batch, scales, **kw):
        calls["n"] += 1
        import jax.numpy as jnp
        r = orig(params, opt, batch, scales, **kw)
        if calls["n"] >= 2:
            return FakeRes(jnp.float32(float("nan")), r.params, r.opt)
        return r

    monkeypatch.setattr("spectralae.train.modern.train_step", bad_step)
    cli.main(["train", "--nx", "16", "--steps", "10", "--batch", "2",
              "--log-every", "1"])
    out = capsys.readouterr().out
    assert "non-finite loss" in out
    assert calls["n"] == 2


def test_cli_train_divergence_keeps_finite_ckpt(tmp_path, capsys,
                                                monkeypatch):
    """NaN updates applied between log steps must never reach the final
    checkpoint — the trainer rolls back to the last log-step-verified
    params before saving (ADVICE r2, medium)."""
    import jax
    import jax.numpy as jnp
    from spectralae.cli import main as cli
    from spectralae.io import checkpoint as ckpt
    from spectralae.train import modern
    calls = {"n": 0}

    class FakeRes:
        def __init__(self, loss, params, opt):
            self.loss, self.params, self.opt = loss, params, opt

    orig = modern.train_step

    def bad_step(params, opt, batch, scales, **kw):
        calls["n"] += 1
        r = orig(params, opt, batch, scales, **kw)
        if calls["n"] >= 5:  # step_i >= 4: NaN loss AND NaN params
            nanp = jax.tree.map(lambda a: jnp.full_like(a, jnp.nan),
                                r.params)
            return FakeRes(jnp.float32(float("nan")), nanp, r.opt)
        return r

    monkeypatch.setattr("spectralae.train.modern.train_step", bad_step)
    ck = tmp_path / "ck"
    # log-every=3: NaN params are applied at steps 4-5 unchecked; the
    # step-6 check trips and must restore the step-3 snapshot
    cli.main(["train", "--nx", "16", "--steps", "10", "--batch", "2",
              "--log-every", "3", "--ckpt", str(ck)])
    out = capsys.readouterr().out
    assert "non-finite loss" in out
    params, _, _, extra = ckpt.load(ck)
    assert int(extra["step"]) == 3
    for leaf in jax.tree.leaves(params):
        assert np.all(np.isfinite(np.asarray(leaf)))


def _fake_cv2(keys, record):
    """A recording cv2 stub: window management + imshow + scripted
    waitKey returns (then Esc)."""
    import types
    mod = types.ModuleType("cv2")
    mod.WINDOW_NORMAL = 0

    class error(Exception):
        pass

    mod.error = error
    seq = list(keys) + [27]
    mod.namedWindow = lambda n, f=0: record.setdefault("windows", []
                                                       ).append(n)
    mod.moveWindow = lambda n, x, y: None
    mod.resizeWindow = lambda n, w, h: None
    mod.imshow = lambda n, img: record.setdefault("shown", []).append(
        (n, img.shape))
    mod.waitKey = lambda ms=0: (ord(seq.pop(0))
                                if isinstance(seq[0], str) else seq.pop(0))
    mod.destroyAllWindows = lambda: record.__setitem__("destroyed", True)
    return mod


def test_cli_run_gui_stubbed(monkeypatch, capsys):
    """run --gui drives the four reference windows and feeds waitKey
    through dispatch_key (autoencoder.cpp:55-66, 211-246); stub-tested
    like the camera (no display on the rig)."""
    import sys as _sys
    from spectralae.cli.main import main
    record = {}
    monkeypatch.setitem(_sys.modules, "cv2",
                        _fake_cv2(["i", "q"], record))
    main(["run", "--nx", "16", "--frames", "5", "--gui"])
    out = capsys.readouterr().out
    assert record["windows"] == ["input", "output", "feature map",
                                 "kernel"]
    shown = {n for n, _ in record["shown"]}
    assert shown == {"input", "output", "feature map", "kernel"}
    assert record["destroyed"] is True
    assert "key 'i'" in out          # dispatched through the KEYMAP
    # Esc broke the loop at frame 3 of 5 — no later frame may run
    assert "frame 3" not in out and "frame 4" not in out


def test_cli_run_gui_headless_exits_cleanly(monkeypatch):
    import sys as _sys
    import types
    from spectralae.cli.main import main
    mod = types.ModuleType("cv2")
    mod.WINDOW_NORMAL = 0

    class error(Exception):
        pass

    mod.error = error

    def boom(*a, **k):
        raise error("no display")

    mod.namedWindow = boom
    monkeypatch.setitem(_sys.modules, "cv2", mod)
    with pytest.raises(SystemExit, match="display"):
        main(["run", "--nx", "16", "--frames", "2", "--gui"])


def test_cli_train_burst_mode(tmp_path, capsys):
    import json as _json
    from spectralae.cli.main import main
    main(["train", "--nx", "16", "--steps", "2", "--batch", "2",
          "--mode", "burst", "--log-every", "1",
          "--ckpt", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert '"mseN"' in out
    # per-inner-iteration MSE stream (ref fft_backproplib.cu:1463-1464)
    rec = _json.loads(out.strip().splitlines()[0])
    assert len(rec["mses"]) == 101  # iters+1 trajectory
    assert rec["mses"][0] == rec["mse0"] and rec["mses"][-1] == rec["mseN"]
    from spectralae.io import checkpoint as ckpt
    params, spec, opt, extra = ckpt.load(tmp_path / "ck")
    assert extra["step"] == 2


def test_cli_train_stream_mode(tmp_path, capsys):
    """stream mode: K frames per on-device scan, per-frame burst MSEs
    logged, checkpoint written and resumable by eval."""
    import json as _json
    from spectralae.cli.main import main
    ck = tmp_path / "ck"
    main(["train", "--nx", "16", "--steps", "5", "--batch", "2",
          "--mode", "stream", "--stream-k", "3", "--iters", "6",
          "--log-every", "1", "--carry-momentum", "--ckpt", str(ck)])
    out = capsys.readouterr().out
    recs = [_json.loads(l) for l in out.splitlines() if l.startswith("{")]
    steps = [r["step"] for r in recs if "mseN" in r]
    assert steps == [0, 1, 2, 3, 4]      # 3-frame scan + 2-frame scan
    assert all(np.isfinite(r["mseN"]) for r in recs if "mseN" in r)
    assert (ck / "manifest.json").exists()
    main(["eval", "--from-ckpt", str(ck), "--steps", "1", "--batch", "1"])
    assert "psnr_db" in capsys.readouterr().out


def test_cli_train_stream_mode_all_sweep(tmp_path, capsys):
    """--mode stream --train-pair all: flush blocks round-robin the pairs
    (block 1 -> pair 0, block 2 -> pair 1, ...), every pair's params end
    up trained, and each block's MSEs fall."""
    import json as _json
    from spectralae.cli.main import main
    from spectralae.io import checkpoint as ckpt
    ck = tmp_path / "ck"
    main(["train", "--nx", "32", "--layers", "2", "--steps", "8",
          "--batch", "1", "--mode", "stream", "--stream-k", "2",
          "--iters", "6", "--train-pair", "all", "--log-every", "1",
          "--ckpt", str(ck)])
    out = capsys.readouterr().out
    recs = [_json.loads(l) for l in out.splitlines() if l.startswith("{")]
    recs = [r for r in recs if "mseN" in r]
    # 8 frames / 2 per block -> 4 blocks, pairs 0,1,0,1
    assert [r["pair"] for r in recs] == [0, 0, 1, 1, 0, 0, 1, 1]
    assert all(r["mseN"] < r["mse0"] for r in recs)
    params, spec, _, extra = ckpt.load(ck)
    assert int(extra["step"]) == 8
    ck0 = tmp_path / "ck0"
    main(["train", "--nx", "32", "--layers", "2", "--steps", "0",
          "--batch", "1", "--mode", "stream", "--train-pair", "all",
          "--ckpt", str(ck0)])
    capsys.readouterr()
    fresh, _, _, _ = ckpt.load(ck0)
    for i in range(len(params.stages)):
        assert not np.array_equal(np.asarray(params.stages[i].c),
                                  np.asarray(fresh.stages[i].c)), i


def test_cli_train_stream_coord_domain(tmp_path, capsys):
    """--mode stream --domain coord: one reference coord step per frame
    inside the scan; per-frame mse logged, training descends on a static
    scene (npy source), pairs round-robin with --train-pair all."""
    import json as _json
    from spectralae.cli.main import main
    from spectralae.io import checkpoint as ckpt
    rng = np.random.default_rng(0)
    frames = np.repeat(rng.integers(0, 255, size=(1, 32, 32, 3))
                       .astype(np.uint8), 12, axis=0)
    src = tmp_path / "frames.npy"
    np.save(src, frames)
    ck = tmp_path / "ck"
    main(["train", "--nx", "32", "--layers", "2", "--steps", "12",
          "--batch", "1", "--mode", "stream", "--domain", "coord",
          "--stream-k", "3", "--train-pair", "all", "--lr", "1.0",
          "--log-every", "1", "--carry-momentum",
          "--source", str(src), "--ckpt", str(ck)])
    out = capsys.readouterr().out
    recs = [_json.loads(l) for l in out.splitlines() if l.startswith("{")]
    recs = [r for r in recs if "mse" in r]
    assert [r["step"] for r in recs] == list(range(12))
    # blocks of 3 frames round-robin pairs 0,1,0,1
    assert [r["pair"] for r in recs] == [0] * 3 + [1] * 3 + [0] * 3 + [1] * 3
    assert all(np.isfinite(r["mse"]) for r in recs)
    params, spec, _, extra = ckpt.load(ck)
    assert int(extra["step"]) == 12
    ck0 = tmp_path / "ck0"
    main(["train", "--nx", "32", "--layers", "2", "--steps", "0",
          "--mode", "stream", "--domain", "coord", "--source", str(src),
          "--ckpt", str(ck0)])
    capsys.readouterr()
    fresh, _, _, _ = ckpt.load(ck0)
    for i in range(len(params.stages)):
        assert not np.array_equal(np.asarray(params.stages[i].c),
                                  np.asarray(fresh.stages[i].c)), i


def test_cli_stream_coord_descends_on_static_scene(tmp_path, capsys):
    """Single-pair coord streaming on a repeated frame: per-frame mse
    falls across the stream (the coord-domain steady-state loop)."""
    import json as _json
    from spectralae.cli.main import main
    rng = np.random.default_rng(3)
    frames = np.repeat(rng.integers(0, 255, size=(1, 32, 32, 3))
                       .astype(np.uint8), 24, axis=0)
    src = tmp_path / "frames.npy"
    np.save(src, frames)
    main(["train", "--nx", "32", "--steps", "24", "--batch", "1",
          "--mode", "stream", "--domain", "coord", "--stream-k", "6",
          "--train-pair", "0", "--lr", "0.2", "--log-every", "1",
          "--carry-momentum", "--source", str(src)])
    out = capsys.readouterr().out
    recs = [_json.loads(l) for l in out.splitlines() if l.startswith("{")]
    mses = [r["mse"] for r in recs if "mse" in r]
    assert len(mses) == 24
    assert mses[-1] < 0.5 * mses[0]     # measured: 18290 -> ~700 at lr=0.2


def test_cli_stream_coord_rejects_frame_sweep():
    from spectralae.cli.main import main
    with pytest.raises(SystemExit, match="momentum-domain only"):
        main(["train", "--nx", "16", "--steps", "2", "--mode", "stream",
              "--domain", "coord", "--train-pair", "all",
              "--pair-sweep", "frame"])


def test_cli_burst_mode_resume_and_history(tmp_path, capsys):
    """burst mode supports --resume (params + step from the checkpoint)
    and mid-run rotating history like the step trainer (SURVEY §5.4)."""
    import json as _json
    from spectralae.cli.main import main
    from spectralae.io import checkpoint as ckpt
    ck = tmp_path / "ck"
    main(["train", "--nx", "16", "--steps", "4", "--batch", "1",
          "--mode", "burst", "--iters", "4", "--log-every", "1",
          "--ckpt", str(ck), "--ckpt-every", "2", "--ckpt-history", "2"])
    out = capsys.readouterr().out
    assert (ck / "LATEST").exists()
    p1, _, _, extra = ckpt.load(ck)
    assert int(extra["step"]) == 4
    # resume with a mismatched CLI geometry: the checkpoint's wins (a
    # silent 256-frame pipeline against a 16x16 net would train at the
    # wrong resolution), and --ckpt-every 0 disables mid-run saves
    main(["train", "--nx", "256", "--steps", "7", "--batch", "1",
          "--mode", "burst", "--iters", "4", "--log-every", "1",
          "--ckpt-every", "0",
          "--resume", str(ck), "--ckpt", str(ck)])
    out = capsys.readouterr().out
    assert "resumed" in out
    assert "checkpoint's geometry 3x16x16" in out
    recs = [_json.loads(l) for l in out.splitlines() if l.startswith("{")]
    assert [r["step"] for r in recs if "mseN" in r] == [4, 5, 6]
    p2, spec2, _, extra = ckpt.load(ck)
    assert int(extra["step"]) == 7
    assert (spec2.nx, spec2.ny) == (16, 16)
    assert not np.array_equal(np.asarray(p1.stages[0].c),
                              np.asarray(p2.stages[0].c))


def test_cli_stream_mode_resume_and_midrun_ckpt(tmp_path, capsys):
    """stream mode: --ckpt-every saves at block granularity mid-run and
    --resume continues the step count and weights."""
    import json as _json
    from spectralae.cli.main import main
    from spectralae.io import checkpoint as ckpt
    ck = tmp_path / "ck"
    main(["train", "--nx", "16", "--steps", "4", "--batch", "1",
          "--mode", "stream", "--stream-k", "2", "--iters", "4",
          "--log-every", "1", "--ckpt", str(ck), "--ckpt-every", "2",
          "--ckpt-history", "3"])
    capsys.readouterr()
    hist = sorted(p.name for p in ck.iterdir() if p.is_dir())
    # mid-run saves at steps 2 and 4 (block granularity) + final at 4
    assert "step_00000002" in hist
    p1, _, _, extra = ckpt.load(ck)
    assert int(extra["step"]) == 4
    main(["train", "--nx", "16", "--steps", "8", "--batch", "1",
          "--mode", "stream", "--stream-k", "2", "--iters", "4",
          "--log-every", "1", "--resume", str(ck), "--ckpt", str(ck)])
    out = capsys.readouterr().out
    assert "resumed" in out
    recs = [_json.loads(l) for l in out.splitlines() if l.startswith("{")]
    assert [r["step"] for r in recs if "mseN" in r] == [4, 5, 6, 7]
    p2, _, _, extra = ckpt.load(ck)
    assert int(extra["step"]) == 8
    assert not np.array_equal(np.asarray(p1.stages[0].c),
                              np.asarray(p2.stages[0].c))


def test_cli_stream_pair0_trains_on_spectral_pooling(tmp_path, capsys):
    """--train-pair 0 at a non-unit pooling scale must train on the
    SPECTRAL pooling of the frame (forward_fft layers[1]) — the input
    burst mode, eval, and the forward pass all use — not a coordinate
    max-pool (regression: the old pair-0 fast path fed coord.pool)."""
    import jax.numpy as jnp
    from spectralae.cli.main import main
    from spectralae.core.config import Config
    from spectralae.data import pipeline
    from spectralae.io import checkpoint as ckpt
    from spectralae.model.engine import Engine
    from spectralae.train.streaming import fft_stream_pair
    ck = tmp_path / "ck"
    main(["train", "--nx", "32", "--steps", "2", "--batch", "1",
          "--mode", "stream", "--stream-k", "2", "--iters", "4",
          "--train-pair", "0", "--log-every", "1", "--ckpt", str(ck)])
    capsys.readouterr()
    got, spec, _, _ = ckpt.load(ck)
    assert abs(spec.scales[0]) != 1  # the case the fast path can't take

    eng = Engine(Config(nx=32, ny=32, d=3), seed=0)
    src = pipeline.synthetic_frames(32, 32, seed=0)
    xs = jnp.stack([pipeline.frame_to_tensor(
        pipeline.resize_nn(next(src), 32, 32))[None] for _ in range(2)])
    want = fft_stream_pair(xs, eng.params, eng.spec.scales, 0, iters=4,
                           carry_momentum=False)
    np.testing.assert_allclose(np.asarray(got.stages[0].c),
                               np.asarray(want.c), rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(got.stages[-1].c),
                               np.asarray(want.f), rtol=2e-5, atol=1e-6)


def test_cli_train_stream_frame_sweep(tmp_path, capsys):
    """--pair-sweep frame: every pair trains on every frame — per-frame
    log rows for ALL pairs, every pair's params trained, MSEs fall."""
    import json as _json
    from spectralae.cli.main import main
    from spectralae.io import checkpoint as ckpt
    ck = tmp_path / "ck"
    main(["train", "--nx", "32", "--layers", "2", "--steps", "4",
          "--batch", "1", "--mode", "stream", "--stream-k", "2",
          "--iters", "6", "--train-pair", "all", "--pair-sweep", "frame",
          "--log-every", "1", "--carry-momentum", "--ckpt", str(ck)])
    out = capsys.readouterr().out
    recs = [_json.loads(l) for l in out.splitlines() if l.startswith("{")]
    recs = [r for r in recs if "mseN" in r]
    # every frame logs both pairs, in sweep order
    assert [(r["step"], r["pair"]) for r in recs] == \
        [(0, 0), (0, 1), (1, 0), (1, 1), (2, 0), (2, 1), (3, 0), (3, 1)]
    assert all(r["mseN"] < r["mse0"] for r in recs)
    params, spec, _, extra = ckpt.load(ck)
    assert int(extra["step"]) == 4
    ck0 = tmp_path / "ck0"
    main(["train", "--nx", "32", "--layers", "2", "--steps", "0",
          "--batch", "1", "--mode", "stream", "--train-pair", "all",
          "--ckpt", str(ck0)])
    capsys.readouterr()
    fresh, _, _, _ = ckpt.load(ck0)
    for i in range(len(params.stages)):
        assert not np.array_equal(np.asarray(params.stages[i].c),
                                  np.asarray(fresh.stages[i].c)), i


def test_cli_train_frame_sweep_requires_all():
    from spectralae.cli.main import main
    with pytest.raises(SystemExit, match="pair-sweep frame"):
        main(["train", "--nx", "16", "--steps", "2", "--mode", "stream",
              "--train-pair", "0", "--pair-sweep", "frame"])


def test_cli_train_stream_mode_inner_pair(tmp_path, capsys):
    """--mode stream --train-pair 1: the inner pair's activation is
    computed from the frozen outer stages inside the scan; only the inner
    pair's params change and its within-frame MSEs fall."""
    import json as _json
    from spectralae.cli.main import main
    from spectralae.io import checkpoint as ckpt
    ck = tmp_path / "ck"
    main(["train", "--nx", "32", "--layers", "2", "--steps", "4",
          "--batch", "2", "--mode", "stream", "--stream-k", "2",
          "--iters", "6", "--train-pair", "1", "--log-every", "1",
          "--carry-momentum", "--ckpt", str(ck)])
    out = capsys.readouterr().out
    recs = [_json.loads(l) for l in out.splitlines() if l.startswith("{")]
    recs = [r for r in recs if "mseN" in r]
    assert [r["step"] for r in recs] == [0, 1, 2, 3]
    assert all(r["pair"] == 1 for r in recs)
    assert all(r["mseN"] < r["mse0"] for r in recs)
    params, spec, _, extra = ckpt.load(ck)
    assert int(extra["step"]) == 4
    # outer pair untouched: equals the same CLI config's fresh params
    # (a 0-step run checkpoints the engine's initial weights)
    ck0 = tmp_path / "ck0"
    main(["train", "--nx", "32", "--layers", "2", "--steps", "0",
          "--batch", "2", "--mode", "stream", "--train-pair", "1",
          "--ckpt", str(ck0)])
    capsys.readouterr()
    fresh, _, _, _ = ckpt.load(ck0)
    np.testing.assert_array_equal(np.asarray(params.stages[0].c),
                                  np.asarray(fresh.stages[0].c))
    assert not np.array_equal(np.asarray(params.stages[1].c),
                              np.asarray(fresh.stages[1].c))


def test_cli_train_stream_finite_source_trains_remainder(tmp_path,
                                                         capsys):
    """A finite source ending mid-block must not drop buffered frames —
    the partial block trains (5-frame .npy, stream-k 4 -> blocks 4+1)."""
    import json as _json
    frames = np.random.default_rng(0).integers(
        0, 255, size=(5, 16, 16, 3)).astype(np.uint8)
    src = tmp_path / "v.npy"
    np.save(src, frames)
    from spectralae.cli.main import main
    main(["train", "--nx", "16", "--steps", "100", "--batch", "1",
          "--mode", "stream", "--stream-k", "4", "--iters", "4",
          "--log-every", "1", "--source", str(src),
          "--ckpt", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    recs = [_json.loads(l) for l in out.splitlines() if l.startswith("{")]
    steps = [r["step"] for r in recs if "mseN" in r]
    assert steps == [0, 1, 2, 3, 4]   # all 5 frames trained
    from spectralae.io import checkpoint as ckpt
    _, _, _, extra = ckpt.load(tmp_path / "ck")
    assert int(extra["step"]) == 5


def test_cli_burst_divergence_rolls_back(tmp_path, capsys, monkeypatch):
    """A non-finite burst trajectory halts burst mode and the final
    checkpoint rolls back to the last log-verified params (§5.3, mirroring
    the steps trainer's divergence guarantee)."""
    import jax
    import jax.numpy as jnp
    from spectralae.cli.main import main
    from spectralae.io import checkpoint as ckpt
    from spectralae.train import fft_dp
    calls = {"n": 0}
    orig = fft_dp.fft_burst_dp

    def bad(*a, **kw):
        calls["n"] += 1
        r = orig(*a, **kw)
        if calls["n"] >= 3:     # bursts 1-2 fine; burst 3 diverges
            return r._replace(c=jnp.full_like(r.c, jnp.nan),
                              mses=jnp.full_like(r.mses, jnp.nan))
        return r

    monkeypatch.setattr("spectralae.train.fft_dp.fft_burst_dp", bad)
    ck = tmp_path / "ck"
    main(["train", "--nx", "16", "--steps", "5", "--batch", "1",
          "--mode", "burst", "--iters", "4", "--log-every", "1",
          "--ckpt", str(ck)])
    out = capsys.readouterr().out
    assert "non-finite mse" in out
    assert calls["n"] == 3      # halted at the diverged burst
    params, _, _, extra = ckpt.load(ck)
    assert int(extra["step"]) == 2
    for leaf in jax.tree.leaves(params):
        assert np.all(np.isfinite(np.asarray(leaf)))


def test_cli_stream_divergence_keeps_finite_ckpt(tmp_path, capsys,
                                                 monkeypatch):
    """A non-finite per-frame MSE inside a stream block halts stream mode;
    the block's (poisoned) weights are discarded and the checkpoint keeps
    the block-start params."""
    import jax
    import jax.numpy as jnp
    from spectralae.cli.main import main
    from spectralae.io import checkpoint as ckpt
    from spectralae.train import streaming
    calls = {"n": 0}
    # pair 0 at the default scale-2 pooling routes through the pair path
    orig = streaming.fft_stream_pair

    def bad(*a, **kw):
        calls["n"] += 1
        r = orig(*a, **kw)
        if calls["n"] >= 2:     # block 1 fine; block 2 diverges
            return r._replace(c=jnp.full_like(r.c, jnp.nan),
                              mses=jnp.full_like(r.mses, jnp.nan))
        return r

    monkeypatch.setattr("spectralae.train.streaming.fft_stream_pair", bad)
    ck = tmp_path / "ck"
    main(["train", "--nx", "16", "--steps", "6", "--batch", "1",
          "--mode", "stream", "--stream-k", "2", "--iters", "4",
          "--log-every", "1", "--ckpt", str(ck)])
    out = capsys.readouterr().out
    assert "non-finite mse" in out
    params, _, _, extra = ckpt.load(ck)
    assert int(extra["step"]) == 2      # only block 1's frames applied
    for leaf in jax.tree.leaves(params):
        assert np.all(np.isfinite(np.asarray(leaf)))


def test_cli_train_burst_trains_selected_pair_at_pooled_resolution(
        tmp_path, capsys):
    """--train-pair selects the pair; the burst consumes the pair's pooled
    activations (the burst's two-stage model is pool-free), so only that
    pair's params change and the run converges."""
    import json as _json
    from spectralae.cli.main import main
    from spectralae.io import checkpoint as ckpt
    main(["train", "--nx", "32", "--layers", "2", "--steps", "2",
          "--batch", "2", "--mode", "burst", "--log-every", "1",
          "--train-pair", "1", "--carry-momentum",
          "--ckpt", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    recs = [_json.loads(l) for l in out.strip().splitlines()
            if l.startswith("{")]
    assert recs[0]["pair"] == 1
    assert all(np.isfinite(r["mseN"]) for r in recs)
    params, spec, _, _ = ckpt.load(tmp_path / "ck")
    # outer pair untouched: matches a freshly-built engine's init
    from spectralae.cli.main import _make_engine
    import argparse as _ap
    args = _ap.Namespace(nx=32, ny=32, depth=3, param_file=None, seed=0,
                         layers=2)
    eng = _make_engine(args)
    np.testing.assert_array_equal(np.asarray(params.stages[0].c),
                                  np.asarray(eng.params.stages[0].c))
    assert not np.array_equal(np.asarray(params.stages[1].c),
                              np.asarray(eng.params.stages[1].c))
    import pytest as _pytest
    with _pytest.raises(SystemExit):
        main(["train", "--nx", "16", "--steps", "1", "--batch", "1",
              "--mode", "burst", "--train-pair", "3"])


def test_train_demo_example(tmp_path):
    import sys, pathlib
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                           / "examples"))
    import train_demo
    err0, err1 = train_demo.main(["--nx", "16", "--depth", "4",
                                  "--bursts", "3", "--iters", "30",
                                  "--outdir", str(tmp_path)])
    assert err1 < err0
    assert (tmp_path / "recon_after.png").exists()
    assert (tmp_path / "mse.csv").exists()


def test_stream_demo_example(tmp_path):
    import sys, pathlib
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                           / "examples"))
    import stream_demo
    err0, err1 = stream_demo.main(["--nx", "16", "--frames", "4",
                                   "--layers", "2", "--iters", "20",
                                   "--outdir", str(tmp_path)])
    assert err1 < err0
    assert (tmp_path / "recon_after.png").exists()
    # single-pair variant too
    err0, err1 = stream_demo.main(["--nx", "16", "--frames", "3",
                                   "--layers", "1", "--iters", "20",
                                   "--outdir", str(tmp_path)])
    assert err1 < err0


def test_engine_full_checkpoint_roundtrip(tmp_path):
    eng = make_engine(nx=32)
    eng.add_layer()
    eng.step(frame(32))
    eng.save_checkpoint(tmp_path / "full")
    want = np.asarray(eng.params.stages[1].c).copy()
    eng2 = make_engine(nx=32)
    eng2.load_checkpoint(tmp_path / "full")
    assert eng2.spec.n_pairs == 2
    np.testing.assert_array_equal(np.asarray(eng2.params.stages[1].c), want)
    out = eng2.step(frame(32))
    assert out.shape == (3, 32, 32)


def test_encode_matches_forward_prefix():
    import jax.numpy as jnp
    from spectralae.model import autoencoder as model
    eng = make_engine(nx=16)
    x = jnp.asarray(frame())[None]
    for domain in ("fft", "coord"):
        z = model.encode(eng.params, x, eng.spec.scales, domain=domain,
                         tap_mode="centered")
        assert z.shape == (1, 4, 8, 8)
    acts = model.forward_coord(eng.params, x, eng.spec.scales,
                               tap_mode="centered")
    z = model.encode(eng.params, x, eng.spec.scales, domain="coord",
                     tap_mode="centered")
    np.testing.assert_allclose(np.asarray(z), np.asarray(acts[2]),
                               rtol=1e-5, atol=1e-5)


def test_ansi_renderer():
    from spectralae.viz.ansi import render_image, render_dashboard
    img = np.zeros((8, 8, 3), np.uint8)
    img[0, 0] = [255, 0, 0]
    s = render_image(img)
    assert "\x1b[38;2;255;0;0m" in s and s.count("\n") == 3
    gray = np.full((4, 4), 128, np.uint8)
    s2 = render_image(gray)
    assert "\x1b[38;2;128;128;128m" in s2
    eng = make_engine()
    eng.step(frame())
    dash = render_dashboard(eng.current_views(), "status line")
    assert dash.startswith("status line")
    assert "input" in dash and "kernel" in dash


def test_tui_loop_runs_and_quits(monkeypatch):
    """Drive the TUI loop headlessly: fake termios/keys, capture frames."""
    import io
    import types
    from spectralae.cli import tui
    eng = make_engine()
    src = pipeline.synthetic_frames(16, 16, seed=0)
    keys = iter(["1", None, "\x1b"])
    monkeypatch.setattr(tui, "_read_key", lambda timeout=0.0: next(keys))
    fake_termios = types.SimpleNamespace(
        tcgetattr=lambda fd: None,
        tcsetattr=lambda fd, how, attrs: None, TCSADRAIN=0)
    monkeypatch.setitem(__import__("sys").modules, "termios", fake_termios)
    monkeypatch.setitem(__import__("sys").modules, "tty",
                        types.SimpleNamespace(setcbreak=lambda fd: None))
    out = io.StringIO()
    tui.run_tui(eng, src, nx=16, ny=16, frames=10, out=out)
    text = out.getvalue()
    assert "frame 0" in text and "frame 2" in text
    assert "frame 3" not in text          # Esc on the third frame quit
    # key '1' after frame 0 armed training; the fft burst ran during
    # frame 1's step (and auto-disarmed), leaving a finite mse in status
    assert "mse nan" in text.split("frame 1")[0]
    assert "mse nan" not in text.split("frame 1")[1]


def test_cli_train_bf16_leaky(tmp_path, capsys):
    from spectralae.cli.main import main
    main(["train", "--nx", "16", "--steps", "3", "--batch", "2",
          "--domain", "coord", "--bf16", "--activation", "leaky_relu",
          "--log-every", "1"])
    out = capsys.readouterr().out
    import json as _json
    losses = [_json.loads(l)["loss"] for l in out.strip().splitlines()
              if l.startswith("{")]
    assert len(losses) == 3 and all(np.isfinite(losses))


def test_indivisible_pooling_rejected():
    from spectralae.core.config import Config, LayerParams
    from spectralae.core.types import initial_spec
    cfg = Config(nx=30, ny=30, d=3,
                 layer=LayerParams(depth=4, lk=0, ll=0, scale=4, rmax=1.0))
    with pytest.raises(ValueError, match="does not divide"):
        initial_spec(cfg)
    # the add_pair path enforces the same check: inner grid shrinks
    # 8 -> 4 -> 2 -> 1; the next x2 pair cannot divide 1x1
    eng = make_engine(nx=16)
    eng.add_layer()
    eng.add_layer()
    eng.add_layer()
    with pytest.raises(ValueError, match="does not divide"):
        eng.add_layer()


def test_cli_train_burst_all_pairs(tmp_path, capsys):
    """--train-pair all sweeps every pair per batch (the manual 'z'/'x'+'1'
    workflow), training both pairs."""
    import json as _json
    from spectralae.cli.main import main, _make_engine
    from spectralae.io import checkpoint as ckpt
    import argparse as _ap
    main(["train", "--nx", "32", "--layers", "2", "--steps", "2",
          "--batch", "2", "--mode", "burst", "--log-every", "1",
          "--train-pair", "all", "--iters", "20",
          "--ckpt", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    recs = [_json.loads(l) for l in out.strip().splitlines()
            if l.startswith("{")]
    assert {r["pair"] for r in recs} == {0, 1}
    params, spec, _, _ = ckpt.load(tmp_path / "ck")
    args = _ap.Namespace(nx=32, ny=32, depth=3, param_file=None, seed=0,
                         layers=2)
    eng = _make_engine(args)
    for i in (0, 1):
        assert not np.array_equal(np.asarray(params.stages[i].c),
                                  np.asarray(eng.params.stages[i].c))


def test_cli_doctor(capsys):
    import json as _json
    from spectralae.cli.main import main
    main(["doctor", "--no-device"])
    info = _json.loads(capsys.readouterr().out)
    assert info["backend"] and info["devices"]
    assert set(info["native_lib"]) == {"available", "batch_stage",
                                       "yuv_decode", "png_unfilter"}
    main(["doctor"])
    info = _json.loads(capsys.readouterr().out)
    assert info["device_check"]["ok"] is True


def test_cli_doctor_reports_hung_backend(capsys, monkeypatch):
    """A device whose driver does not answer can hang PJRT init; doctor
    must report within --device-timeout instead of hanging, and skip the
    device round-trip.  The probe's first backend call is blocked to
    simulate the hang; the real thread+deadline machinery runs."""
    import json as _json
    import threading
    import jax
    from spectralae.cli.main import main

    # the leaked daemon thread parks here until interpreter exit
    monkeypatch.setattr(jax, "default_backend",
                        lambda: threading.Event().wait())
    main(["doctor", "--device-timeout", "0.2"])
    info = _json.loads(capsys.readouterr().out)
    assert "hung" in info["backend_error"]
    assert "device_check" not in info
    assert info["native_lib"]["available"] in (True, False)


def test_patch_smaller_capped_at_one_pixel():
    """'2' must not shrink the training crop below 1 px (the reference
    increments unbounded and degenerates — quirk-fixed)."""
    from spectralae.core.config import Config, LayerParams
    from spectralae.model.engine import Engine
    eng = Engine(Config(nx=16, ny=16, d=2,
                        layer=LayerParams(depth=4, lk=0, ll=0, scale=2,
                                          rmax=0.5)))
    for _ in range(50):
        eng.patch_smaller()
    assert eng.flags.q <= 8  # pooled activation is 8x8
    # still trainable: one armed fft step must not crash or NaN
    eng.flags.sel = True
    eng.step(np.zeros((2, 16, 16), np.float32) + 10.0)
    assert np.isfinite(eng.last_mse)


def test_add_drop_layer_resets_feature_index():
    import dataclasses
    from spectralae.core.config import Config, LayerParams
    from spectralae.model.engine import Engine
    eng = Engine(Config(nx=16, ny=16, d=2,
                        layer=LayerParams(depth=10, lk=0, ll=0, scale=2,
                                          rmax=0.5)))
    for _ in range(8):
        eng.next_feature()
    assert eng.flags.feat == 8
    eng.add_layer(dataclasses.replace(eng.cfg.layer, depth=4, scale=1))
    assert eng.flags.feat == 0
    eng.step(np.zeros((2, 16, 16), np.float32))
    eng.current_views()  # would IndexError with a stale feat >= new M
    for _ in range(3):
        eng.next_feature()
    eng.drop_layer()
    assert eng.flags.feat == 0


def test_cli_train_final_ckpt_stamps_reached_step(tmp_path, capsys):
    """An exhausted source must not fake completion in the checkpoint."""
    from spectralae.cli import main as cli
    src = tmp_path / "v.npy"
    np.save(src, np.zeros((6, 16, 16, 3), np.uint8))
    cli.main(["train", "--nx", "16", "--steps", "100", "--batch", "2",
              "--source", str(src), "--ckpt", str(tmp_path / "ck"),
              "--log-every", "1"])
    capsys.readouterr()
    from spectralae.io import checkpoint as ckpt
    _, _, _, extra = ckpt.load(tmp_path / "ck")
    assert extra["step"] == 3  # 6 frames / batch 2, not 100


def test_engine_survives_random_key_mashing(tmp_path, monkeypatch):
    """Monkey test: 120 random key presses interleaved with steps must
    never crash the engine (failed commands raise the documented
    ValueError/OSError only) and must leave it in a steppable state."""
    import random
    from spectralae.core.config import Config, LayerParams
    from spectralae.model.engine import Engine, KEYMAP, dispatch_key
    monkeypatch.chdir(tmp_path)  # 's' writes ./weights here
    rng = random.Random(0)
    eng = Engine(Config(nx=16, ny=16, d=2,
                        layer=LayerParams(depth=4, lk=0, ll=0, scale=2,
                                          rmax=0.5)))
    keys = list(KEYMAP)
    frame = np.zeros((2, 16, 16), np.float32) + 7.0
    for i in range(120):
        k = rng.choice(keys)
        try:
            dispatch_key(eng, k)
        except (ValueError, OSError):
            pass  # documented failure modes (bad load, non-divisible 'n')
        if i % 10 == 0:
            out = eng.step(frame)
            assert np.isfinite(out).all()
            eng.current_views()
    out = eng.step(frame)
    assert out.shape == (2, 16, 16)
