"""AOT export/serving artifact tests (spectralae.io.export)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from spectralae.core.config import Config, LayerParams
from spectralae.core.types import initial_spec, init_params
from spectralae.io import checkpoint as ckpt
from spectralae.io import export as export_mod
from spectralae.io.export import ServingModel, export_model
from spectralae.model import autoencoder as model

ROOT = Path(__file__).resolve().parents[1]


def _small_net(nx=32, layers=1, seed=0):
    cfg = Config(nx=nx, ny=nx, d=3,
                 layer=LayerParams(depth=4, lk=1, ll=1, scale=2, rmax=1.0))
    spec = initial_spec(cfg)
    for _ in range(layers - 1):
        spec = spec.add_pair(cfg.layer)
    params = init_params(jax.random.key(seed), spec, 1.0)
    return cfg, spec, params


@pytest.mark.parametrize("what,domain", [("forward", "fft"),
                                         ("forward", "coord"),
                                         ("encode", "fft")])
def test_export_roundtrip_matches_direct(tmp_path, what, domain):
    _, spec, params = _small_net()
    path = export_model(params, spec, tmp_path / "art", what=what,
                        domain=domain, batch=2)
    m = ServingModel.load(path)
    x = jnp.asarray(np.random.default_rng(0).normal(
        size=(2, 3, 32, 32)).astype(np.float32) * 50)
    got = m(x)
    if what == "forward" and domain == "fft":
        want = model.forward_fft(params, x, spec.scales)
    elif what == "forward":
        # coord exports default to the engine's training tap window
        # (ref_gpu), not the library-default centered taps
        want = model.forward_coord(params, x, spec.scales,
                                   tap_mode="ref_gpu")[-1]
    else:
        want = model.encode(params, x, spec.scales, domain=domain)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-4)


def test_export_coord_tap_mode_recorded_and_overridable(tmp_path):
    """A coord artifact computes the taps the net was trained with: the
    default is the engine's ref_gpu window, an explicit tap_mode wins,
    and the manifest records the choice (ADVICE-class parity bug: the
    old export silently fell back to centered taps)."""
    _, spec, params = _small_net()
    x = jnp.asarray(np.random.default_rng(1).normal(
        size=(1, 3, 32, 32)).astype(np.float32) * 50)
    art = export_model(params, spec, tmp_path / "gpu", what="forward",
                       domain="coord", batch=1)
    m = ServingModel.load(art)
    assert m.manifest["tap_mode"] == "ref_gpu"
    np.testing.assert_allclose(
        np.asarray(m(x)),
        np.asarray(model.forward_coord(params, x, spec.scales,
                                       tap_mode="ref_gpu")[-1]),
        rtol=1e-5, atol=1e-4)
    art2 = export_model(params, spec, tmp_path / "cen", what="forward",
                        domain="coord", batch=1, tap_mode="centered")
    m2 = ServingModel.load(art2)
    assert m2.manifest["tap_mode"] == "centered"
    np.testing.assert_allclose(
        np.asarray(m2(x)),
        np.asarray(model.forward_coord(params, x, spec.scales)[-1]),
        rtol=1e-5, atol=1e-4)
    # the two windows genuinely differ — the parity bug was observable
    assert not np.allclose(np.asarray(m(x)), np.asarray(m2(x)),
                           rtol=1e-3, atol=1e-2)


def test_export_symbolic_batch_serves_any_batch(tmp_path):
    _, spec, params = _small_net()
    path = export_model(params, spec, tmp_path / "art", batch=None)
    m = ServingModel.load(path)
    rng = np.random.default_rng(1)
    for b in (1, 3, 5):
        x = jnp.asarray(rng.normal(size=(b, 3, 32, 32)).astype(np.float32))
        got = m(x)
        want = model.forward_fft(params, x, spec.scales)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-5, atol=1e-4)


def test_export_fixed_batch_rejects_other_batch(tmp_path):
    _, spec, params = _small_net()
    path = export_model(params, spec, tmp_path / "art", batch=2)
    m = ServingModel.load(path)
    with pytest.raises(ValueError, match="batch=2"):
        m(jnp.zeros((3, 3, 32, 32), jnp.float32))
    with pytest.raises(ValueError, match="expected input"):
        m(jnp.zeros((2, 3, 16, 16), jnp.float32))


def test_export_multiplatform_lowering(tmp_path):
    """Cross-platform artifact: lowered for both cpu and cuda on a CPU host."""
    _, spec, params = _small_net()
    path = export_model(params, spec, tmp_path / "art", batch=1,
                        platforms=("cpu", "cuda"))
    manifest = json.loads((path / "manifest.json").read_text())
    assert set(p.lower() for p in manifest["platforms"]) == {"cpu", "cuda"}
    m = ServingModel.load(path)
    x = jnp.ones((1, 3, 32, 32), jnp.float32)
    got = m(x)
    want = model.forward_fft(params, x, spec.scales)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("batch", [None, 2])
@pytest.mark.parametrize("platforms", [None, ("cpu", "cuda")])
def test_signature_round_trip(batch, platforms):
    """The manifest's signature rebuilds the Exported that was lowered."""
    _, spec, params = _small_net()
    if batch is None:
        (b,) = jax.export.symbolic_shape("b")
    else:
        b = batch
    kw = {} if platforms is None else {"platforms": platforms}
    ex = jax.export.export(jax.jit(
        lambda v: model.forward_fft(params, v, spec.scales)), **kw)(
        jax.ShapeDtypeStruct((b, 3, 32, 32), jnp.float32))
    sig = json.loads(json.dumps(export_mod._signature(ex)))
    got = export_mod._exported(sig, ex.mlir_module_serialized)
    for field in ("fun_name", "in_tree", "out_tree", "platforms",
                  "nr_devices", "calling_convention_version",
                  "module_kept_var_idx", "uses_global_constants",
                  "mlir_module_serialized"):
        assert getattr(got, field) == getattr(ex, field), field
    # symbolic dimensions of two scopes never compare equal: compare text
    for field in ("in_avals", "out_avals"):
        assert str(getattr(got, field)) == str(getattr(ex, field)), field
    x = jnp.asarray(np.random.default_rng(2).normal(
        size=(2, 3, 32, 32)).astype(np.float32))
    np.testing.assert_array_equal(np.asarray(got.call(x)),
                                  np.asarray(ex.call(x)))


def test_signature_rejects_non_serving_function():
    ex = jax.export.export(jax.jit(lambda v: (v, 2 * v)))(
        jax.ShapeDtypeStruct((2, 3), jnp.float32))
    with pytest.raises(ValueError, match="one array"):
        export_mod._signature(ex)


def test_load_rejects_other_format_version(tmp_path):
    _, spec, params = _small_net()
    path = export_model(params, spec, tmp_path / "art", batch=1)
    manifest = json.loads((path / "manifest.json").read_text())
    manifest["format_version"] = 1
    (path / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="format version 1"):
        ServingModel.load(path)


_NO_FLATBUFFERS = """
import sys
sys.modules["flatbuffers"] = None      # import flatbuffers -> ImportError
import numpy as np, jax, jax.numpy as jnp
from spectralae.io.export import ServingModel
m = ServingModel.load(sys.argv[1])
b = m.manifest["batch"] or 3
x = np.random.default_rng(0).normal(size=(b, 3, 32, 32)).astype(np.float32)
np.save(sys.argv[2], np.asarray(m(jnp.asarray(x))))
np.save(sys.argv[3], x)
"""


@pytest.mark.parametrize("batch", [None, 2])
def test_artifact_serves_without_flatbuffers(tmp_path, batch):
    """An artifact loads and runs in a process that cannot import
    ``flatbuffers``, which jax.export's own serialization needs."""
    _, spec, params = _small_net()
    path = export_model(params, spec, tmp_path / "art", batch=batch,
                        platforms=("cpu", "cuda"))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out, inp = tmp_path / "out.npy", tmp_path / "in.npy"
    subprocess.run([sys.executable, "-c", _NO_FLATBUFFERS, str(path),
                    str(out), str(inp)], cwd=ROOT, env=env, check=True,
                   timeout=300)
    x = jnp.asarray(np.load(inp))
    np.testing.assert_allclose(
        np.load(out), np.asarray(model.forward_fft(params, x, spec.scales)),
        rtol=1e-5, atol=1e-4)


def test_cli_export_and_serve(tmp_path, capsys):
    from spectralae.cli.main import main as cli_main
    _, spec, params = _small_net()
    ck = tmp_path / "ck"
    ckpt.save(ck, params, spec, None)
    art = tmp_path / "art"
    cli_main(["export", "--from-ckpt", str(ck), "--out", str(art),
              "--what", "both", "--nx", "32"])
    out = capsys.readouterr().out
    assert "exported forward" in out and "exported encode" in out
    # 'both' writes per-function subdirectories, each with its own
    # manifest (ADVICE r2: a shared dir orphaned the forward artifact)
    assert (art / "forward" / "manifest.json").exists()
    assert (art / "encode" / "manifest.json").exists()
    # serving from the root resolves the forward artifact...
    cli_main(["serve", "--model", str(art), "--steps", "2", "--batch", "2",
              "--outdir", str(tmp_path / "views"), "--dump-every", "1"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["frames"] == 4 and rec["what"] == "forward"
    assert (tmp_path / "views" / "serve_00000.png").exists()
    # ...and the encode artifact is addressable by its subdirectory
    cli_main(["serve", "--model", str(art / "encode"), "--steps", "1",
              "--batch", "1", "--outdir", str(tmp_path / "views2")])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["what"] == "encode"


def test_cli_eval_ckpt_and_artifact(tmp_path, capsys):
    """eval reports per-pixel MSE/PSNR from both a checkpoint and a
    forward artifact; a trained ckpt beats a random-init net."""
    from spectralae.cli.main import main as cli_main
    # train a few steps at 16^2 so reconstruction correlates with input
    ck = tmp_path / "ck"
    cli_main(["train", "--nx", "16", "--steps", "30", "--batch", "2",
              "--log-every", "30", "--ckpt", str(ck)])
    capsys.readouterr()
    cli_main(["eval", "--from-ckpt", str(ck), "--steps", "3",
              "--batch", "2"])
    rec_ck = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec_ck["frames"] == 6 and rec_ck["mse_per_pixel"] > 0
    cli_main(["eval", "--nx", "16", "--steps", "3", "--batch", "2"])
    rec_fresh = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec_ck["mse_per_pixel"] < rec_fresh["mse_per_pixel"]
    # artifact route agrees with the ckpt route on the same source
    art = tmp_path / "art"
    cli_main(["export", "--from-ckpt", str(ck), "--out", str(art),
              "--what", "forward"])
    capsys.readouterr()
    cli_main(["eval", "--model", str(art), "--steps", "3", "--batch", "2"])
    rec_art = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert abs(rec_art["mse_per_pixel"] - rec_ck["mse_per_pixel"]) \
        < 1e-3 * max(rec_ck["mse_per_pixel"], 1.0)


def test_http_inference_server(tmp_path):
    """The HTTP endpoint serves the artifact: healthz manifest, npy
    round-trip inference (batch and single-frame), input validation."""
    import io as _io
    import urllib.request
    import urllib.error
    from spectralae.io.server import InferenceServer

    _, spec, params = _small_net()
    path = export_model(params, spec, tmp_path / "art", what="forward",
                        domain="fft", batch=None)  # polymorphic batch
    m = ServingModel.load(path)
    srv = InferenceServer(m, port=0)
    srv.start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            h = json.loads(r.read())
        assert h["status"] == "ok" and h["input_shape"] == [3, 32, 32]

        x = (np.random.default_rng(1).normal(size=(2, 3, 32, 32))
             .astype(np.float32) * 50)
        buf = _io.BytesIO(); np.save(buf, x)
        req = urllib.request.Request(f"{base}/infer", data=buf.getvalue(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            out = np.load(_io.BytesIO(r.read()), allow_pickle=False)
        np.testing.assert_allclose(out, np.asarray(m(x)), rtol=1e-5,
                                   atol=1e-4)

        # single frame squeezes back to [D, H, W]
        buf = _io.BytesIO(); np.save(buf, x[0])
        req = urllib.request.Request(f"{base}/infer", data=buf.getvalue(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            out1 = np.load(_io.BytesIO(r.read()), allow_pickle=False)
        assert out1.shape == (3, 32, 32)
        np.testing.assert_allclose(out1, out[0], rtol=1e-5, atol=1e-4)

        # wrong shape -> 400 with a JSON error
        buf = _io.BytesIO(); np.save(buf, np.zeros((2, 5, 5), np.float32))
        req = urllib.request.Request(f"{base}/infer", data=buf.getvalue(),
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=30)
        assert ei.value.code == 400
        # unknown route -> 404
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/nope", timeout=30)
        assert ei.value.code == 404
    finally:
        srv.shutdown()


def test_http_server_fixed_batch_and_size_limit(tmp_path):
    """Review fixes: fixed-batch mismatch surfaces as a 400 JSON error (not
    a dropped connection), healthz exposes the required batch, and
    oversized requests are rejected 413 before buffering."""
    import io as _io
    import urllib.request
    import urllib.error
    from spectralae.io.server import InferenceServer

    _, spec, params = _small_net()
    path = export_model(params, spec, tmp_path / "art", what="forward",
                        domain="fft", batch=4)
    srv = InferenceServer(ServingModel.load(path), port=0,
                          max_request_bytes=1 << 20)
    srv.start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            assert json.loads(r.read())["batch"] == 4
        x = np.zeros((2, 3, 32, 32), np.float32)  # valid shape, wrong B
        buf = _io.BytesIO(); np.save(buf, x)
        req = urllib.request.Request(f"{base}/infer", data=buf.getvalue(),
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=30)
        assert ei.value.code == 400
        assert "batch" in json.loads(ei.value.read())["error"]

        big = np.zeros((40, 3, 64, 64), np.float32)  # > 1 MiB payload
        buf = _io.BytesIO(); np.save(buf, big)
        req = urllib.request.Request(f"{base}/infer", data=buf.getvalue(),
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=30)
        assert ei.value.code == 413
    finally:
        srv.shutdown()


def test_http_dynamic_batching_coalesces(tmp_path):
    """Concurrent /infer requests within the window share ONE model call
    and all receive their own correct slice."""
    import io as _io
    import threading
    import time
    import urllib.request
    from spectralae.io.server import InferenceServer

    _, spec, params = _small_net()
    path = export_model(params, spec, tmp_path / "art", what="forward",
                        domain="fft", batch=None)
    inner = ServingModel.load(path)

    posted = threading.Semaphore(0)

    class Counting:
        def __init__(self, m):
            self._m = m
            self.calls = 0
            self.manifest = m.manifest
            self.input_shape = m.input_shape

        def __call__(self, x):
            self.calls += 1
            if self.calls == 1:
                # hold the first batch on-device until every client has
                # posted (+ grace for the last request to traverse HTTP
                # into the queue): the stragglers then MUST coalesce into
                # one follow-up batch, deterministically — without this
                # the assertion raced the 300 ms window on loaded hosts
                for _ in range(4):
                    posted.acquire()
                time.sleep(0.5)
            return self._m(x)

    m = Counting(inner)
    srv = InferenceServer(m, port=0, batch_window_ms=300)
    srv.start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        xs = [(np.random.default_rng(i).normal(size=(1, 3, 32, 32))
               .astype(np.float32) * 50) for i in range(4)]
        outs = [None] * 4

        def post(i):
            posted.release()
            buf = _io.BytesIO(); np.save(buf, xs[i])
            req = urllib.request.Request(f"{base}/infer",
                                         data=buf.getvalue(),
                                         method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                outs[i] = np.load(_io.BytesIO(r.read()),
                                  allow_pickle=False)

        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for i in range(4):
            np.testing.assert_allclose(
                outs[i], np.asarray(inner(xs[i])), rtol=1e-5, atol=1e-4)
        assert m.calls < 4  # at least some coalescing happened
    finally:
        srv.shutdown()


def test_dynamic_batcher_skips_abandoned_requests():
    """A request whose waiter already timed out must not be dispatched to
    the device later — the old dispatcher ran the orphaned array anyway,
    burning device time and delaying the live requests queued behind it."""
    import threading
    from spectralae.io.server import _DynamicBatcher

    calls = []
    first_entered = threading.Event()
    release = threading.Event()

    def slow_once_model(arr):
        arr = np.asarray(arr)
        calls.append(arr.copy())
        if not first_entered.is_set():
            first_entered.set()
            assert release.wait(10)    # wedge the dispatcher
        return arr * 2.0

    b = _DynamicBatcher(slow_once_model, window_s=0.005, max_batch=8)
    try:
        wedge_out = {}
        t1 = threading.Thread(target=lambda: wedge_out.update(
            out=b.infer(np.ones((1, 2), np.float32), timeout=10)))
        t1.start()
        assert first_entered.wait(5)   # dispatcher is now inside the model
        with pytest.raises(TimeoutError):
            b.infer(np.full((1, 2), 7.0, np.float32), timeout=0.05)
        release.set()
        t1.join(10)
        np.testing.assert_allclose(wedge_out["out"], 2.0)
        out = b.infer(np.full((1, 2), 3.0, np.float32), timeout=10)
        np.testing.assert_allclose(out, 6.0)
        # the abandoned request's payload never reached the model
        assert not any(np.any(c == 7.0) for c in calls)
    finally:
        b.shutdown()
