"""chip_smoke.py's phases at tiny sizes on the CPU, its refusal to run
without a GPU, and its last-line contract.  The full-size run is on the
card (``python chip_smoke.py``; ``--four`` on four cards)."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax

import chip_smoke as cs
import oracle

ROOT = Path(__file__).resolve().parents[1]


def test_phase_forward_matches_oracle():
    res = cs.phase_forward(nx=64, batch=2, pairs=3)
    assert res["ok"], res
    assert res["fft_norm_rel"] <= 1e-5 and res["coord_norm_rel"] <= 1e-5


def test_phase_bursts_bodies_match_reference():
    res = cs.phase_bursts(nx=16, iters=10, reps=1)
    assert res["ok"], res
    assert set(res["ms_per_burst"]) == {"ref", "corr", "omega"}
    assert "unpinned_f32_matmul_norm_rel" in res["default_precision"]


def test_phase_cli_entry_points():
    res = cs.phase_cli(nx=32, layers=2, steps=1, batch=2, stream_k=2,
                       iters=5)
    assert res["ok"], res
    for name in ("train_burst", "train_stream", "train_fft_step",
                 "train_coord_step", "run"):
        assert res[name]["records"] > 0 and res[name]["finite"], name


def test_phase_large_fused_burst():
    res = cs.phase_large(nx=32, iters=3)
    assert res["ok"], res
    assert res["memory_analysis"]["temp_size_in_bytes"] >= 0


@pytest.mark.parametrize("flatbuffers", ["importable", "blocked"])
def test_phase_serve_over_http(flatbuffers, monkeypatch):
    """Export, load and serve through the on-disk artifact, also where
    ``flatbuffers`` (jax.export's own serialization) cannot be imported."""
    if flatbuffers == "blocked":
        for mod in ("flatbuffers", "jax._src.export.serialization"):
            monkeypatch.setitem(sys.modules, mod, None)
    res = cs.phase_serve(nx=32, layers=2, batch=1, requests=2,
                         platform="cpu")
    assert res["ok"], res
    assert res["batch"] is None
    assert len(res["norm_rel"]) == 2 and res["platforms"] == ["cpu"]


def test_phase_four_on_virtual_devices():
    res = cs.phase_four(nx=16, batch=4, iters=5, frames=2,
                        devices=jax.devices()[:4])
    assert res["ok"], res
    assert res["devices"] == 4
    for k in ("dp_burst_4x1", "train_step_4x1", "train_step_2x2",
              "dp_stream_4x1"):
        assert res[k] <= 1e-4, k


def test_phase_four_needs_four_devices():
    with pytest.raises(RuntimeError, match="4 devices"):
        cs.phase_four(nx=16, batch=4, iters=2, frames=1,
                      devices=jax.devices()[:2])


def test_ok_line_format():
    dev = cs.device_record()
    line = cs.ok_line(dev)
    rec = json.loads(line)
    assert rec == {"ok": True, "device": {
        "platform": jax.devices()[0].platform,
        "kind": jax.devices()[0].device_kind,
        "count": len(jax.devices())}}
    assert "\n" not in line


def test_main_refuses_without_gpu(capsys):
    assert cs.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out and "no GPU" in out
    assert "nvidia-smi name, power.limit" in out


def _env_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return env


def test_script_exits_nonzero_on_cpu():
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       env=_env_cpu(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_script_alone_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=_env_cpu(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.mark.parametrize("mode", ["centered", "ref_cpu", "ref_gpu"])
@pytest.mark.parametrize("scale_by_dm", [True, False])
def test_oracle_vectorized_conv_equals_loop_form(mode, scale_by_dm):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 7)).astype(np.float32)
    c = rng.normal(size=(3, 2, 5, 3)).astype(np.float32)
    b = rng.normal(size=(3,)).astype(np.float32)
    np.testing.assert_allclose(
        oracle.conv_ref_vec(x, c, b, mode, scale_by_dm),
        oracle.conv_ref(x, c, b, mode, scale_by_dm), rtol=1e-5, atol=1e-5)


def test_burst_close_flags_a_wrong_body():
    x, out0, enc, dec = cs.burst_pair(16)
    ref = cs.fft_burst(x, x, out0, enc.c, dec.c, enc.b, dec.b, lr=0.2,
                       iters=3)
    bad = ref._replace(c=ref.c * 1.01)
    assert cs.burst_ok(cs.burst_close(ref, ref))
    assert not cs.burst_ok(cs.burst_close(bad, ref))


@pytest.mark.gpu
def test_chip_smoke_on_the_card(gpu):
    """The full-size phases; runs only where JAX sees a GPU."""
    assert cs.main([]) == 0
