"""Compile-cache placement (core/runtime.py) and the device-peak table
(core/roofline.py)."""

from pathlib import Path
from types import SimpleNamespace

import pytest

import jax

from spectralae.core import roofline, runtime


@pytest.fixture
def fresh_runtime(monkeypatch):
    """A runtime module that has not enabled its cache yet; JAX's own
    cache directory restored afterwards."""
    saved = jax.config.jax_compilation_cache_dir
    monkeypatch.setattr(runtime, "_cache_enabled", False)
    monkeypatch.setattr(runtime, "_cache_path", None)
    yield runtime
    jax.config.update("jax_compilation_cache_dir", saved)


def test_env_dir_is_the_only_cache(fresh_runtime, monkeypatch, tmp_path):
    env_dir = tmp_path / "from_env"
    monkeypatch.setenv(runtime.ENV_CACHE_DIR, str(env_dir))
    before = jax.config.jax_compilation_cache_dir
    fresh_runtime.enable_compilation_cache(tmp_path / "explicit")
    assert fresh_runtime.cache_dir() == env_dir
    # no directory set in code: JAX keeps the one it read from the env
    assert jax.config.jax_compilation_cache_dir == before
    assert not (tmp_path / "explicit").exists()


def test_default_dir_is_fixed_in_checkout(fresh_runtime, monkeypatch):
    monkeypatch.delenv(runtime.ENV_CACHE_DIR, raising=False)
    assert fresh_runtime.cache_dir() == runtime.DEFAULT_CACHE_DIR
    assert runtime.DEFAULT_CACHE_DIR == (
        Path(runtime.__file__).resolve().parents[2] / ".jax_cache")
    fresh_runtime.enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == str(
        runtime.DEFAULT_CACHE_DIR)


def test_explicit_dir_without_env(fresh_runtime, monkeypatch, tmp_path):
    monkeypatch.delenv(runtime.ENV_CACHE_DIR, raising=False)
    fresh_runtime.enable_compilation_cache(tmp_path / "c")
    assert fresh_runtime.cache_dir() == tmp_path / "c"
    assert (tmp_path / "c").is_dir()
    assert jax.config.jax_compilation_cache_dir == str(tmp_path / "c")


def test_enable_is_idempotent(fresh_runtime, monkeypatch, tmp_path):
    monkeypatch.delenv(runtime.ENV_CACHE_DIR, raising=False)
    fresh_runtime.enable_compilation_cache(tmp_path / "a")
    fresh_runtime.enable_compilation_cache(tmp_path / "b")
    assert fresh_runtime.cache_dir() == tmp_path / "a"


def test_h100_peaks_by_device_kind():
    p = roofline.device_peaks(SimpleNamespace(
        device_kind="NVIDIA H100 80GB HBM3"))
    assert (p.bf16, p.tf32, p.f32, p.hbm) == (989e12, 495e12, 67e12,
                                              3.35e12)
    assert "data sheet" in p.source


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA H100 PCIe",
                                  "NVIDIA A100-SXM4-80GB"])
def test_unknown_device_kind_is_an_error(kind):
    with pytest.raises(KeyError, match=kind):
        roofline.device_peaks(SimpleNamespace(device_kind=kind))


def test_this_hosts_device_is_not_in_the_table():
    with pytest.raises(KeyError):
        roofline.device_peaks()


def test_utilization_against_f32_and_bandwidth_peaks():
    p = roofline.PEAKS["NVIDIA H100 80GB HBM3"]
    u = roofline.utilization(67e9, 3.35e9, 1e-3, p)
    assert u["pct_peak_flops_f32"] == pytest.approx(100.0)
    assert u["pct_peak_bw"] == pytest.approx(100.0)
    assert u["gflop"] == pytest.approx(67.0)
