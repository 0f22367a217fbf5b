"""The one backend decision point (spectralae/core/backend.py) and the call
sites that route through it: auto_burst, fft_burst_dp, spectral_conv."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from spectralae.core import backend
from spectralae.core.config import Config, LayerParams
from spectralae.core.types import initial_spec, init_params
from spectralae.model import autoencoder as model
from spectralae.ops import spectral
from spectralae.train.fft import fft_burst
from spectralae.train.fft_corr import auto_burst, fft_burst_corr
from spectralae.train.fft_dp import fft_burst_dp

import oracle


@pytest.mark.parametrize("name", ["gpu", "cpu"])
def test_routing_table(name):
    """Both known backends take the choices measured on the GPU."""
    assert backend.burst_body(name) == "corr"
    assert backend.spectral_conv_impl(name=name) == "split"
    assert backend.spectral_conv_impl(jnp.bfloat16, name=name) == "einsum"


@pytest.mark.parametrize("name", ["rocm", "METAL", "neuron"])
def test_unknown_backend_raises(name, monkeypatch):
    with pytest.raises(RuntimeError, match=name):
        backend.backend(name)
    monkeypatch.setattr(jax, "default_backend", lambda: name)
    with pytest.raises(RuntimeError, match=name):
        backend.burst_body()
    with pytest.raises(RuntimeError, match=name):
        backend.spectral_conv_impl()


@pytest.mark.parametrize("batch", [1, 3])
def test_polymorphic_export_takes_split(batch, monkeypatch):
    """A batch-polymorphic export (the serving path) traces spectral_conv
    with a symbolic batch and still takes the split form; the result
    matches the numpy oracle."""
    cfg = Config(nx=32, ny=32, d=3,
                 layer=LayerParams(depth=4, lk=1, ll=1, scale=2, rmax=1.0))
    spec = initial_spec(cfg)
    params = init_params(jax.random.key(0), spec, 1.0)

    def no_einsum(*a, **k):
        raise AssertionError("the einsum form was traced")
    monkeypatch.setattr(spectral, "spectral_conv_einsum", no_einsum)
    (b,) = jax.export.symbolic_shape("b")
    exp = jax.export.export(jax.jit(
        lambda v: model.forward_fft(params, v, spec.scales)))(
        jax.ShapeDtypeStruct((b, 3, 32, 32), jnp.float32))
    x = np.random.default_rng(batch).uniform(
        0, 255, size=(batch, 3, 32, 32)).astype(np.float32)
    got = np.asarray(exp.call(jnp.asarray(x)))
    assert got.shape == x.shape
    stages = [(np.asarray(st.c, np.float64), np.asarray(st.b, np.float64))
              for st in params.stages]
    want = oracle.forward_fft_ref(stages, x[-1].astype(np.float64),
                                  spec.scales)
    assert np.linalg.norm(got[-1] - want) / np.linalg.norm(want) <= 1e-5


def _burst_setup(nx=16):
    cfg = Config(nx=nx, ny=nx, d=2,
                 layer=LayerParams(depth=4, lk=1, ll=1, scale=1, rmax=0.5))
    spec = initial_spec(cfg)
    params = init_params(jax.random.key(0), spec, 0.5)
    x = jnp.asarray(np.random.default_rng(0).normal(
        size=(2, nx, nx)).astype(np.float32)) * 50
    out0 = model.forward_fft(params, x[None], spec.scales)[0]
    enc, dec = params.pair(0)
    return x, out0, enc, dec


@pytest.mark.parametrize("name", ["gpu", "cpu"])
def test_auto_burst_runs_the_routed_body(name, monkeypatch):
    x, out0, enc, dec = _burst_setup()
    args = (enc.c, dec.c, enc.b, dec.b)
    monkeypatch.setattr(jax, "default_backend", lambda: name)
    got = auto_burst(x, None, out0, *args, lr=0.2, iters=4)
    want = fft_burst_corr(x, None, out0, *args, lr=0.2, iters=4)
    np.testing.assert_allclose(np.asarray(got.c), np.asarray(want.c),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(got.mses), np.asarray(want.mses),
                               rtol=1e-6)


@pytest.mark.parametrize("name", ["gpu", "cpu"])
def test_fft_burst_dp_runs_the_routed_body(name, monkeypatch):
    x, out0, enc, dec = _burst_setup()
    args = (enc.c, dec.c, enc.b, dec.b)
    want = fft_burst_dp(x[None], None, out0[None], *args, lr=0.2, iters=4,
                        body="corr")
    monkeypatch.setattr(jax, "default_backend", lambda: name)
    jax.clear_caches()      # the routing is resolved at trace time
    try:
        got = fft_burst_dp(x[None], None, out0[None], *args, lr=0.2,
                           iters=4)
    finally:
        monkeypatch.undo()
        jax.clear_caches()
    np.testing.assert_allclose(np.asarray(got.c), np.asarray(want.c),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(got.mses), np.asarray(want.mses),
                               rtol=1e-6)


def test_fft_burst_dp_rejects_unknown_body():
    x, out0, enc, dec = _burst_setup()
    with pytest.raises(ValueError, match="body"):
        fft_burst_dp(x[None], None, out0[None], enc.c, dec.c, enc.b, dec.b,
                     iters=2, body="pallas")


@pytest.mark.parametrize("name", ["gpu", "cpu"])
def test_spectral_conv_follows_the_table(name, monkeypatch):
    """spectral_conv is the split form in f32 and the einsum with a
    reduced compute dtype; the two forms agree."""
    rng = np.random.default_rng(0)
    nx = ny = 16
    X = jnp.asarray(np.fft.rfft2(rng.normal(size=(2, 3, nx, ny))).astype(
        np.complex64))
    C = jnp.asarray(np.fft.rfft2(rng.normal(size=(4, 3, nx, ny))).astype(
        np.complex64))
    b = jnp.asarray(rng.normal(size=(4,)).astype(np.float32))
    monkeypatch.setattr(jax, "default_backend", lambda: name)
    got = spectral.spectral_conv(X, C, b, nx, ny)
    np.testing.assert_array_equal(
        np.asarray(got), np.asarray(spectral.spectral_conv_split(
            X, C, b, nx, ny)))
    np.testing.assert_allclose(
        np.asarray(got),
        np.asarray(spectral.spectral_conv_einsum(X, C, b, nx, ny)),
        rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(
        np.asarray(spectral.spectral_conv(X, C, b, nx, ny,
                                          compute_dtype=jnp.bfloat16)),
        np.asarray(spectral.spectral_conv_einsum(
            X, C, b, nx, ny, compute_dtype=jnp.bfloat16)))


def test_fft_and_dft_impls_agree():
    """The literal pad+rfft2 path and the DFT-matmul path of the ω-space
    reference body are the same math."""
    x, out0, enc, dec = _burst_setup()
    a = fft_burst(x, x, out0, enc.c, dec.c, enc.b, dec.b,
                  lr=0.2, iters=4, impl="fft")
    b = fft_burst(x, x, out0, enc.c, dec.c, enc.b, dec.b,
                  lr=0.2, iters=4, impl="dft")
    np.testing.assert_allclose(np.asarray(a.mses), np.asarray(b.mses),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(np.asarray(a.c), np.asarray(b.c),
                               rtol=1e-3, atol=1e-4)
