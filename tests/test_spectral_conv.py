"""The pointwise complex-multiply conv's evaluations (ops/spectral.py): the
re/im broadcast-sum the GPU routes to, the complex einsum, and bf16
operand streaming."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from spectralae.ops import dft, spectral


def _spectra(rng, *shape):
    return jnp.asarray(np.fft.rfft2(rng.normal(size=shape)).astype(
        np.complex64))


@pytest.mark.parametrize("nx,ny,m,d,b,scale_by_dm", [
    (16, 16, 4, 3, 2, True), (32, 32, 10, 3, 1, True),
    (16, 16, 3, 2, 3, False), (12, 15, 4, 3, 2, True),
    (16, 18, 5, 3, 3, True), (8, 9, 10, 10, 2, True)])
def test_spectral_conv_split_matches_einsum(nx, ny, m, d, b, scale_by_dm):
    """The GPU's routed form (re/im broadcast-sum) equals the einsum —
    odd ny, no 1/M scaling, D=M=10 inner-stage shapes included."""
    rng = np.random.default_rng(7)
    X = _spectra(rng, b, d, nx, ny)
    C = _spectra(rng, m, d, nx, ny)
    bias = jnp.asarray(rng.normal(size=(m,)).astype(np.float32))
    want = spectral.spectral_conv_einsum(X, C, bias, nx, ny,
                                         scale_by_dm=scale_by_dm)
    got = spectral.spectral_conv_split(X, C, bias, nx, ny,
                                       scale_by_dm=scale_by_dm)
    assert got.shape == want.shape == (b, m, nx, ny // 2 + 1)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-4, atol=1e-3)


def _conv_loss(fn, nx, ny, nm):
    def loss(xs, c, bb):
        X = jnp.fft.rfft2(xs)
        C = dft.kernel_spectrum(c, nx, ny)
        y = jnp.fft.irfft2(fn(X, C, bb), s=(nx, ny))
        return jnp.mean((y - xs[:, :1].repeat(nm, 1)) ** 2)
    return loss


def test_spectral_conv_fused_fwd_and_vjp_match_einsum():
    """The routed split form == the einsum path, values AND grads (the
    GPU's batched autodiff step differentiates through it)."""
    rng = np.random.default_rng(3)
    nx = ny = 16
    xsp = jnp.asarray(rng.normal(size=(2, 3, nx, ny)).astype(np.float32))
    ck = jnp.asarray(rng.normal(size=(5, 3, 3, 3)).astype(np.float32))
    b = jnp.asarray(rng.normal(size=(5,)).astype(np.float32))

    def ein(X, C, bb):
        return spectral.spectral_conv_einsum(X, C, bb, nx, ny)

    def split(X, C, bb):
        return spectral.spectral_conv_split(X, C, bb, nx, ny)

    X = jnp.fft.rfft2(xsp)
    C = dft.kernel_spectrum(ck, nx, ny)
    np.testing.assert_allclose(np.asarray(split(X, C, b)),
                               np.asarray(ein(X, C, b)), rtol=1e-5,
                               atol=1e-5)
    g1 = jax.grad(_conv_loss(ein, nx, ny, 5), argnums=(0, 1, 2))(xsp, ck, b)
    g2 = jax.grad(_conv_loss(split, nx, ny, 5), argnums=(0, 1, 2))(xsp, ck,
                                                                     b)
    for a, c2 in zip(g1, g2):
        np.testing.assert_allclose(np.asarray(a), np.asarray(c2),
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("argnum", [0, 1, 2])
@pytest.mark.parametrize("scale_by_dm", [True, False])
def test_spectral_conv_split_grads_on_complex_inputs(argnum, scale_by_dm):
    """Cotangents w.r.t. the complex spectra and the bias, taken directly
    (JAX's complex convention is the plain transpose) — split vs einsum."""
    rng = np.random.default_rng(5)
    nx, ny = 12, 10
    X = _spectra(rng, 2, 3, nx, ny)
    C = _spectra(rng, 4, 3, nx, ny)
    b = jnp.asarray(rng.normal(size=(4,)).astype(np.float32))

    def loss(fn):
        return lambda *a: jnp.sum(jnp.abs(fn(*a, nx, ny,
                                             scale_by_dm=scale_by_dm)) ** 2)
    g1 = jax.grad(loss(spectral.spectral_conv_einsum), argnums=argnum)(
        X, C, b)
    g2 = jax.grad(loss(spectral.spectral_conv_split), argnums=argnum)(
        X, C, b)
    scale = float(np.max(np.abs(np.asarray(g1))))
    np.testing.assert_allclose(np.asarray(g2), np.asarray(g1), rtol=1e-4,
                               atol=1e-5 * scale)


def test_spectral_conv_bf16_streaming_close_to_f32():
    """compute_dtype=bf16 (operand streaming, f32 accumulation) stays
    within bf16 rounding of the f32 path — values and grads."""
    rng = np.random.default_rng(9)
    nx = ny = 16
    X = _spectra(rng, 2, 3, nx, ny)
    C = _spectra(rng, 4, 3, nx, ny)
    b = jnp.asarray(rng.normal(size=(4,)).astype(np.float32))
    want = np.asarray(spectral.spectral_conv_einsum(X, C, b, nx, ny))
    got = np.asarray(spectral.spectral_conv_einsum(
        X, C, b, nx, ny, compute_dtype=jnp.bfloat16))
    scale = np.max(np.abs(want))
    assert np.max(np.abs(got - want)) < 2e-2 * scale
    assert got.dtype == np.complex64  # f32 accumulation/output

    def loss(c, cd):
        y = spectral.spectral_conv(X, dft.kernel_spectrum(c, nx, ny),
                                   b, nx, ny, compute_dtype=cd)
        return jnp.mean(jnp.abs(y) ** 2)
    ck = jnp.asarray(rng.normal(size=(4, 3, 3, 3)).astype(np.float32))
    g32 = jax.grad(loss)(ck, None)
    g16 = jax.grad(loss)(ck, jnp.bfloat16)
    np.testing.assert_allclose(np.asarray(g16), np.asarray(g32),
                               rtol=3e-2, atol=1e-3 * float(
                                   np.max(np.abs(np.asarray(g32)))))


def test_modern_fft_train_step_bf16_decreases_loss():
    import jax
    import jax.numpy as jnp
    from spectralae.core.config import Config, LayerParams
    from spectralae.core.types import (init_opt_state, init_params,
                                       initial_spec)
    from spectralae.train.modern import train_step
    cfg = Config(nx=16, ny=16, d=2,
                 layer=LayerParams(depth=4, lk=0, ll=0, scale=2, rmax=0.5))
    spec = initial_spec(cfg)
    params = init_params(jax.random.key(0), spec, 0.5)
    opt = init_opt_state(params)
    x = jnp.asarray(np.random.default_rng(4).normal(
        size=(4, 2, 16, 16)).astype(np.float32)) * 20
    losses = []
    for _ in range(40):
        res = train_step(params, opt, x, spec.scales, lr=0.5, domain="fft",
                         compute_dtype=jnp.bfloat16)
        params, opt = res.params, res.opt
        losses.append(float(res.loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.9
    assert params.stages[0].c.dtype == jnp.float32
