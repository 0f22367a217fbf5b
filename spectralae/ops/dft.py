"""Compact-support DFT transforms: kernel↔spectrum as small matmuls.

Replaces the reference's per-iteration kernel FFT churn.  Because conv
kernels live on a tiny Nk×Nl support (25 taps for 5×5), their full Nx×Ny
spectra are rank-P DFT projections:

  forward  (pad+rfft2,      fft_backproplib.cu:1276-1282):
      C(ω) = Σ_{k,l} c[k,l] · e^{-2πi ω·r_kl}
  inverse  (unnormalized C2R + shrink, fft_backproplib.cu:1219-1226):
      g[k,l] = Σ_ω w_ω · Re(D(ω) · e^{+2πi ω·r_kl})

with r_kl the corner-quadrant (circular) kernel positions and w_ω the
Hermitian double-count weights of the half-spectrum.  The phases are
**separable** — θ(ω) = θx_k(ωx) + θy_l(ωy) — so both transforms factor
into two per-axis matmuls against tiny [Nk, Nx] / [Nl, Nyr] bases
(~8 k floats at 1024²) instead of one [P, W] basis (a 105 MB program
constant at 1024² that also bloats compile payloads), with ~10× fewer
FLOPs.  The inverse needs no separate shrink gather.

Exactness: both equal the FFT path bit-for-float (the gradient spectra are
Hermitian, so the C2R's Hermitian assumption holds); validated in
tests/test_dft_ops.py.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

HIGHEST = jax.lax.Precision.HIGHEST


@functools.lru_cache(maxsize=None)
def _axis_bases(nk: int, nl: int, nx: int, ny: int):
    """Per-axis cos/sin bases + Hermitian column weights.

    Returns cx/sx [nk, nx], cy/sy [nl, nyr], hermy [nyr].
    """
    nyr = ny // 2 + 1
    rx = (np.arange(nk) - nk // 2) % nx           # circular kernel rows
    ry = (np.arange(nl) - nl // 2) % ny           # circular kernel cols
    px = 2 * np.pi * np.outer(rx, np.arange(nx)) / nx     # [nk, nx]
    py = 2 * np.pi * np.outer(ry, np.arange(nyr)) / ny    # [nl, nyr]
    from .spectral import _hermitian_weights
    herm = _hermitian_weights(nx, ny)
    return (np.cos(px).astype(np.float32), np.sin(px).astype(np.float32),
            np.cos(py).astype(np.float32), np.sin(py).astype(np.float32),
            herm)


@functools.lru_cache(maxsize=None)
def lag_basis(nx: int, ny: int, hx: int, hy: int):
    """Separable restricted-iDFT bases for centered lag windows.

    ``corr[v] = Re Σ_ω w(ω_y)·P(ω)·e^{2πi(v_x ω_x/nx + v_y ω_y/ny)}`` over
    the Hermitian half-spectrum (w doubles interior columns) — the
    irfft2·(Nx·Ny) value at lag ``v ∈ [−h, h]²``, computed as four small
    matmuls instead of a full inverse FFT (the burst only ever reads a
    ``(2h+1)²`` window out of the Nx·Ny grid; at 1024² that is 289 of 1M
    points).  Lag periodicity (``v mod N``) is inherent in the complex
    exponential, so windows wider than the grid alias exactly like the
    FFT path did.  Consumed by the correlation-space burst precompute
    (train/fft_corr).
    """
    from .spectral import _hermitian_weights
    w = _hermitian_weights(nx, ny).astype(np.float64)
    nyr = ny // 2 + 1
    vy = np.arange(-hy, hy + 1)
    vx = np.arange(-hx, hx + 1)
    ay = 2.0 * np.pi * np.arange(nyr)[:, None] * vy[None, :] / ny
    ax = 2.0 * np.pi * np.arange(nx)[:, None] * vx[None, :] / nx
    return (np.asarray(np.cos(ax), np.float32),
            np.asarray(np.sin(ax), np.float32),
            np.asarray(w[:, None] * np.cos(ay), np.float32),
            np.asarray(w[:, None] * np.sin(ay), np.float32))


def kernel_spectrum(c: jax.Array, nx: int, ny: int) -> jax.Array:
    """``rfft2(kernel_pad(c))`` as two per-axis matmuls.

    c: ``[..., Nk, Nl]`` real → ``[..., Nx, Ny//2+1]`` complex.  Every
    matmul is f32 at ``HIGHEST`` precision (the spectrum anchors
    cancellation-sensitive decompositions, and a reduced-precision matmul
    mode would round the tap operands).
    """
    nk, nl = c.shape[-2], c.shape[-1]
    cx, sx, cy, sy = map(jnp.asarray, _axis_bases(nk, nl, nx, ny)[:4])
    ein = functools.partial(jnp.einsum,
                            preferred_element_type=jnp.float32,
                            precision=HIGHEST)
    # columns first: T = c · e^{-iθy}   [..., Nk, Nyr]
    tr = ein("...kl,ly->...ky", c, cy)
    ti = -ein("...kl,ly->...ky", c, sy)
    # rows: C = e^{-iθx} · T            [..., Nx, Nyr]
    re = ein("kx,...ky->...xy", cx, tr) + ein("kx,...ky->...xy", sx, ti)
    im = ein("kx,...ky->...xy", cx, ti) - ein("kx,...ky->...xy", sx, tr)
    return jax.lax.complex(re, im)


def kernel_project(D: jax.Array, nk: int, nl: int, nx: int, ny: int) -> jax.Array:
    """``kernel_shrink(irfft2_unnormalized(D))`` as two per-axis matmuls.

    D: ``[..., Nx, Ny//2+1]`` complex (Hermitian-consistent) →
    ``[..., Nk, Nl]`` real — the spatial gradient restricted to the compact
    support, with cuFFT's unnormalized C2R scaling.

    g[k,l] = Σ_ω w(ωy)·[Dr·cos(θx+θy) − Di·sin(θx+θy)], expanded over the
    separable angle sum into four (rows ∘ cols) contractions.
    """
    cx, sx, cy, sy, hermy = _axis_bases(nk, nl, nx, ny)
    cx, sx, cy, sy = map(jnp.asarray, (cx, sx, cy, sy))
    w = jnp.asarray(hermy)
    Dr = D.real * w
    Di = D.imag * w
    ein = functools.partial(jnp.einsum, preferred_element_type=jnp.float32,
                            precision=HIGHEST)
    # columns: A·e^{±iθy} partials        [..., Nx, Nl]
    rc = ein("...xy,ly->...xl", Dr, cy)
    rs = ein("...xy,ly->...xl", Dr, sy)
    ic = ein("...xy,ly->...xl", Di, cy)
    is_ = ein("...xy,ly->...xl", Di, sy)
    # rows: contract ωx                   [..., Nk, Nl]
    return (ein("kx,...xl->...kl", cx, rc) - ein("kx,...xl->...kl", sx, rs)
            - ein("kx,...xl->...kl", sx, ic) - ein("kx,...xl->...kl", cx, is_))
