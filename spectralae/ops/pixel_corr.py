"""Pixel-space fused-anchor precompute: the FFT-free formulation.

The corr-burst precompute (train/fft_corr.corr_precompute_fused) consumes
only *centered lag windows* of signal cross-correlations plus a few
scalars.  Every one of those is a plain pixel-space quantity — the
spectral route (rfft2 → product planes → restricted-iDFT windows) is one
way to compute them, but by Parseval it is algebraically identical to:

    XX[d,e][u,v]  = Nx·Ny · mean_b Σ_p x_d(p) · x_e(p + (u,v))      (circular)
    eg_e          = s1 · (K₀ ⊛ x)_e − x_e        (9×9 circular conv; the
                    continuum anchor error EG = s1·K̂₀X − X in pixel space)
    EGw[d,e][u,v] = Nx·Ny · mean_b Σ_p x_d(p) · eg_e(p + (u,v))
    seg           = Nx·Ny · mean_b Σ_{e,p} eg²           (Σ w |EG|², Parseval)
    e0[e]         = mean_b Σ_p eg_e(p)                    (EG DC bin)
    X0[d]         = mean_b Σ_p x_d(p)                     (X DC bin)

This removes the signal FFTs entirely, making the precompute FFT-free.  As
plain XLA it is a *correctness alternative*, not a speed path: the shift
stacks materialize in device memory and the lag contraction is a skinny
matmul (stay on the spectral route for speed; `precompute="pixel"` is
opt-in).  The
anchoring-precision contract is preserved: ``eg`` is computed *per pixel*
as a 243-term f32 contraction minus x (error at signal·eps scale, exactly
like the spectral path's bin-wise EG), never derived from the
signal-energy-scale XX tensors.

The lag windows become shift-stack contractions

    XX = einsum("bduij,bevij->deuv", A, B) · Nx·Ny / B
    A[(d,u)](i,j) = x_d(i−u, j)   (row shifts, u ∈ [−h, h])
    B[(e,v)](i,j) = x_e(i, j+v)   (column rolls)

— one [D·(2h+1), P] × [P, D·(2h+1)] contraction over all pixels.
Lag order matches :func:`spectralae.ops.dft.lag_basis` (index 0 ↔ −h);
circular rolls reproduce the DFT's mod-N lag aliasing exactly.

Equality with the spectral formulation is tested at the T-dict and
whole-burst level in tests/test_fft_corr.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax


def _row_stack(x: jax.Array, h: int) -> jax.Array:
    """``[B, D, nx, ny] → [B, D, 2h+1, nx, ny]``, entry u ↦ x(i−(u−h), j)."""
    return jnp.stack([jnp.roll(x, s, axis=-2) for s in range(-h, h + 1)],
                     axis=2)


def _col_stack(x: jax.Array, h: int) -> jax.Array:
    """``[B, D, nx, ny] → [B, D, 2h+1, nx, ny]``, entry v ↦ x(i, j+(v−h))."""
    return jnp.stack([jnp.roll(x, -s, axis=-1) for s in range(-h, h + 1)],
                     axis=2)


def anchor_error_pixel(x: jax.Array, K0taps: jax.Array, s1: float,
                       precision="highest") -> jax.Array:
    """``eg = s1·(K₀ ⊛ x) − x``: the continuum anchor error in pixel space.

    ``K0taps [E, D, nk2, nl2]`` are centered composed-kernel taps; the
    circular convolution ``(K₀ ⊛ x)_e(p) = Σ_{d,t} K₀[e,d,t]·x_d(p−t)``
    runs as one ``lax.conv`` over a circularly padded input.  Full-f32
    contraction ("highest"): the anchor is never measured back, so its
    rounding would be a phantom error the burst chases (same rule as the
    spectral path's kernel_spectrum precision).
    """
    hx2 = K0taps.shape[-2] // 2
    hy2 = K0taps.shape[-1] // 2
    xpad = jnp.concatenate([x[..., -hx2:, :], x, x[..., :hx2, :]], axis=-2)
    xpad = jnp.concatenate(
        [xpad[..., -hy2:], xpad, xpad[..., :hy2]], axis=-1)
    w = K0taps[:, :, ::-1, ::-1]
    conv = lax.conv_general_dilated(
        xpad, w, window_strides=(1, 1), padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        preferred_element_type=jnp.float32, precision=precision)
    return s1 * conv - x


def pixel_anchor_windows(x: jax.Array, K0taps: jax.Array, hx2: int,
                         hy2: int, s1: float):
    """FFT-free fused-anchor precompute on pixel frames.

    Args:
      x: ``[B, D, nx, ny]`` real frames (NOT spectra).
      K0taps: ``[D, D, 2hx2+1, 2hy2+1]`` composed anchor taps.

    Returns ``(XX [D,D,4hx2+1,4hy2+1], EGw [D,D,2hx2+1,2hy2+1], seg, e0,
    X0)`` — the spectral route's window contract
    (train/fft_corr.corr_precompute_fused) plus the X DC scalars (free here, no spectrum to read them
    from at the call site).
    """
    B = x.shape[0]
    nx, ny = x.shape[-2], x.shape[-1]
    hx4, hy4 = 2 * hx2, 2 * hy2
    norm = float(nx * ny) / B
    ein = functools.partial(jnp.einsum, precision="highest",
                            preferred_element_type=jnp.float32)

    eg = anchor_error_pixel(x, K0taps, s1)

    A4 = _row_stack(x, hx4)
    B4 = _col_stack(x, hy4)
    XX = ein("bduij,bevij->deuv", A4, B4) * norm

    A2 = A4[:, :, hx4 - hx2:hx4 + hx2 + 1]
    EGv = _col_stack(eg, hy2)
    EGw = ein("bduij,bevij->deuv", A2, EGv) * norm

    seg = jnp.sum(eg * eg) * norm
    e0 = jnp.sum(eg, axis=(0, -2, -1)) / B
    X0 = jnp.sum(x, axis=(0, -2, -1)) / B
    return XX, EGw, seg, e0, X0
