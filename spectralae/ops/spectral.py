"""Momentum-space (frequency-domain) ops on the rfft2 half-spectrum layout.

Design: the reference's cuFFT plans + hand-written device kernels
(source/fft_backproplib.cu) become ``jnp.fft.rfft2``/``irfft2`` (XLA's FFT,
cuFFT on the GPU) plus pure-jnp gather/mask/einsum ops that XLA fuses; the
per-call plan churn and cudaMalloc traffic disappear under ``jit``.

Spectrum layout: ``[..., Nx, Ny//2+1]`` complex — identical to cuFFT R2C
(fft_backproplib.cu:775).  All index quirks of the reference's ``resize``
kernel (Nyquist row/column handling) are reproduced bit-for-bit; see
:func:`spectral_resize`.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

# every f32 dot of the package runs at full f32 precision: on the GPU a
# DEFAULT-precision f32 dot or conv may run in TF32 (~3 decimal digits)
HIGHEST = jax.lax.Precision.HIGHEST


def rfft2(x: jax.Array) -> jax.Array:
    """Batched 2-D R2C transform (reference ``fft``, fft_backproplib.cu:764)."""
    return jnp.fft.rfft2(x)


def irfft2(X: jax.Array, shape: tuple[int, int]) -> jax.Array:
    """Normalized C2R — matches reference ``fft_inv`` which scales by
    ``1/(Nx·Ny)`` after the unnormalized cuFFT (fft_backproplib.cu:831)."""
    return jnp.fft.irfft2(X, s=shape)


def irfft2_unnormalized(X: jax.Array, shape: tuple[int, int]) -> jax.Array:
    """Raw cufftExecC2R semantics (no 1/N) — the reference applies *no*
    normalization when inverse-transforming weight gradients
    (fft_backproplib.cu:1219-1220)."""
    return jnp.fft.irfft2(X, s=shape) * (shape[0] * shape[1])


@functools.lru_cache(maxsize=None)
def _resize_maps(nx: int, ny: int, nxs: int, nys: int):
    """Static gather indices + masks for :func:`spectral_resize`.

    Row/column index maps transcribed from the reference ``resize`` CUDA
    kernel (fft_backproplib.cu:87-157), including its quirks: the output
    Nyquist row/column is always copied from the *input* Nyquist row/column.
    """
    nyr, nyrs = ny // 2 + 1, nys // 2 + 1
    rows = np.zeros(nxs, np.int32)
    row_mask = np.ones(nxs, np.float32)
    cols = np.zeros(nyrs, np.int32)
    col_mask = np.ones(nyrs, np.float32)
    if nxs <= nx:  # downsample (spectrum crop)
        for i in range(nxs):
            if i < nxs // 2:
                rows[i] = i
            elif i == nxs // 2:
                rows[i] = nx // 2
            else:
                rows[i] = i + nx - nxs
        for j in range(nyrs):
            cols[j] = j if j < nyrs - 1 else nyr - 1
    else:  # upsample (zero-pad around the spectrum)
        for i in range(nxs):
            if i < nx // 2:
                rows[i] = i
            elif i > nxs - nx // 2:
                rows[i] = i - nxs + nx
            elif i == nxs // 2:
                rows[i] = nx // 2
            else:
                row_mask[i] = 0.0
        for j in range(nyrs):
            if j < nyr - 1:
                cols[j] = j
            elif j == nyrs - 1:
                cols[j] = nyr - 1
            else:
                col_mask[j] = 0.0
    return rows, row_mask, cols, col_mask


def spectral_resize(X: jax.Array, nx: int, ny: int, nxs: int, nys: int) -> jax.Array:
    """Spectral pooling: crop (down) or zero-pad (up) an rfft2 half-spectrum.

    No amplitude rescale — the reference's ``/=l`` is commented out
    (fft_backproplib.cu:154-155), so spatial amplitudes scale by ``scale²``
    across a down/up round trip leg (and cancel over a symmetric net).
    Reference: ``resize`` fft_backproplib.cu:87-157 via ``pool_fft`` 975-1002.
    """
    rows, row_mask, cols, col_mask = _resize_maps(nx, ny, nxs, nys)
    out = X[..., rows, :][..., :, cols]
    mask = row_mask[:, None] * col_mask[None, :]
    return out * mask


def spectral_pool(X: jax.Array, nx: int, ny: int, scale: int) -> tuple[jax.Array, int, int]:
    """Signed-scale spectral pooling (reference ``pool_fft``).

    ``scale>1``: downsample by crop; ``scale<-1``: upsample by zero-pad.
    Returns the resized spectrum and the new spatial dims.
    """
    if scale == 1 or scale == -1 or scale == 0:
        return X, nx, ny
    if scale > 0:
        nxs, nys = nx // scale, ny // scale
    else:
        nxs, nys = nx * (-scale), ny * (-scale)
    return spectral_resize(X, nx, ny, nxs, nys), nxs, nys


def spectral_conv(X: jax.Array, C: jax.Array, b: jax.Array, nx: int, ny: int,
                  *, scale_by_dm: bool = True,
                  compute_dtype=None) -> jax.Array:
    """Pointwise complex-multiply convolution with DC-bin bias.

    ``out[b,m,ω] = Σ_d (X[b,d,ω]/M)·C[m,d,ω]``, with ``b[m]·Nx·Ny`` added to
    the DC bin — equivalent to a spatial ``+b[m]`` after the normalized
    inverse FFT.  Reference: ``conv_k`` fft_backproplib.cu:162-189.

    The evaluation (one complex einsum, or a re/im broadcast-sum) is
    chosen by :func:`spectralae.core.backend.spectral_conv_impl`.

    Args:
      X: ``[B, D, Nx, Nyr]`` complex input spectra.
      C: ``[M, D, Nx, Nyr]`` complex kernel spectra.
      b: ``[M]`` real biases.
      compute_dtype: optional reduced dtype (``jnp.bfloat16``) for the
        streamed operands; accumulation stays f32.
    """
    from ..core.backend import spectral_conv_impl
    if spectral_conv_impl(compute_dtype) == "split":
        return spectral_conv_split(X, C, b, nx, ny, scale_by_dm=scale_by_dm)
    return spectral_conv_einsum(X, C, b, nx, ny, scale_by_dm=scale_by_dm,
                                compute_dtype=compute_dtype)


def spectral_conv_split(X: jax.Array, C: jax.Array, b: jax.Array,
                        nx: int, ny: int, *,
                        scale_by_dm: bool = True) -> jax.Array:
    """The pointwise conv as split re/im broadcast-multiply-sums over
    ``d`` — elementwise work that XLA emits as one reduction fusion, with
    no matmul (and so no reduced-precision matmul mode) involved."""
    m = C.shape[0]
    scale = (1.0 / m) if scale_by_dm else 1.0
    xr, xi = (X.real * scale)[:, None], (X.imag * scale)[:, None]
    cr, ci = C.real[None], C.imag[None]
    outr = jnp.sum(xr * cr - xi * ci, axis=2)
    outi = jnp.sum(xr * ci + xi * cr, axis=2)
    out = jax.lax.complex(outr, outi)
    return out.at[..., 0, 0].add(b.astype(out.dtype) * (nx * ny))


def spectral_conv_einsum(X: jax.Array, C: jax.Array, b: jax.Array,
                         nx: int, ny: int, *,
                         scale_by_dm: bool = True,
                         compute_dtype=None) -> jax.Array:
    """The pointwise conv as one complex einsum (f32 at ``HIGHEST``
    precision), or four real bf16 einsums with f32 accumulation when
    ``compute_dtype`` is given."""
    m = C.shape[0]
    scale = (1.0 / m) if scale_by_dm else 1.0
    Xs = X * scale
    if compute_dtype is not None:
        # complex bf16 doesn't exist: run the four real products reduced,
        # accumulate f32
        cd = compute_dtype
        f32 = jnp.float32
        xr, xi = Xs.real.astype(cd), Xs.imag.astype(cd)
        cr, ci = C.real.astype(cd), C.imag.astype(cd)
        outr = jnp.einsum("mdxy,bdxy->bmxy", cr, xr,
                          preferred_element_type=f32) \
            - jnp.einsum("mdxy,bdxy->bmxy", ci, xi,
                         preferred_element_type=f32)
        outi = jnp.einsum("mdxy,bdxy->bmxy", cr, xi,
                          preferred_element_type=f32) \
            + jnp.einsum("mdxy,bdxy->bmxy", ci, xr,
                         preferred_element_type=f32)
        out = jax.lax.complex(outr, outi)
    else:
        out = jnp.einsum("mdxy,bdxy->bmxy", C, Xs, precision=HIGHEST)
    return out.at[..., 0, 0].add(b.astype(out.dtype) * (nx * ny))


def kernel_pad(c: jax.Array, nx: int, ny: int) -> jax.Array:
    """Circularly zero-pad a compact ``[..., Nk, Nl]`` kernel to ``[..., Nx, Ny]``
    with the kernel center at the origin (split across the 4 corners).

    Equivalent to the reference's quadrant copy (``kernel_pad``
    fft_backproplib.cu:1018-1064, ``pad_k`` 570-600) — here a single
    place + ``jnp.roll``.
    """
    nk, nl = c.shape[-2], c.shape[-1]
    full = jnp.zeros(c.shape[:-2] + (nx, ny), c.dtype)
    full = full.at[..., :nk, :nl].set(c)
    return jnp.roll(full, (-(nk // 2), -(nl // 2)), axis=(-2, -1))


def kernel_shrink(full: jax.Array, nk: int, nl: int) -> jax.Array:
    """Inverse of :func:`kernel_pad`: extract the compact ``Nk×Nl`` support
    from the 4 corners of a full-size circular array.

    This is the projection that keeps spectrally-trained kernels spatially
    compact.  Reference: ``shrink_k`` fft_backproplib.cu:535-565,
    ``kernel_invpad`` 1069-1112.
    """
    rolled = jnp.roll(full, (nk // 2, nl // 2), axis=(-2, -1))
    return rolled[..., :nk, :nl]


def kernel_rfft(c: jax.Array, nx: int, ny: int) -> jax.Array:
    """Compact kernel → full half-spectrum: the lazily-cached ``net_cfreq``
    entry of the reference (``StoreLoad_cfreq`` fft_backproplib.cu:1146-1161).

    Under jit this is recomputed per step — as a rank-P restricted-DFT
    matmul (:func:`spectralae.ops.dft.kernel_spectrum`), not a
    pad-to-full-grid FFT: the padded route materializes ``M·D·Nx·Ny``
    zeros and runs M·D full-size transforms per stage.  Equal to
    ``rfft2(kernel_pad(c))`` to f32 rounding (tests/test_dft_ops.py).

    For large supports the separable-DFT FLOPs (∝ Nk per output bin)
    overtake the FFT's log-factor and the padded-FFT route wins — the
    crossover sits near Nk ≈ log₂(Nx·Ny); P ≤ 256 taps keeps the matmul
    route for every reference-scale kernel.
    """
    if c.shape[-2] * c.shape[-1] <= 256:
        from . import dft
        return dft.kernel_spectrum(c, nx, ny)
    return rfft2(kernel_pad(c, nx, ny))


def kernel_irfft(C: jax.Array, nk: int, nl: int, nx: int, ny: int) -> jax.Array:
    """Half-spectrum → compact kernel (reference ``export_cfreq``
    fft_backproplib.cu:1166-1172: normalized ``kfft_inv`` + ``kernel_invpad``)."""
    return kernel_shrink(irfft2(C, (nx, ny)), nk, nl)


@functools.lru_cache(maxsize=None)
def _hermitian_weights(nx: int, ny: int) -> np.ndarray:
    """Per-column double-count weights for half-spectrum reductions.

    Interior columns represent two conjugate bins of the full spectrum;
    the reference halves their norm (``n/=2``, fft_backproplib.cu:495) which
    doubles their weight.  The last column is self-conjugate (weight 1) only
    for even ``ny`` — for odd ``ny`` it pairs like any interior column
    (matching ops/dft.py).
    """
    nyr = ny // 2 + 1
    w = np.full((nyr,), 2.0, np.float32)
    w[0] = 1.0
    if ny % 2 == 0:
        w[-1] = 1.0
    return w


def parseval_mse(X: jax.Array, O: jax.Array, d_norm: int, m_norm: int,
                 nx: int, ny: int) -> jax.Array:
    """Spectral MSE with Hermitian double-count correction.

    ``mse = Σ_bins w_j·|X-O|² / (d·Nx·Ny) / (2·m·Nx·Ny)`` — exactly the
    reference's ``calc_mse`` (fft_backproplib.cu:480-498) +
    ``mse_fft`` norm (1178-1192).  By Parseval this equals
    ``Σ_pixels (x-o)² / (2·m·d·Nx·Ny)``.
    """
    w = jnp.asarray(_hermitian_weights(nx, ny))
    diff = X - O
    per_bin = (diff.real**2 + diff.imag**2) * w
    return jnp.sum(per_bin) / (d_norm * nx * ny) / (2 * m_norm * nx * ny)
