"""Momentum-space training: the 100-iteration frozen-input burst.

The reference's ``backprop_fft`` (source/fft_backproplib.cu:1381-1511) FFTs
the training patch once, then runs 100 inner iterations of:

  1. analytic frequency-domain gradients (``gradient_k_io``, 395-475),
  2. inverse-FFT the gradient spectra (*unnormalized* C2R, 1219-1220),
  3. project onto the compact Nk×Nl kernel support (``shrink_k``, 1225-1226),
  4. inertia update in coordinate space (α=0.9 hard-coded, 608),
  5. re-pad + forward-FFT the updated kernels (1276-1282),
  6. recompute the output spectrum through the two-stage frequency conv
     (1460-1461) and log the Parseval MSE.

Design: the whole burst is ONE jitted ``lax.fori_loop`` — no
per-iteration host syncs, no plan/alloc churn (the reference does ~40
cudaMallocs and 2 plan creations per call, plus a device→host reduce and a
``cout`` per iteration).  The MSE trajectory is collected into an on-device
array and returned after the loop, per SURVEY.md §7 "hard parts".
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..ops import dft, spectral
from ..ops.spectral import HIGHEST
from ..losses.losses import diversity_gradients
from ..optim.update import GRAD_CLIP, burst_inertia


class FFTBurstResult(NamedTuple):
    c: jax.Array        # [M, D, Nk, Nl] updated encoder kernels
    f: jax.Array        # [D, M, Nk, Nl] updated decoder kernels
    b: jax.Array        # [M] encoder biases
    p: jax.Array        # [D] decoder biases
    mom: tuple          # (Dc, Df, Db, Dp) momentum carry
    mses: jax.Array     # [iters+1] Parseval MSE trajectory (index 0 = initial)


def gradient_k_io(X: jax.Array, Y: jax.Array, O: jax.Array,
                  Cf: jax.Array, Ff: jax.Array, b: jax.Array,
                  nx: int, ny: int):
    """Analytic momentum-space gradients of the Parseval MSE.

    Closed forms (verified against fft_backproplib.cu:395-475):

      E        = O − Y                       (output − expected, per bin)
      S_m      = Σ_d E_d · conj(F_{d,m})
      H_m      = Σ_d C_{m,d} · X_d  (+ b_m·Nx·Ny at DC; note *no* 1/M here —
                 a reference quirk: the forward scales by 1/M, the gradient
                 does not)
      dC_{m,d} = S_m · conj(X_d) / Norm
      dF_{d,m} = E_d · conj(H_m) / Norm
      dB_m     = Re(S_m(0,0)) · Nx·Ny / Norm
      dP_d     = Re(E_d(0,0)) · Nx·Ny / Norm

    with Norm = 2·M·D·(Nx·Ny)².
    """
    dM = Cf.shape[0]
    dD = Cf.shape[1]
    norm = nx * ny
    Norm = norm * 2.0 * dM * dD * nx * ny
    E = O - Y
    S = jnp.einsum("dxy,dmxy->mxy", E, jnp.conj(Ff),
                   precision=HIGHEST)
    H = jnp.einsum("mdxy,dxy->mxy", Cf, X,
                   precision=HIGHEST)
    H = H.at[:, 0, 0].add(b.astype(H.dtype) * norm)
    dc = jnp.einsum("mxy,dxy->mdxy", S, jnp.conj(X),
                   precision=HIGHEST) / Norm
    df = jnp.einsum("dxy,mxy->dmxy", E, jnp.conj(H),
                   precision=HIGHEST) / Norm
    db = S[:, 0, 0].real * norm / Norm
    dp = E[:, 0, 0].real * norm / Norm
    return dc, df, db, dp


def _kernel_spectrum(c, nx, ny, impl):
    """Compact kernel → half-spectrum: FFT path (pad+rfft2) or the
    compact-support DFT matmul (:mod:`spectralae.ops.dft`)."""
    if impl == "dft":
        return dft.kernel_spectrum(c, nx, ny)
    return spectral.kernel_rfft(c, nx, ny)


def _kernel_gradient(D, nk, nl, nx, ny, impl):
    """Gradient spectrum → compact spatial gradient (unnormalized C2R +
    shrink projection, fft_backproplib.cu:1219-1226)."""
    if impl == "dft":
        return dft.kernel_project(D, nk, nl, nx, ny)
    return spectral.kernel_shrink(
        spectral.irfft2_unnormalized(D, (nx, ny)), nk, nl)


def _two_stage_output(X, c, f, b, p, nx, ny, scale_by_dm=True, impl="fft"):
    """Recompute the output spectrum O = F·(C·X) (fft_backproplib.cu:1460-1461)."""
    Cf = _kernel_spectrum(c, nx, ny, impl)
    Ff = _kernel_spectrum(f, nx, ny, impl)
    # the plain einsum: this body is the reference the routed paths are
    # compared with
    H = spectral.spectral_conv_einsum(X[None], Cf, b, nx, ny,
                                      scale_by_dm=scale_by_dm)[0]
    O = spectral.spectral_conv_einsum(H[None], Ff, p, nx, ny,
                                      scale_by_dm=scale_by_dm)[0]
    return O, Cf, Ff


def _inertia(w, g, mom, lr, alpha):
    return burst_inertia(w, g, mom, lr, alpha)


@functools.partial(
    jax.jit,
    static_argnames=("iters", "maxdiff", "scale_by_dm", "impl"))
def fft_burst(x: jax.Array, expout: jax.Array, out0: jax.Array,
              c: jax.Array, f: jax.Array, b: jax.Array, p: jax.Array,
              mom: tuple | None = None, *,
              lr: float = 0.2, alpha: float = 0.9, iters: int = 100,
              maxdiff: bool = False, w0: float = 1.0, w1: float = 10.0,
              scale_by_dm: bool = True, impl: str = "dft") -> FFTBurstResult:
    """One ``backprop_fft`` call: a full frozen-input optimization burst.

    Args:
      x: ``[D, h, w]`` input patch (frozen for the whole burst).
      expout: ``[D, h, w]`` expected output (the reference passes the input).
      out0: ``[D, h, w]`` current network output (seeds the first gradient).
      c/f/b/p: compact kernels and biases of the trained stage pair.
      mom: optional (Dc, Df, Db, Dp) momentum carry; zeros when None —
        the reference zeroes them per call (fft_backproplib.cu:1420-1423).
      lr: the keyboard lr; the effective rate is ``0.1·lr``
        (fft_backproplib.cu:1445).
      alpha: inertia weight — hard-coded 0.9 in the reference (line 608).
      maxdiff: multiobjective kernel-diversity combination
        ``g ← w0·g − w1·g_div`` (fft_backproplib.cu:1252, 665-694).
      impl: kernel↔spectrum transform implementation — "dft" (default)
        maps the compact-support transforms onto small matmuls
        (:mod:`spectralae.ops.dft`); "fft" is the literal pad+rfft2 path.
        Both are numerically equivalent (tests/test_dft_ops.py).
    """
    nx, ny = x.shape[-2], x.shape[-1]
    dM, dD, nk, nl = c.shape
    del_eff = 0.1 * lr
    X = spectral.rfft2(x)
    Y = spectral.rfft2(expout)
    O = spectral.rfft2(out0)
    if mom is None:
        mom = (jnp.zeros_like(c), jnp.zeros_like(f),
               jnp.zeros_like(b), jnp.zeros_like(p))
    mse0 = spectral.parseval_mse(Y, O, dD, dM, nx, ny)
    mses = jnp.zeros((iters + 1,), x.dtype).at[0].set(mse0)

    Cf0 = _kernel_spectrum(c, nx, ny, impl)
    Ff0 = _kernel_spectrum(f, nx, ny, impl)

    def body(i, carry):
        # kernel spectra are carried across iterations (computed once per
        # update) — the reference re-FFTs inside `backprop` and reuses the
        # device buffers the same way (fft_backproplib.cu:1281-1282)
        c, f, b, p, Dc, Df, Db, Dp, O, Cf, Ff, mses = carry
        dc, df, db, dp = gradient_k_io(X, Y, O, Cf, Ff, b, nx, ny)
        # spectral grads → spatial, projected to compact support
        gc = _kernel_gradient(dc, nk, nl, nx, ny, impl)
        gf = _kernel_gradient(df, nk, nl, nx, ny, impl)
        gb, gp = db, dp
        if maxdiff:
            cd, fd, bd, pd = diversity_gradients(c, f, b, p)
            gc = w0 * gc - w1 * cd
            gf = w0 * gf - w1 * fd
            gb = w0 * gb - w1 * bd
            gp = w0 * gp - w1 * pd
        c, Dc = _inertia(c, gc, Dc, del_eff, alpha)
        f, Df = _inertia(f, gf, Df, del_eff, alpha)
        b, Db = _inertia(b, gb, Db, del_eff, alpha)
        p, Dp = _inertia(p, gp, Dp, del_eff, alpha)
        O, Cf, Ff = _two_stage_output(X, c, f, b, p, nx, ny, scale_by_dm,
                                      impl)
        mse = spectral.parseval_mse(Y, O, dD, dM, nx, ny)
        mses = mses.at[i + 1].set(mse)
        return (c, f, b, p, Dc, Df, Db, Dp, O, Cf, Ff, mses)

    init = (c, f, b, p, *mom, O, Cf0, Ff0, mses)
    out = lax.fori_loop(0, iters, body, init)
    c, f, b, p, Dc, Df, Db, Dp = out[:8]
    mses = out[-1]
    return FFTBurstResult(c=c, f=f, b=b, p=p, mom=(Dc, Df, Db, Dp), mses=mses)
