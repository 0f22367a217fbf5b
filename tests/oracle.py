"""Pure-numpy oracle encoding the reference's exact semantics.

Each function is a direct (slow, loop-based) transcription of the cited
reference code, used only to validate the JAX/XLA implementations.
Two deliberate deviations from the reference, documented per SURVEY.md §7
("reference quirks vs correctness"):

- ``gradient_CF``/``gradient_CFBP`` index bugs (backproplib.cu:226, 283:
  ``(i-ik)*Nx`` row stride and ``j-ik``) are NOT reproduced — the oracle
  implements the evidently intended ``(i-ik)*Ny + (j-il)`` indexing.
- The dead ``adapt_rate`` (del unconditionally reset to delmax,
  backproplib.cu:34) is reproduced as the no-op it is.
"""

from __future__ import annotations

import numpy as np


# ----------------------------------------------------------------- coord ops

def tap_anchor(size: int, mode: str) -> int:
    if mode == "centered":
        return -(size // 2)
    if mode == "ref_cpu":
        a = (size - 1) // 2 - 1
        return -2 * a - 1
    if mode == "ref_gpu":
        a = ((size - 1) // 2 - 1) // 2
        return -2 * a - 1
    raise ValueError(mode)


def conv_ref(x, c, b, mode="ref_gpu", scale_by_dm=True):
    """Reference conv. netlib.cpp:318-358 (cpu) / backproplib.cu:70-111 (gpu).

    x: [D, Nx, Ny], c: [M, D, Nk, Nl], b: [M] -> [M, Nx, Ny].
    ``ref_cpu`` uses the strict `> 0` bound (netlib.cpp:344).
    """
    D, Nx, Ny = x.shape
    M, _, Nk, Nl = c.shape
    ik0 = tap_anchor(Nk, mode)
    il0 = tap_anchor(Nl, mode)
    lo = 1 if mode == "ref_cpu" else 0
    xin = x / M if scale_by_dm else x
    out = np.zeros((M, Nx, Ny), np.float32)
    for m in range(M):
        for i in range(Nx):
            for j in range(Ny):
                h = 0.0
                for d in range(D):
                    for k in range(Nk):
                        ik = ik0 + k
                        for l in range(Nl):
                            il = il0 + l
                            if lo <= i - ik < Nx and lo <= j - il < Ny:
                                h += c[m, d, k, l] * xin[d, i - ik, j - il]
                out[m, i, j] = h + b[m]
    return out


def pool_ref(x, scale, quantize=False):
    """netlib.cpp:114-164: max-with-0 downsample / NN upsample.

    ``quantize=True`` reproduces the executed reference exactly: ``smax``
    is declared ``int`` (netlib.cpp:127), so every block max is truncated
    toward zero — downsampling returns ``floor(max(0, blockmax))``.
    Caught by tests/test_reference_binary.py against the compiled
    reference; the original transcription here had missed it."""
    D, Nx, Ny = x.shape
    if scale > 0:
        out = np.zeros((D, Nx // scale, Ny // scale), np.float32)
        for d in range(D):
            for i in range(0, Nx, scale):
                for j in range(0, Ny, scale):
                    smax = 0
                    for k in range(scale):
                        for l in range(scale):
                            if i + k < Nx and j + l < Ny \
                                    and x[d, i + k, j + l] > smax:
                                smax = (int(x[d, i + k, j + l])
                                        if quantize
                                        else x[d, i + k, j + l])
                    out[d, i // scale, j // scale] = smax
        return out
    scale = -scale
    out = np.zeros((D, Nx * scale, Ny * scale), np.float32)
    for d in range(D):
        for i in range(Nx * scale):
            for j in range(Ny * scale):
                out[d, i, j] = x[d, i // scale, j // scale]
    return out


def portion_ref(x, q):
    """netlib.cpp:292-315 center crop."""
    Nx, Ny = x.shape[-2:]
    dx = (Nx - Nx // q) // 2
    dy = (Ny - Ny // q) // 2
    return x[..., dx:dx + Nx // q, dy:dy + Ny // q]


# -------------------------------------------------------------- spectral ops

def resize_ref(spec, nx, ny, nxs, nys):
    """fft_backproplib.cu:87-157 spectral resize on the half-spectrum.

    spec: [D, nx, ny//2+1] complex -> [D, nxs, nys//2+1].
    """
    D = spec.shape[0]
    nyr, nyrs = ny // 2 + 1, nys // 2 + 1
    out = np.zeros((D, nxs, nyrs), spec.dtype)
    for d in range(D):
        for i in range(nxs):
            for j in range(nyrs):
                if nxs <= nx:
                    if i < nxs // 2:
                        si = i
                    elif i == nxs // 2:
                        si = nx // 2
                    else:
                        si = i + nx - nxs
                    sj = j if j < nyrs - 1 else nyr - 1
                    out[d, i, j] = spec[d, si, sj]
                else:
                    si = None
                    if i < nx // 2:
                        si = i
                    elif i > nxs - nx // 2:
                        si = i - nxs + nx
                    elif i == nxs // 2:
                        si = nx // 2
                    if si is None:
                        continue
                    if j < nyr - 1:
                        out[d, i, j] = spec[d, si, j]
                    elif j == nyrs - 1:
                        out[d, i, j] = spec[d, si, nyr - 1]
    return out


def conv_k_ref(X, C, b, nx, ny):
    """fft_backproplib.cu:162-189 pointwise complex conv with DC bias.

    X: [D, nx, nyr], C: [M, D, nx, nyr], b: [M] -> [M, nx, nyr].
    """
    M, D = C.shape[0], C.shape[1]
    out = np.zeros((M,) + X.shape[1:], X.dtype)
    for m in range(M):
        acc = np.zeros(X.shape[1:], X.dtype)
        for d in range(D):
            acc += (X[d] / M) * C[m, d]
        acc[0, 0] += b[m] * nx * ny
        out[m] = acc
    return out


def kernel_pad_ref(c, nx, ny):
    """fft_backproplib.cu:1018-1064 corner-quadrant circular pad."""
    M, D, Nk, Nl = c.shape
    out = np.zeros((M, D, nx, ny), c.dtype)
    for m in range(M):
        for d in range(D):
            for k in range(nx):
                for l in range(ny):
                    if 0 <= k <= Nk // 2 and 0 <= l <= Nl // 2:
                        out[m, d, k, l] = c[m, d, Nk // 2 + k, Nl // 2 + l]
                    elif nx - Nk // 2 <= k < nx and 0 <= l <= Nl // 2:
                        out[m, d, k, l] = c[m, d, k - (nx - Nk // 2), Nl // 2 + l]
                    elif 0 <= k <= Nk // 2 and ny - Nl // 2 <= l < ny:
                        out[m, d, k, l] = c[m, d, Nk // 2 + k, l - (ny - Nl // 2)]
                    elif nx - Nk // 2 <= k < nx and ny - Nl // 2 <= l < ny:
                        out[m, d, k, l] = c[m, d, k - (nx - Nk // 2), l - (ny - Nl // 2)]
    return out


def shrink_k_ref(full, nk, nl):
    """fft_backproplib.cu:535-565: extract Nk×Nl support from corners."""
    M, D, nx, ny = full.shape
    out = np.zeros((M, D, nk, nl), full.dtype)
    for m in range(M):
        for d in range(D):
            for k in range(nk):
                for l in range(nl):
                    si = k - nk // 2 if k >= nk // 2 else k + nx - nk // 2
                    sj = l - nl // 2 if l >= nl // 2 else l + ny - nl // 2
                    out[m, d, k, l] = full[m, d, si, sj]
    return out


def calc_mse_ref(X, O, dD, dM, nx, ny):
    """fft_backproplib.cu:480-498 + 1178-1192 Parseval MSE."""
    nyr = ny // 2 + 1
    total = 0.0
    for d in range(X.shape[0]):
        for i in range(nx):
            for j in range(nyr):
                n = dD * nx * ny
                if 0 < j < nyr - 1:
                    n /= 2
                diff = X[d, i, j] - O[d, i, j]
                total += (diff.real**2 + diff.imag**2) / n
    return total / (2 * dM * nx * ny)


# ---------------------------------------------------------------- gradients

def gradient_k_io_ref(Xin, Yout, O, Cf, Ff, b, p, dM, dD, nx, ny):
    """fft_backproplib.cu:395-475 analytic momentum-space gradients.

    Xin/Yout/O: [D, nx, nyr] input / expected-output / current-output spectra.
    Cf: [M, D, nx, nyr] encoder kernel spectra; Ff: [D, M, nx, nyr] decoder.
    Returns (dc [M,D,nx,nyr], df [D,M,nx,nyr], db [M], dp [D]).
    """
    nyr = ny // 2 + 1
    norm = nx * ny
    Norm = norm * 2 * dM * dD * nx * ny
    E = O - Yout                                     # (ofreq - freqout)
    dc = np.zeros((dM, dD, nx, nyr), np.complex64)
    df = np.zeros((dD, dM, nx, nyr), np.complex64)
    db = np.zeros((dM,), np.float32)
    dp = np.zeros((dD,), np.float32)
    for m in range(dM):
        # Σ_{d1} E_{d1}·conj(F_{d1,m})  (the sumc** quadruple, 421-424)
        S = np.zeros((nx, nyr), np.complex64)
        # H_m = Σ_{d1} C_{m,d1}·X_{d1} (+ b·NxNy at DC) — note: *no* /dM here
        H = np.zeros((nx, nyr), np.complex64)
        sumb = 0.0
        for d1 in range(dD):
            S += E[d1] * np.conj(Ff[d1, m])
            H += Cf[m, d1] * Xin[d1]
            sumb += (E[d1, 0, 0] * np.conj(Ff[d1, m, 0, 0])).real
        H[0, 0] += b[m] * norm
        for d in range(dD):
            dc[m, d] = S * np.conj(Xin[d]) / Norm
            df[d, m] = E[d] * np.conj(H) / Norm
        db[m] = sumb * norm / Norm
    for d in range(dD):
        dp[d] = E[d, 0, 0].real * norm / Norm
    return dc, df, db, dp


def gradient_coord_ref(in_s, out_s, hin_s, f, mode="ref_gpu"):
    """backproplib.cu:186-288 coordinate-space gradients (identity act),
    with the intended (bug-fixed) dDdF indexing — see module docstring.

    in_s/out_s: [D, Nx, Ny]; hin_s: [M, Nx, Ny]; f: [D, M, Nk, Nl].
    Returns (dDdC [M,D,Nk,Nl], dDdF [D,M,Nk,Nl], dDdB [M], dDdP [D]).
    """
    D, Nx, Ny = in_s.shape
    M = hin_s.shape[0]
    _, _, Nk, Nl = f.shape
    ik0 = tap_anchor(Nk, mode)
    il0 = tap_anchor(Nl, mode)
    Norm = D * M * Nk * Nl * Nx * Ny
    E = out_s - in_s                      # sum0 with act1 == 1
    dDdC = np.zeros((M, D, Nk, Nl), np.float64)
    dDdF = np.zeros((D, M, Nk, Nl), np.float64)
    dDdB = np.zeros((M,), np.float64)
    dDdP = np.zeros((D,), np.float64)
    for m in range(M):
        for k in range(Nk):
            ik = ik0 + k
            for l in range(Nl):
                il = il0 + l
                for d in range(D):
                    acc_c = 0.0
                    for d1 in range(D):
                        for i in range(Nx):
                            for j in range(Ny):
                                s1 = 0.0
                                for k1 in range(Nk):
                                    ik1 = ik0 + k1
                                    for l1 in range(Nl):
                                        il1 = il0 + l1
                                        if (0 <= i - ik1 < Nx and 0 <= j - il1 < Ny
                                                and 0 <= i - ik1 - ik < Nx
                                                and 0 <= j - il1 - il < Ny):
                                            s1 += (f[d1, m, k1, l1]
                                                   * in_s[d, i - ik1 - ik, j - il1 - il])
                                acc_c += E[d1, i, j] * s1
                    dDdC[m, d, k, l] = acc_c / Norm
                    acc_f = 0.0
                    for i in range(Nx):
                        for j in range(Ny):
                            if 0 <= i - ik < Nx and 0 <= j - il < Ny:
                                acc_f += E[d, i, j] * hin_s[m, i - ik, j - il]
                    dDdF[d, m, k, l] = acc_f / Norm
        # bias gradients (k==l==0 branch of gradient_CFBP, 201-231)
        acc_b = 0.0
        for d1 in range(D):
            for i in range(Nx):
                for j in range(Ny):
                    s1 = 0.0
                    for k1 in range(Nk):
                        ik1 = ik0 + k1
                        for l1 in range(Nl):
                            il1 = il0 + l1
                            if 0 <= i - ik1 < Nx and 0 <= j - il1 < Ny:
                                s1 += f[d1, m, k1, l1]
                    acc_b += E[d1, i, j] * s1
        dDdB[m] = acc_b / Norm
    for d in range(D):
        dDdP[d] = E[d].sum() / Norm
    return dDdC, dDdF, dDdB, dDdP


def momentum_update_ref(w, g, mom, lr, alpha):
    """The normalized-gradient inertia update used everywhere in the reference
    (backproplib.cu:392-396, fft_backproplib.cu:616-617).

    dw = (1-α)·lr·g/max(|g|,10)... NOTE the reference writes
    ``g/((10<|g|)?|g|:10)`` i.e. divide by max(|g|, 10).
    Returns (w', mom').
    """
    denom = np.maximum(np.abs(g), 10.0)
    dw = (1 - alpha) * lr * g / denom + alpha * mom
    return w - dw, dw


def gradient_diff_ref(c, f, b, p):
    """fft_backproplib.cu:709-753 kernel-diversity (repulsion) gradients.

    c: [M,D,Nk,Nl], f: [D,M,Nk,Nl], b: [M], p: [D].
    Pairs with m1==m or d1==d are excluded (quirk, line 724).
    """
    M, D, Nk, Nl = c.shape
    cd = np.zeros_like(c)
    fd = np.zeros_like(f)
    bd = np.zeros_like(b)
    pd = np.zeros_like(p)
    for m in range(M):
        for d in range(D):
            sum_b = 0.0
            sum_p = 0.0
            for m1 in range(M):
                for d1 in range(D):
                    if m1 != m and d1 != d:
                        den_c = np.sum((c[m, d] - c[m1, d1]) ** 2)
                        den_f = np.sum((f[d, m] - f[d1, m1]) ** 2)
                        cd[m, d] += (c[m, d] - c[m1, d1]) / den_c
                        fd[d, m] += (f[d, m] - f[d1, m1]) / den_f
                    if m1 == 0 and d1 != d:
                        sum_p += 1.0 / (p[d] - p[d1])
                if m1 != m:
                    sum_b += 1.0 / (b[m] - b[m1])
            bd[m] = sum_b
            pd[d] = sum_p
    return cd, fd, bd, pd


# ------------------------------------------------------- whole-net forwards

def conv_ref_vec(x, c, b, mode="ref_gpu", scale_by_dm=True):
    """:func:`conv_ref` vectorized over pixels (one shifted-plane product
    per tap) — the same sums, fast enough for full-size frames; pinned
    equal to the loop form in tests/test_chip_smoke.py."""
    D, Nx, Ny = x.shape
    M, _, Nk, Nl = c.shape
    ik0 = tap_anchor(Nk, mode)
    il0 = tap_anchor(Nl, mode)
    lo = 1 if mode == "ref_cpu" else 0
    xin = x / M if scale_by_dm else x
    out = np.zeros((M, Nx, Ny), np.result_type(x, c)) + b[:, None, None]
    for k in range(Nk):
        ik = ik0 + k
        i0, i1 = max(0, lo + ik), min(Nx, Nx + ik)
        for l in range(Nl):
            il = il0 + l
            j0, j1 = max(0, lo + il), min(Ny, Ny + il)
            if i0 >= i1 or j0 >= j1:
                continue
            shifted = np.zeros_like(xin)
            shifted[:, i0:i1, j0:j1] = xin[:, i0 - ik:i1 - ik, j0 - il:j1 - il]
            out += np.einsum("md,dij->mij", c[:, :, k, l], shifted)
    return out


def forward_coord_ref(stages, x, scales, mode="centered"):
    """Coordinate-space forward of one frame (autoencoder.cpp:135-150):
    encoder pool → conv, decoder conv → unpool.  ``stages``: list of
    (c, b) numpy pairs in tape order; returns the reconstruction."""
    n = len(stages)
    h = x
    for i, ((c, b), sc) in enumerate(zip(stages, scales)):
        if i < n // 2:
            h = pool_ref(h, sc) if sc not in (-1, 0, 1) else h
            h = conv_ref_vec(h, c, b, mode)
        else:
            h = conv_ref_vec(h, c, b, mode)
            h = pool_ref(h, sc) if sc not in (-1, 0, 1) else h
    return h


def _pool_fft_ref(X, nx, ny, scale):
    """pool_fft (fft_backproplib.cu:975-1002) through resize_ref."""
    if scale in (-1, 0, 1):
        return X, nx, ny
    nxs, nys = ((nx // scale, ny // scale) if scale > 0
                else (nx * -scale, ny * -scale))
    return resize_ref(X, nx, ny, nxs, nys), nxs, nys


def forward_fft_ref(stages, x, scales):
    """Momentum-space forward of one frame (autoenc_fft,
    fft_backproplib.cu:1331-1376): one rfft2, per-stage spectral pool and
    pointwise complex conv against the padded kernels' spectra, one
    normalized irfft2."""
    D, nx, ny = x.shape
    X = np.fft.rfft2(x)
    n = len(stages)
    cx, cy = nx, ny
    for i, ((c, b), sc) in enumerate(zip(stages, scales)):
        if i < n // 2:
            X, cx, cy = _pool_fft_ref(X, cx, cy, sc)
        C = np.fft.rfft2(kernel_pad_ref(c, cx, cy))
        X = conv_k_ref(X, C, b, cx, cy)
        if i >= n // 2:
            X, cx, cy = _pool_fft_ref(X, cx, cy, sc)
    return np.fft.irfft2(X, s=(cx, cy))
