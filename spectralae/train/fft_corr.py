"""Correlation-space momentum burst: O(1)-per-iteration in resolution.

The reference burst (source/fft_backproplib.cu:1381-1511) freezes the input
spectrum for all 100 inner iterations.  Every per-iteration ω-space sum —
the analytic gradients (gradient_k_io, 395-475), their compact-support
projection (shrink_k, 535-565), and the Parseval MSE (calc_mse, 480-498) —
is therefore a fixed form in the *compact* kernels ``c, f`` whose
ω-dependence collapses onto a handful of cross-correlation tensors of the
frozen signals:

    XX[d,d'][v] = Σ_ω w(ω)·conj(X[d])·X[d']·e^{iθ_v(ω)}
                = Nx·Ny · irfft2(conj(X[d])·X[d'])[v mod N]

with lags ``v`` ranging over sums/differences of kernel-tap offsets — a
[D, D, 4h+1, 4h+1] tensor (17×17 at 5×5 kernels).  After a one-time FFT
precompute, each inner iteration is ~2 MFLOP of small einsums over
[M, D, P]-sized operands — independent of resolution AND batch (batched
bursts average the correlation tensors up front, giving ``fft_burst_dp``
semantics for free; a multi-chip DP burst needs ONE pmean of the tensors,
then every iteration is collective-free).

**Anchored decomposition (precision).**  Gradients and MSE vanish at
convergence, so any correlation-space evaluation is a cancellation; done
naively (O vs Y energies) it cancels at *signal-energy* scale and fp32
dies once MSE drops ~1e-6 of Σw|Y|² — measured as negative MSEs on
pixel-scale images.  Instead, with K the composed kernel (f ∗ c summed
over m, [D,D,(2h+1)²] taps) and K₀ its value at burst entry, the
continuum error splits exactly as

    E = (O₀ − Y)  +  (s1·K̂₀X − O₀)  +  s1·ΔK̂X ,   ΔK = K − K₀

whose first two parts are precomputed **bin-wise** (tiny per-bin
differences — no cancellation) as lag tensors XE0 and XG0, leaving

    T[d',d][L] = XE0ᵀ + XG0ᵀ + s1·R(ΔK),
    R(ΔK)[d',d][L] = Σ_{d'',u} ΔK[d',d'',u]·XX[d,d''][L−u]
    gc[m,d,p]  = Σ_{d',q̄} f[d',m,q̄]·T[d',d][tap_p+tap_q̄] + DC
    gf[d',m,q] = Σ_{d,r}  c[m,d,r] ·T[d',d][tap_q+tap_r] + DC
    mse = Σw|E₀|² + 2Σw Re Ē₀G₀ + Σw|G₀|²
          + 2·s1·⟨ΔK, XE0+XG0⟩ + s1²·⟨ΔK, R(ΔK)⟩ + DC

— every cancellation now happens at *initial-error* scale, so gradients
and MSE stay accurate until the error drops ~1e6× below its start (same
invariant as the ω-space kernels' per-bin accumulation, tested through a
350× MSE reduction and on pixel-scale engine bursts).  A pleasant side
effect: gc and gf share one T tensor, so no quadratic-in-c machinery.

All lag gathers/scatters have static index maps lowered as dense one-hot
matmuls (instead of scalar gathers); centered lags come from roll+slice
with periodic tiling, so sub-window grids alias exactly (the DFT only sees
v mod N).  DC-bin bias injections (conv_k, cu:183-184) are
handled as exact scalar corrections.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..losses.losses import diversity_gradients
from ..ops import dft, spectral
from ..optim.update import burst_inertia
from .fft import FFTBurstResult

# every dot here is f32 at full precision (a DEFAULT-precision f32 dot may
# run in TF32 on the GPU, and the anchored decomposition's cancellations
# need the f32 mantissa)
_ein = functools.partial(jnp.einsum, precision=lax.Precision.HIGHEST)
_mm = functools.partial(jnp.matmul, precision=lax.Precision.HIGHEST)


@functools.lru_cache(maxsize=None)
def _lag_maps(nk: int, nl: int):
    """Static index maps between tap-offset lags and gathered tensors.

    Taps: a ∈ [−hx, hx] × [−hy, hy].  Lag grids per axis: L2 = ±2h (pair
    sums and the composed-kernel support), V4 = ±4h (L2 differences).
    """
    hx, hy = nk // 2, nl // 2
    tx = np.arange(nk) - hx
    ty = np.arange(nl) - hy
    # flat tap list, P = nk*nl, order (kx, ky) row-major like kernels
    tpx = np.repeat(tx, nl)
    tpy = np.tile(ty, nk)
    w2x, w2y = 4 * hx + 1, 4 * hy + 1
    w4x, w4y = 8 * hx + 1, 8 * hy + 1

    def flat(ax, ay, hax, hay, wy):
        return (ax + hax) * wy + (ay + hay)

    def onehot(idx, n):
        """Gather/scatter as a dense one-hot matrix (the static maps
        then become matmuls instead of scalar gathers)."""
        m = np.zeros((idx.size, n), np.float32)
        m[np.arange(idx.size), idx.reshape(-1)] = 1.0
        return m

    # (p, q) tap pair -> L2 lag of tap_p + tap_q   [P·P]
    pair2lag = flat(tpx[:, None] + tpx[None, :],
                    tpy[:, None] + tpy[None, :],
                    2 * hx, 2 * hy, w2y).reshape(-1)
    # (L2, u) -> V4 index of L2 − u                [L2·L2]
    l2x = np.repeat(np.arange(w2x) - 2 * hx, w2y)
    l2y = np.tile(np.arange(w2y) - 2 * hy, w2x)
    xxd = flat(l2x[:, None] - l2x[None, :],
               l2y[:, None] - l2y[None, :], 4 * hx, 4 * hy, w4y)

    n2, n4 = w2x * w2y, w4x * w4y
    pair_oh = onehot(pair2lag, n2)
    # the XXd one-hot is [n4, n2²] — fine at 5×5 (7.6 MB: the per-burst
    # build is one matmul), but it grows as k⁶ (3.75 GB at 13×13, where
    # materializing it as a jit constant stalls compilation for minutes).
    # Large kernels ship the tiny int32 index map instead; the build is
    # then ONE gather per burst (XXd is loop-invariant), so gather
    # slowness never touches the iteration loop.
    g_xxd = (onehot(xxd, n4).T
             if n4 * n2 * n2 <= 32 * 2 ** 20 else None)
    return dict(
        g_scatter_pair=pair_oh,                 # [P², n2] scatter-sum
        g_pair=pair_oh.T,                       # [n2, P²] gather
        g_xxd=g_xxd,                            # [n4, n2·n2] or None
        xxd_idx=xxd.reshape(-1).astype(np.int32),   # [n2·n2] V4 indices
        v4ext=(4 * hx, 4 * hy), l2ext=(2 * hx, 2 * hy),
        n2=n2, n4=n4)


# the separable restricted-iDFT lag-window bases live with the other DFT
# primitives
_lag_basis = dft.lag_basis

# Plane-pixel budget above which the fused precompute's signal transform
# serializes per plane (lax.map) instead of one batched FFT call: same
# flops and bytes, ~planes× lower transient peak.  Not yet derived from the
# device's memory (ROADMAP, large-frame memory policy).
_XLA_FFT_SERIALIZE_PIXELS = 4 * 8192 * 8192


def _corr_windows(prods, nx, ny, hx, hy):
    """Centered lag windows ``[planes, 2hx+1, 2hy+1]`` of the circular
    cross-correlations whose half-spectra are ``prods [planes, nx, nyr]``
    (complex).  See :func:`_lag_basis`.

    Matmul shaping: the y-stage (the FLOP bulk — it contracts the full
    half-spectrum row length) runs as ONE stacked real matmul
    ``[p·nx, 2·nyr] @ [2·nyr, 2·vy]`` computing [sr si] together, instead
    of four narrow width-vy einsums — same FLOPs, 4× fewer and 2× wider
    matmuls (vy is 9–17).  The x-stage
    output is window-sized and negligible.
    """
    bxc, bxs, byc, bys = (jnp.asarray(t)
                          for t in _lag_basis(nx, ny, hx, hy))
    p, _, nyr = prods.shape
    vy = byc.shape[1]
    pr, pi = prods.real, prods.imag
    # full-f32 accumulation (_ein): these long-axis reductions feed
    # cancellation-sensitive tensors
    #   sr = pr·byc − pi·bys ,  si = pr·bys + pi·byc
    # = [pr pi] (contraction-stacked) @ [[byc bys], [−bys byc]]
    ops = jnp.concatenate([pr, pi], axis=-1)          # [p, nx, 2nyr]
    basis = jnp.concatenate(
        [jnp.concatenate([byc, bys], axis=1),
         jnp.concatenate([-bys, byc], axis=1)], axis=0)  # [2nyr, 2vy]
    # flattened to ONE [p·nx, 2nyr] @ [2nyr, 2vy] matmul (a batched
    # einsum over p lowers to p narrow matmuls)
    s = _ein("rz,zw->rw", ops.reshape(p * ops.shape[1], -1),
             basis).reshape(p, -1, 2 * vy)            # [p, nx, 2vy]
    sr, si = s[..., :vy], s[..., vy:]
    return _ein("pxv,xu->puv", sr, bxc) - _ein("pxv,xu->puv", si, bxs)


def _herm_w(nx: int, ny: int):
    # canonical constructor lives in ops/spectral (one site for the
    # odd-ny edge case); broadcasts over the column axis
    return spectral._hermitian_weights(nx, ny)


def corr_precompute(x, expout, out0, c0, f0, *, scale_by_dm=True,
                    axis_name=None, model_axis=None):
    """One-time correlation precompute for a frozen-input burst.

    Returns the batch-averaged lag tensors + scalars consumed by
    :func:`corr_iterate`: XX (input autocorrelation, V4 lags), XE0 and XG0
    (input vs initial-error / vs forward-anchor mismatch, L2 lags), the
    error-energy scalars, and the DC-bin scalars.  ``c0/f0`` must be the
    kernels the burst starts from (they define the anchor K₀).

    Inside shard_map: ``axis_name`` (data axis) pmeans the tensors over
    the batch shards; ``model_axis`` splits the resolution-dependent
    irfft2 planes across model shards (tensor parallelism over the only
    stage whose cost scales with Nx·Ny).
    """
    nx, ny = x.shape[-2], x.shape[-1]
    dD = x.shape[-3]
    dM = c0.shape[0]
    nk, nl = c0.shape[-2], c0.shape[-1]
    maps = _lag_maps(nk, nl)
    X = spectral.rfft2(x)                          # [B, D, nx, nyr]
    Y = spectral.rfft2(expout)
    O0 = spectral.rfft2(out0)
    Xc = jnp.conj(X)
    E0 = O0 - Y
    # anchor mismatch G₀ = s1·K̂₀X − O₀, still accumulated BIN-WISE (the
    # anchoring precision invariant) but through the COMPOSED kernel
    # K₀ = f₀ ∗ c₀ — [D, D] spectra of the (4h+1)² composed taps instead
    # of two M-wide convs over [M, D] kernel spectra (6× less anchor-stage
    # work at M=10; ĉ·f̂ summed over m ≡ K̂₀ by the same one-hot scatter
    # map the iterate's R(ΔK) identity is built on)
    P = nk * nl
    hx2, hy2 = maps["l2ext"]
    K2 = _ein("emq,mdr->edqr", f0.reshape(dD, dM, P),
              c0.reshape(dM, dD, P)).reshape(dD * dD, P * P)
    K0taps = (_mm(K2, jnp.asarray(maps["g_scatter_pair"]))
              ).reshape(dD, dD, 2 * hx2 + 1, 2 * hy2 + 1)
    K0f = dft.kernel_spectrum(K0taps, nx, ny)          # [D, D, nx, nyr]
    s1 = (1.0 / (dM * dD)) if scale_by_dm else 1.0
    # elementwise d-reduce: D is a tiny contraction, and elementwise f32
    # needs no matmul precision mode
    O0fwd = jnp.sum(K0f[None] * X[:, None], axis=2) * s1
    G0 = O0fwd - O0
    # batch-averaged correlation tensors (Hermitian products ⇒ real); the
    # mean over B commutes with the transform, so average the bin-wise
    # products first.  Centered lag windows via the separable restricted
    # iDFT (:func:`_lag_basis`): the burst reads only a handful of lags
    # per plane, so four small matmuls beat a full-grid inverse FFT — and
    # each plane group is transformed at exactly the extent it needs (XX
    # at ±4h for the L2-difference tensor, XE0/XG0 at ±2h: ~1.9× less
    # matmul work than one all-V4 pass)
    nyr = X.shape[-1]
    prods_xx = jnp.mean(Xc[:, :, None] * X[:, None],
                        axis=0).reshape(-1, nx, nyr)
    prods_eg = jnp.concatenate([
        jnp.mean(Xc[:, :, None] * E0[:, None], axis=0).reshape(-1, nx, nyr),
        jnp.mean(Xc[:, :, None] * G0[:, None], axis=0).reshape(-1, nx, nyr),
    ], axis=0)
    hx4, hy4 = maps["v4ext"]

    def windows(prods, hx_, hy_):
        if model_axis is None:
            return _corr_windows(prods, nx, ny, hx_, hy_)
        # TP: each model shard transforms its slice of the plane stack;
        # the gathered windows are tiny ([planes, 2h+1, 2h+1])
        nm = lax.axis_size(model_axis)
        nplanes = prods.shape[0]
        chunk = -(-nplanes // nm)
        prods_p = jnp.pad(prods, ((0, chunk * nm - nplanes),
                                  (0, 0), (0, 0)))
        mine = lax.dynamic_slice_in_dim(
            prods_p, lax.axis_index(model_axis) * chunk, chunk)
        win_mine = _corr_windows(mine, nx, ny, hx_, hy_)
        return lax.all_gather(win_mine, model_axis, axis=0
                              ).reshape(-1, 2 * hx_ + 1,
                                        2 * hy_ + 1)[:nplanes]

    dd = dD * dD
    win_eg = windows(prods_eg, hx2, hy2)
    XX = windows(prods_xx, hx4, hy4).reshape(dD, dD, -1)
    XE0 = win_eg[:dd].reshape(dD, dD, -1)
    XG0 = win_eg[dd:].reshape(dD, dD, -1)
    wv = jnp.asarray(_herm_w(nx, ny))
    E0E0 = jnp.mean(jnp.sum((E0.real ** 2 + E0.imag ** 2) * wv,
                            axis=(-2, -1, -3)))
    GG0 = jnp.mean(jnp.sum((G0.real ** 2 + G0.imag ** 2) * wv,
                           axis=(-2, -1, -3)))
    EG0 = jnp.mean(jnp.sum((E0.real * G0.real + E0.imag * G0.imag) * wv,
                           axis=(-2, -1, -3)))
    # DC scalars (bin 0 of real-signal spectra is real); batch-averaged —
    # every DC correction below is linear in the per-frame scalars
    X0 = jnp.mean(X[:, :, 0, 0].real, axis=0)                # [D]
    E00 = jnp.mean(E0[:, :, 0, 0].real, axis=0)              # [D]
    G00 = jnp.mean(G0[:, :, 0, 0].real, axis=0)              # [D]
    out = dict(XX=XX, XE0=XE0, XG0=XG0, E0E0=E0E0, GG0=GG0, EG0=EG0,
               X0=X0, E00=E00, G00=G00)
    if axis_name is not None:
        out = jax.tree.map(lambda t: lax.pmean(t, axis_name), out)
    return out


def _tp_xla_windows(X, K0taps, nx, ny, nyr, B, dD, dd, hx2, hy2, hx4,
                    hy4, s1, wv, nm, midx, shard, gather, model_axis):
    """Model-sharded XLA window pipeline (the TP body).

    Shards the continuum-error contraction over output channels e, the
    EG products over d×(e-chunk), and the XX products over the D² plane
    pairs; returns (XX, EGwin, SEG, X0, E_cont0)."""
    Xc = jnp.conj(X)
    # 2. composed-kernel restricted DFTs + the continuum-error
    # contraction, sharded over output channels e (zero-padded rows
    # yield EG ≡ 0, so they contribute nothing downstream)
    K0rows, chunk_e = shard(K0taps)            # [chunk_e, D, ·, ·]
    K0f_l = dft.kernel_spectrum(K0rows, nx, ny)
    X_e, _ = shard(jnp.moveaxis(X, 1, 0))      # [chunk_e, B, nx, nyr]
    # elementwise d-reduce (exact f32; see the unsharded body)
    EGl = (jnp.sum(K0f_l[None] * X[:, None], axis=2) * s1
           - jnp.moveaxis(X_e, 0, 1))          # [B, chunk_e, nx, nyr]
    # 3. eg products: all d × this shard's e-chunk, windows at ±2h
    prods_eg_l = jnp.mean(Xc[:, :, None] * EGl[:, None],
                          axis=0).reshape(dD * chunk_e, nx, nyr)
    eg_l = _corr_windows(prods_eg_l, nx, ny, hx2, hy2)
    n2w = (2 * hx2 + 1) * (2 * hy2 + 1)
    EGwin = jnp.moveaxis(
        lax.all_gather(eg_l.reshape(dD, chunk_e, n2w), model_axis,
                       axis=0), 0, 1).reshape(dD, nm * chunk_e, n2w
                                              )[:, :dD]
    # 4. XX products sharded over the D² plane pairs (rows selected
    # by one-hot matmuls over the tiny D axis — no gathers)
    chunk_dd = -(-dd // nm)
    flat = midx * chunk_dd + jnp.arange(chunk_dd)
    valid = (flat < dd).astype(jnp.float32)
    flat_c = jnp.minimum(flat, dd - 1)
    oh1 = (flat_c[:, None] // dD == jnp.arange(dD)[None, :]
           ).astype(jnp.float32)
    oh2 = (flat_c[:, None] % dD == jnp.arange(dD)[None, :]
           ).astype(jnp.float32)
    A = _ein("cd,bdxy->bcxy", oh1, Xc)
    Bv = _ein("cd,bdxy->bcxy", oh2, X)
    prods_xx_l = (jnp.mean(A * Bv, axis=0)
                  * valid[:, None, None])
    xx_l = _corr_windows(prods_xx_l, nx, ny, hx4, hy4)
    XX = gather(xx_l, dd).reshape(dD, dD, -1)
    # 5. scalars: shard-local partials psum'd over the model axis
    SEG = lax.psum(jnp.mean(jnp.sum(
        (EGl.real ** 2 + EGl.imag ** 2) * wv,
        axis=(-2, -1, -3))), model_axis)
    X0 = jnp.mean(X[:, :, 0, 0].real, axis=0)
    E_cont0 = gather(jnp.mean(EGl[:, :, 0, 0].real, axis=0), dD)
    return XX, EGwin, SEG, X0, E_cont0


def corr_precompute_fused(x, c0, f0, b0, p0, *, scale_by_dm=True,
                          axis_name=None, model_axis=None,
                          precompute="spectral"):
    """Precompute for the case ``expout = x`` AND ``out0 = the model's own
    two-stage forward of x`` (every steady-state streaming call site).

    When the anchor output is *exactly* the model forward, the anchor
    mismatch ``G₀ = s1·K̂₀X − O₀`` collapses to the DC-only bias injection
    (conv_k adds biases at the zero bin only, fft_backproplib.cu:183-184),
    so relative to :func:`corr_precompute` this drops per burst:

      - the separate ``rfft2(out0)`` (out0 is never materialized at all —
        neither in pixel nor ω space),
      - the XG0 plane products and their window transforms (9 of 27
        planes at D=3), and the E0/G0 split (E0 = continuum + DC scalars),

    while producing the **same T dict** for :func:`corr_iterate`, with the
    same anchoring precision: the continuum error ``s1·K̂₀X − X`` is still
    accumulated bin-wise, and the bias DC terms are exact scalars.
    Equality with the unfused path (out0 = ``_true_forward``) is tested to
    fp32 tolerance in tests/test_fft_corr.py.

    ``model_axis`` (tensor parallelism) shards the ENTIRE resolution-
    scaled pipeline, not just the window transforms: signal FFTs are
    sharded over the B·D pixel planes, the composed-kernel restricted
    DFTs and the continuum-error contraction over output channels, and
    the correlation products + lag windows over plane pairs.  The only
    resolution-sized collective is one all_gather of the X half-spectra
    (B·D·nx·nyr complex); everything gathered afterwards is
    window/scalar-sized.  Per-device FLOPs of the precompute scale as
    1/n_model (tests/test_tp_proof.py counts this from the compiled HLO).
    """
    nx, ny = x.shape[-2], x.shape[-1]
    B = x.shape[0]
    dD = x.shape[-3]
    dM = c0.shape[0]
    nk, nl = c0.shape[-2], c0.shape[-1]
    maps = _lag_maps(nk, nl)
    P = nk * nl
    hx2, hy2 = maps["l2ext"]
    hx4, hy4 = maps["v4ext"]
    s1 = (1.0 / (dM * dD)) if scale_by_dm else 1.0
    s2 = (1.0 / dD) if scale_by_dm else 1.0
    norm = float(nx * ny)
    nyr = ny // 2 + 1
    dd = dD * dD

    K2 = _ein("emq,mdr->edqr", f0.reshape(dD, dM, P),
              c0.reshape(dM, dD, P)).reshape(dd, P * P)
    K0taps = (_mm(K2, jnp.asarray(maps["g_scatter_pair"]))
              ).reshape(dD, dD, 2 * hx2 + 1, 2 * hy2 + 1)
    # DC bias offset of the true forward vs the continuum: dE0[e] =
    # norm·(s2·Σ_m f̂(0)·b + p)  (the only place out0 differed)
    fs0 = jnp.sum(f0.reshape(dD, dM, P), axis=-1)       # [D, M]
    dE0 = norm * (s2 * _mm(fs0, b0) + p0)               # [D]
    wv = jnp.asarray(_herm_w(nx, ny))

    if precompute not in ("spectral", "pixel"):
        raise ValueError(f"precompute={precompute!r}: the routes are "
                         "'spectral' and 'pixel'")
    if precompute == "pixel" and model_axis is not None:
        raise ValueError(
            "precompute='pixel' has no model-sharded variant — use the "
            "'spectral' route under tensor parallelism")
    if precompute == "pixel":
        # FFT-free: every precompute quantity computed directly in pixel
        # space (ops/pixel_corr.py — same anchoring-precision contract,
        # equality-tested vs this spectral branch)
        from ..ops.pixel_corr import pixel_anchor_windows
        XXw, EGw, SEG, E_cont0, X0 = pixel_anchor_windows(
            x, K0taps, hx2, hy2, s1)
        XX = XXw.reshape(dD, dD, -1)
        EGwin = EGw.reshape(dD, dD, -1)
    elif model_axis is None:
        if B * dD * nx * ny > _XLA_FFT_SERIALIZE_PIXELS:
            # serialize the signal transform one plane at a time (see
            # _XLA_FFT_SERIALIZE_PIXELS; equality pinned by
            # tests/test_fft_corr.py::test_serialized_fft_equality)
            planes = x.reshape(B * dD, nx, ny)
            X = lax.map(spectral.rfft2, planes)
            X = X.reshape(B, dD, nx, ny // 2 + 1)
        else:
            X = spectral.rfft2(x)                      # [B, D, nx, nyr]
        # full f32: a rounded anchor spectrum is a phantom error the
        # burst chases (it is never measured back)
        K0f = dft.kernel_spectrum(K0taps, nx, ny)
        # continuum error (Y = X): bin-wise small once trained —
        # anchoring precision identical to the E0/G0 split.  Full
        # precision is load-bearing (a rounded anchor is a phantom
        # the burst chases, unlike the unfused path whose forward
        # rounding lands in the *measured* G₀), so the d-contraction
        # runs as an elementwise broadcast-multiply-reduce: D=3 is a
        # tiny contraction, and elementwise f32 is exact without any
        # matmul precision mode
        EG = jnp.sum(K0f[None] * X[:, None], axis=2) * s1 - X
        Xc = jnp.conj(X)
        prods_xx = jnp.mean(Xc[:, :, None] * X[:, None],
                            axis=0).reshape(-1, nx, nyr)
        prods_eg = jnp.mean(Xc[:, :, None] * EG[:, None],
                            axis=0).reshape(-1, nx, nyr)
        XX = _corr_windows(prods_xx, nx, ny, hx4, hy4
                           ).reshape(dD, dD, -1)
        EGwin = _corr_windows(prods_eg, nx, ny, hx2, hy2
                              ).reshape(dD, dD, -1)
        SEG = jnp.mean(jnp.sum((EG.real ** 2 + EG.imag ** 2) * wv,
                               axis=(-2, -1, -3)))  # Σw|E₀+G₀|²
        E_cont0 = jnp.mean(EG[:, :, 0, 0].real, axis=0)  # [D]
        X0 = jnp.mean(X[:, :, 0, 0].real, axis=0)       # [D]
    else:
        nm = lax.axis_size(model_axis)
        midx = lax.axis_index(model_axis)

        def shard(planes):
            """Pad a plane stack to nm chunks and take this shard's."""
            n = planes.shape[0]
            chunk = -(-n // nm)
            pp = jnp.pad(planes, ((0, chunk * nm - n),)
                         + ((0, 0),) * (planes.ndim - 1))
            return lax.dynamic_slice_in_dim(pp, midx * chunk, chunk), chunk

        def gather(local, n):
            return lax.all_gather(local, model_axis, axis=0).reshape(
                (-1,) + local.shape[1:])[:n]

        # 1. signal FFTs sharded over the B·D pixel planes; ONE
        # resolution-sized all_gather of the half-spectra
        pl, _ = shard(x.reshape(B * dD, nx, ny))
        X = gather(spectral.rfft2(pl), B * dD).reshape(B, dD, nx, nyr)

        XX, EGwin, SEG, X0, E_cont0 = _tp_xla_windows(
            X, K0taps, nx, ny, nyr, B, dD, dd, hx2, hy2, hx4, hy4,
            s1, wv, nm, midx, shard, gather, model_axis)

    # reconstruct the E₀/G₀ split exactly: G₀ = −dE0 at DC only, so its
    # lag windows are the constant −X0[d]·dE0[e] (w(DC)=1) and its
    # energies are pure scalar corrections
    dc_lag = X0[:, None, None] * dE0[None, :, None]     # [d, e, 1]
    XG0 = jnp.broadcast_to(-dc_lag, EGwin.shape)
    XE0 = EGwin + dc_lag
    GG0 = jnp.sum(dE0 * dE0)
    EG0 = -jnp.sum((E_cont0 + dE0) * dE0)
    E0E0 = SEG + jnp.sum(2.0 * E_cont0 * dE0 + dE0 * dE0)
    E00 = E_cont0 + dE0

    out = dict(XX=XX, XE0=XE0, XG0=XG0, E0E0=E0E0, GG0=GG0, EG0=EG0,
               X0=X0, E00=E00, G00=-dE0)
    if axis_name is not None:
        out = jax.tree.map(lambda t: lax.pmean(t, axis_name), out)
    return out


def corr_iterate(T, c, f, b, p, mom=None, *, nx, ny,
                 lr=0.2, alpha=0.9, iters=100, maxdiff=False,
                 w0=1.0, w1=10.0, scale_by_dm=True,
                 vary_axes=()) -> FFTBurstResult:
    """Run the burst's inner loop on precomputed correlation tensors.

    ``c/f/b/p`` must be the same initial weights given to
    :func:`corr_precompute` (they are the anchor).  ``vary_axes``: inside
    shard_map with a model-sharded precompute, the tensor inputs carry
    varying-axis marks from the all_gather; the replicated carry must be
    pvaried over the same axes to keep fori_loop carry types consistent.
    """
    if vary_axes:
        pv = lambda t: lax.pcast(t, tuple(vary_axes), to="varying")
        c, f, b, p = (pv(t) for t in (c, f, b, p))
        if mom is not None:
            mom = tuple(pv(t) for t in mom)
    dM, dD, nk, nl = c.shape
    P = nk * nl
    dd = dD * dD
    norm = float(nx * ny)
    n_norm = norm * 2.0 * dM * dD * nx * ny
    mse_norm = 1.0 / (dD * nx * ny) / (2 * dM * nx * ny)
    del_eff = 0.1 * lr
    s1 = (1.0 / (dM * dD)) if scale_by_dm else 1.0
    s2 = (1.0 / dD) if scale_by_dm else 1.0
    maps = _lag_maps(nk, nl)
    n2, n4 = maps["n2"], maps["n4"]
    XXf = T["XX"].reshape(dD, dD, n4)
    XE0f = T["XE0"].reshape(dD, dD, n2)          # [d (X̄), d' (E₀), L2]
    XG0f = T["XG0"].reshape(dD, dD, n2)
    E0E0, GG0, EG0 = T["E0E0"], T["GG0"], T["EG0"]
    X0, E00, G00 = T["X0"], T["E00"], T["G00"]
    g_scatter = jnp.asarray(maps["g_scatter_pair"])       # [P², n2]
    g_pair = jnp.asarray(maps["g_pair"])                  # [n2, P²]
    XE0pair = _mm(XE0f.reshape(dd, n2), g_pair).reshape(dD, dD, P, P)

    if mom is None:
        mom = (jnp.zeros_like(c), jnp.zeros_like(f),
               jnp.zeros_like(b), jnp.zeros_like(p))
    kshape_c, kshape_f = c.shape, f.shape
    c = c.reshape(dM, dD, P)
    f = f.reshape(dD, dM, P)
    mom = (mom[0].reshape(dM, dD, P), mom[1].reshape(dD, dM, P),
           mom[2], mom[3])

    # ---- bias-as-tap extended channels -----------------------------
    # The DC bias injections (conv_k adds b·Nx·Ny at the zero bin only,
    # cu:183-184) are algebraically a convolution against a CONSTANT input
    # channel (spectrum norm·δ_DC).  Extending the tape with that channel
    # — c̃ gains a bias column (scale s2/s1 = dM so the composed DC comes
    # out right) and a frozen constant-maker row (1/s1 at the center tap),
    # f̃ gains the decoder-bias column — folds the entire per-iteration
    # DC-correction block into the SAME einsums that produce the tap
    # gradients: the lag tensors extend with constant rows/columns (the DC
    # exponential is lag-independent), and gradients/updates for b, p fall
    # out of the extended entries.  Two embeddings of c̃ are needed
    # because the reference's gradient_k_io drops the hidden /dM (the
    # "no-/M H quirk", cu:438-455): the FORWARD embedding (bias column
    # ab·b, maker row 1/s1) makes the composed K̃ produce the exact bias
    # DC, while the GRADIENT einsum for gf must weight the bias channel by
    # plain b (and the maker row by 1) — a static per-entry rescale of the
    # carry, GM = SC⁻¹ on the bias entries.  With that, the raw extended
    # gradients equal the reference gradients on EVERY parameter slot, so
    # the update rule stays exactly the reference's per-parameter
    # normalized step (backprop_d, cu:605-652): dw =
    # SC·[(1−α)·lr·g/max(|g|, 10)] + α·mom, where SC is the
    # entry/parameter scale (ab on the c̃ bias column, 1 on live taps and
    # the f̃ bias column, 0 on frozen entries) — clipping sees the
    # reference-scale gradient, the entry moves at entry scale, and frozen
    # entries never move.
    dDe, dMe = dD + 1, dM + 1
    p0 = P // 2                   # the (0,0) tap carries the biases
    ab = s2 / s1                  # bias-column scale: c̃[m,D,p0] = ab·b
    dde = dD * dDe

    def embed_c(cc, bb, col_scale, mk_row=False):
        col = jnp.zeros((dM, 1, P)).at[:, 0, p0].set(col_scale * bb)
        ext = jnp.concatenate([cc, col], axis=1)          # [dM, dDe, P]
        row = jnp.zeros((1, dDe, P))
        if mk_row:
            row = row.at[0, dD, p0].set(1.0 / s1)
        return jnp.concatenate([ext, row], axis=0)        # [dMe, dDe, P]

    def embed_f(ff, pp):
        col = jnp.zeros((dD, 1, P)).at[:, 0, p0].set(pp)
        return jnp.concatenate([ff, col], axis=1)         # [dD, dMe, P]

    SCc = np.zeros((dMe, dDe, P), np.float32)
    SCc[:dM, :dD, :] = 1.0
    SCc[:dM, dD, p0] = ab
    SCf = np.zeros((dD, dMe, P), np.float32)
    SCf[:, :dM, :] = 1.0
    SCf[:, dM, p0] = 1.0
    SCc, SCf = jnp.asarray(SCc), jnp.asarray(SCf)
    # gradient-side rescale of the carried c̃ (see the header comment):
    # bias column back to plain b, maker row to 1 — all other entries 1
    GMc = np.ones((dMe, dDe, P), np.float32)
    GMc[:dM, dD, p0] = 1.0 / ab
    GMc[dM, dD, p0] = s1
    GMc = jnp.asarray(GMc)

    # extended static tensors: the constant channel's correlations are
    # lag-independent DC products (w(DC)=1, e^{i·0·v}=1)
    dE0 = norm * (s2 * _mm(jnp.sum(f, axis=-1), b) + p)     # initial biases
    X0e = jnp.concatenate([X0, jnp.full((1,), norm)])     # [dDe]
    XXe = jnp.concatenate([
        jnp.concatenate(
            [XXf, jnp.broadcast_to((norm * X0)[:, None, None],
                                   (dD, 1, n4))], axis=1),
        jnp.broadcast_to((norm * X0e)[None, :, None], (1, dDe, n4)),
    ], axis=0)                                            # [dDe, dDe, n4]
    if maps["g_xxd"] is not None:
        XXd = (_mm(XXe.reshape(dDe * dDe, n4), jnp.asarray(maps["g_xxd"]))
               ).reshape(dDe, dDe, n2, n2)
    else:
        # large kernels: one gather per burst (loop-invariant) instead of
        # a k⁶-sized one-hot constant — see _lag_maps
        XXd = jnp.take(XXe.reshape(dDe * dDe, n4),
                       jnp.asarray(maps["xxd_idx"]), axis=1
                       ).reshape(dDe, dDe, n2, n2)
    # windows of the extended anchor error Ẽ₀ = s1·K̃̂₀X̃ − Y (the biased
    # anchor forward's error; = E₀ exactly when out0 is the true forward)
    E0full = jnp.concatenate([
        XE0f + XG0f + X0[:, None, None] * dE0[None, :, None],
        jnp.broadcast_to((norm * (E00 + G00 + dE0))[None, :, None],
                         (1, dD, n2)),
    ], axis=0)                                            # [d̃, e, L2]
    E0t = jnp.transpose(E0full, (1, 0, 2))                # [e, d̃, L2]
    E0E0ext = (E0E0 + 2.0 * EG0 + GG0
               + jnp.sum((2.0 * (E00 + G00) + dE0) * dE0))

    def composed_kernel(cc, ff):
        """K̃[e,d̃][L2] = Σ_m̃ Σ_{q+r=u} f̃·c̃ (f̃ ∗ c̃); the (q,r)→u
        scatter-sum is a one-hot matmul."""
        K2 = _ein("emq,mdr->edqr", ff, cc).reshape(dde, P * P)
        return _mm(K2, g_scatter).reshape(dD, dDe, n2)

    def inertia_ext(wgt, g, mo, SC):
        # g is reference-scale on every parameter slot; SC converts the
        # reference update to entry scale and freezes the rest
        return burst_inertia(wgt, g, mo, del_eff, alpha, scale=SC)

    def body(i, carry):
        cc, ff, Dc, Df, rec = carry
        dK = composed_kernel(cc, ff) - K0e
        # R(ΔK̃)[e,d̃][L2] = Σ_{c̃,u} ΔK̃[e,c̃,u]·XX̃[d̃,c̃][L2−u]
        R = _ein("ecu,dcLu->edL", dK, XXd)           # [e,d̃,L2²]
        Tt = s1 * R + E0t                                  # [e,d̃,L2²]
        Tg = _mm(Tt.reshape(dde, n2), g_pair).reshape(dD, dDe, P, P)
        gc = _ein("emq,edpq->mdp", ff, Tg)           # [M̃,D̃,P]
        # gf contracts the SAME tensor in [d̃, e] orientation, with the
        # gradient-side embedding of c̃ (bias channel at plain b — the
        # reference's no-/M hidden; maker row at 1 so the p slot comes
        # out at reference scale)
        Tg2 = jnp.transpose(Tg, (1, 0, 2, 3))
        gf = _ein("mdr,deqr->emq", GMc * cc, Tg2)    # [D,M̃,P]
        # Record ΔK̃ instead of reducing it to the Parseval MSE here: the
        # ⟨ΔK,·⟩ contractions are full-array→scalar reductions, the most
        # expensive ops of the body — recording the tiny tensor and
        # batching the contractions over all iterations AFTER the loop
        # computes the identical trajectory (cu:1463-1464) at O(1)
        # amortized cost.
        rec = rec.at[i].set(dK.reshape(dde * n2))

        gc = gc / n_norm
        gf = gf / n_norm
        if maxdiff:
            cd, fd, bd, pd = diversity_gradients(
                cc[:dM, :dD].reshape(kshape_c),
                ff[:, :dM].reshape(kshape_f),
                cc[:dM, dD, p0] / ab, ff[:, dM, p0])
            # gradients are reference-scale on every parameter slot, so
            # the diversity grads embed at scale 1 (the slot IS the
            # parameter's gradient; SC handles entry scale at update)
            gc = w0 * gc - w1 * embed_c(cd.reshape(dM, dD, P), bd, 1.0)
            gf = w0 * gf - w1 * embed_f(fd.reshape(dD, dM, P), pd)

        # the burst applies exactly `iters` updates; the gradient of the
        # final forward is discarded (matching the ω-space body, train/fft)
        keep = i < iters
        sel = lambda new, old: jnp.where(keep, new, old)
        cc_n, Dc_n = inertia_ext(cc, gc, Dc, SCc)
        ff_n, Df_n = inertia_ext(ff, gf, Df, SCf)
        return (sel(cc_n, cc), sel(ff_n, ff),
                sel(Dc_n, Dc), sel(Df_n, Df), rec)

    # ---- iteration 0: gradients from the caller-provided O₀ ----
    # (the burst trains against the frozen first output, cu:1430-1441;
    # at i=0 there is no recomputed forward, so E = O₀−Y exactly — kept
    # outside the loop because it uses the PROVIDED output's error, not
    # the anchor forward's)
    rec = jnp.zeros((iters + 1, dde * n2), jnp.float32)
    if vary_axes:
        rec = lax.pcast(rec, tuple(vary_axes), to="varying")
    gc0 = _ein("emq,edpq->mdp",
                     f, jnp.transpose(XE0pair, (1, 0, 2, 3)))
    gf0 = _ein("mdr,deqr->emq", c, XE0pair)
    gf0 = gf0 + (E00[:, None] * (norm * b)[None])[:, :, None]
    db0 = norm * _mm(jnp.sum(f, axis=-1).T, E00)
    dp0 = norm * E00
    gc0, gf0, db0, dp0 = jax.tree.map(lambda t: t / n_norm,
                                      (gc0, gf0, db0, dp0))
    if maxdiff:
        cd, fd, bd, pd = diversity_gradients(
            c.reshape(kshape_c), f.reshape(kshape_f), b, p)
        gc0 = w0 * gc0 - w1 * cd.reshape(dM, dD, P)
        gf0 = w0 * gf0 - w1 * fd.reshape(dD, dM, P)
        db0 = w0 * db0 - w1 * bd
        dp0 = w0 * dp0 - w1 * pd

    def inertia0(wgt, g, mo):
        return burst_inertia(wgt, g, mo, del_eff, alpha)

    c1_, Dc = inertia0(c, gc0, mom[0])
    f1_, Df = inertia0(f, gf0, mom[1])
    b1_, Db = inertia0(b, db0, mom[2])
    p1_, Dp = inertia0(p, dp0, mom[3])

    # the anchor K̃₀ is the extended composition of the INITIAL weights
    # (biases included — the anchor forward is the biased forward)
    ce0 = embed_c(c, b, ab, mk_row=True)
    fe0 = embed_f(f, p)
    K0e = composed_kernel(ce0, fe0)

    # iterations 1..iters: body(i) records ΔK̃_i (the post-update-i
    # forward's state) and produces the update for iteration i+1
    # (discarded at i == iters)
    init = (embed_c(c1_, b1_, ab, mk_row=True), embed_f(f1_, p1_),
            embed_c(Dc, Db, ab), embed_f(Df, Dp), rec)
    out = lax.fori_loop(1, iters + 1, body, init)
    cce, ffe, Dce, Dfe, rec = out
    cc, bb = cce[:dM, :dD], cce[:dM, dD, p0] / ab
    ff, pp = ffe[:, :dM], ffe[:, dM, p0]
    Dc, Db = Dce[:dM, :dD], Dce[:dM, dD, p0] / ab
    Df, Dp = Dfe[:, :dM], Dfe[:, dM, p0]

    # ---- Parseval MSE trajectory from the recorded state (batched over
    # all iterations; exactly the in-loop formula, cu:1463-1464) ----
    dKs = rec[1:].reshape(iters, dD, dDe, n2)
    Rs = _ein("iecu,dcLu->iedL", dKs, XXd)
    mse_raw = (E0E0ext
               + 2.0 * s1 * _ein("iecu,ceu->i", dKs, E0full)
               + s1 * s1 * _ein("iedu,iedu->i", dKs, Rs))
    mses = jnp.concatenate([(E0E0 * mse_norm)[None],
                            mse_raw * mse_norm])
    return FFTBurstResult(
        c=cc.reshape(kshape_c), f=ff.reshape(kshape_f), b=bb, p=pp,
        mom=(Dc.reshape(kshape_c), Df.reshape(kshape_f), Db, Dp),
        mses=mses)


def _true_forward(x, c, f, b, p, scale_by_dm):
    """The biased two-stage forward of the burst's internal model, in
    pixel space — the reference's output recompute (cu:1460-1461) followed
    by its inverse transform.  Used as the next segment's O₀ when
    re-anchoring."""
    nx, ny = x.shape[-2], x.shape[-1]
    X = spectral.rfft2(x)
    Cf = dft.kernel_spectrum(c, nx, ny)
    Ff = dft.kernel_spectrum(f, nx, ny)
    H = spectral.spectral_conv(X, Cf, b, nx, ny, scale_by_dm=scale_by_dm)
    O = spectral.spectral_conv(H, Ff, p, nx, ny, scale_by_dm=scale_by_dm)
    return spectral.irfft2(O, (nx, ny))


def burst_corr(x, expout, out0, c, f, b, p, mom=None, *,
               lr=0.2, alpha=0.9, iters=100, maxdiff=False,
               w0=1.0, w1=10.0, scale_by_dm=True,
               axis_name=None, model_axis=None,
               reanchor_every=None,
               precompute="spectral") -> FFTBurstResult:
    """Correlation-space burst; semantics of ``fft_burst``/``fft_burst_dp``.

    ``x/expout/out0``: ``[D, h, w]`` or batched ``[B, D, h, w]`` (gradients
    batch-averaged).  ``expout=None`` means "train against the input
    itself" (every reference/engine/CLI call site) — binding the SAME
    traced array lets XLA CSE the Y-side FFT and correlation products out
    of the precompute, unlike passing a duplicate argument.  Inside
    shard_map, ``axis_name`` pmeans the correlation tensors over the data
    axis and ``model_axis`` shards the precompute's transform planes; the
    iterations then run replicated and collective-free.

    ``reanchor_every``: re-anchor the decomposition every R iterations by
    recomputing the true forward and fresh XE0/XG0 tensors — resets the
    fp32 cancellation floor to the *current* error scale, so arbitrarily
    long/converged bursts stay accurate (each segment runs the identical
    reference recursion, so the segmented burst equals the unsegmented
    one in exact arithmetic).  Costs one precompute per segment.

    ``out0=None``: fused anchoring — the anchor output is the model's own
    biased two-stage forward of ``x``, computed *inside* the precompute as
    exact DC scalars on top of the continuum (:func:`corr_precompute_fused`
    — no out0 FFT, no XG0 plane transforms).  Requires ``expout`` None/x
    (the steady-state streaming contract); reanchor segments then
    re-anchor without any pixel-space forward round-trip.  ``precompute``
    picks the fused precompute's route: ``"spectral"`` (FFTs) or
    ``"pixel"`` (FFT-free, ops/pixel_corr.py).
    """
    fused = out0 is None
    if fused and not (expout is None or expout is x):
        raise ValueError("out0=None (fused anchor forward) trains against "
                         "the input; pass expout=None")
    if precompute != "spectral" and not fused:
        raise ValueError("precompute='pixel' only exists on the "
                         "fused-anchor precompute (out0=None) — drop it or "
                         "the explicit out0")
    if expout is None:
        expout = x
    if x.ndim == 3:
        x, expout = x[None], expout[None]
        if not fused:
            out0 = out0[None]
    nx, ny = x.shape[-2], x.shape[-1]
    vary = (model_axis,) if model_axis else ()

    def anchor(out_cur, c, f, b, p):
        if out_cur is None:
            return corr_precompute_fused(x, c, f, b, p,
                                         scale_by_dm=scale_by_dm,
                                         axis_name=axis_name,
                                         model_axis=model_axis,
                                         precompute=precompute)
        return corr_precompute(x, expout, out_cur, c, f,
                               scale_by_dm=scale_by_dm,
                               axis_name=axis_name, model_axis=model_axis)

    if iters == 0:
        # zero updates: report mses[0] only (the ω-space paths' semantics)
        T0 = anchor(out0, c, f, b, p)
        mse_norm = 1.0 / (c.shape[1] * nx * ny) / (2 * c.shape[0] * nx * ny)
        if mom is None:
            mom = (jnp.zeros_like(c), jnp.zeros_like(f),
                   jnp.zeros_like(b), jnp.zeros_like(p))
        return FFTBurstResult(c=c, f=f, b=b, p=p, mom=mom,
                              mses=(T0["E0E0"] * mse_norm)[None])

    def segment(out_cur, c, f, b, p, mom, seg_iters):
        T = anchor(out_cur, c, f, b, p)
        return corr_iterate(T, c, f, b, p, mom, nx=nx, ny=ny, lr=lr,
                            alpha=alpha, iters=seg_iters, maxdiff=maxdiff,
                            w0=w0, w1=w1, scale_by_dm=scale_by_dm,
                            vary_axes=vary)

    if not reanchor_every or reanchor_every >= iters:
        return segment(out0, c, f, b, p, mom, iters)

    out_cur = out0
    mses_parts = []
    left = iters
    while left > 0:
        seg = min(reanchor_every, left)
        r = segment(out_cur, c, f, b, p, mom, seg)
        c, f, b, p, mom = r.c, r.f, r.b, r.p, r.mom
        # the next segment's mses[0] re-measures the boundary forward —
        # drop the duplicate
        mses_parts.append(r.mses if not mses_parts else r.mses[1:])
        left -= seg
        if left > 0:
            # fused mode re-anchors inside the next precompute; the
            # unfused contract recomputes the true forward explicitly
            out_cur = (None if fused else
                       _true_forward(x, c, f, b, p, scale_by_dm))
    return FFTBurstResult(c=c, f=f, b=b, p=p, mom=mom,
                          mses=jnp.concatenate(mses_parts))


fft_burst_corr = jax.jit(
    burst_corr,
    static_argnames=("iters", "maxdiff", "scale_by_dm", "axis_name",
                     "model_axis", "reanchor_every", "precompute"))


def auto_burst(x, expout, out0, c, f, b, p, mom=None, *, lr=0.2, alpha=0.9,
               iters=100, maxdiff=False, w0=1.0, w1=10.0, scale_by_dm=True):
    """One burst through the body :func:`spectralae.core.backend.burst_body`
    picks, this module's correlation-space body (the ω-space jnp body,
    :func:`spectralae.train.fft.fft_burst`, stays its reference)."""
    from ..core.backend import burst_body
    burst_body()        # "corr" on every known backend; raises on others
    # beyond the reference's 100 inner iterations, re-anchor each 100 so
    # the correlation algebra's precision floor follows the error
    return fft_burst_corr(
        x, expout, out0, c, f, b, p, mom, lr=lr, alpha=alpha,
        iters=iters, maxdiff=maxdiff, w0=w0, w1=w1,
        scale_by_dm=scale_by_dm,
        reanchor_every=100 if iters > 100 else None)
