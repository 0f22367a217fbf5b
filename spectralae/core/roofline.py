"""Roofline accounting: FLOPs / device-memory bytes per compiled program vs
the device's published peaks.

The reference ships no utilization numbers at all (SURVEY.md §6 — its only
perf claim is the qualitative "much faster").  This module fills the empty
"util" cell: every bench row reports its work and traffic next to its
time, so "bandwidth-bound" is a checked claim (flops/s and bytes/s vs the
device's peaks), not an assertion from timings.

Work comes from XLA's own cost model (:func:`compiled_cost`): ``flops`` and
``bytes accessed`` from ``Compiled.cost_analysis()`` on the optimized
(post-fusion) HLO, plus analytic supplements where XLA cannot see the work
(:func:`corr_iter_flops` for a ``fori_loop`` body, costed once by XLA).
XLA's "bytes accessed" counts every fusion's operand+result bytes, which
overcounts true device-memory traffic when consecutive fusions hand buffers
over; the analytic ``*_bytes`` bounds below can only overcount less.

Peaks (:data:`PEAKS`) are keyed by ``device_kind`` with their source.  The
program computes in f32 at full precision (no TF32), so ``pct_peak_flops``
is taken against the f32 rate; the bf16 and TF32 rates are kept beside it.
A device that is not in the table is an error, not a default.
"""

from __future__ import annotations

from typing import NamedTuple


class Peaks(NamedTuple):
    name: str
    bf16: float     # dense tensor-core peak, FLOP/s
    tf32: float     # dense tensor-core peak, FLOP/s
    f32: float      # non-tensor-core f32 peak, FLOP/s
    hbm: float      # device-memory bandwidth, bytes/s
    source: str


_H100_SXM = Peaks(name="NVIDIA H100 SXM", bf16=989e12, tf32=495e12,
                  f32=67e12, hbm=3.35e12,
                  source="NVIDIA H100 Tensor Core GPU data sheet (SXM, "
                         "dense, 700 W)")

# device_kind (as jax.Device.device_kind reports it) -> published peaks
PEAKS = {
    "NVIDIA H100 80GB HBM3": _H100_SXM,
}


def device_peaks(device=None) -> Peaks:
    """Published peaks of ``device`` (default: ``jax.devices()[0]``).

    Raises ``KeyError`` naming the device kind when it is not in
    :data:`PEAKS`."""
    if device is None:
        import jax
        device = jax.devices()[0]
    kind = device.device_kind
    try:
        return PEAKS[kind]
    except KeyError:
        raise KeyError(f"no published peaks for device_kind {kind!r}; "
                       f"known: {sorted(PEAKS)}") from None


def compiled_cost(jfn, *args, **kwargs) -> tuple[float | None, float | None]:
    """(flops, bytes_accessed) of ``jfn(*args, **kwargs)`` from XLA's cost
    analysis of the compiled program.

    ``jfn`` must be a ``jax.jit`` wrapper; lowering re-traces but the
    backend compile is a persistent-cache hit when the same program already
    ran (bench.py always times first, then costs).  Returns (None, None)
    on any failure — a missing cost must never kill a bench run.

    Known limitation: XLA costs a ``while``/``scan`` body ONCE, not ×trip
    count.  Callers scale scan-over-frames rows by the trip count
    (slight overcount of loop-invariant traffic — conservative for
    pct_peak) and add :func:`corr_iter_flops` for the burst's inner
    ``fori_loop`` (whose arithmetic XLA never sees multiplied).
    """
    try:
        ca = jfn.lower(*args, **kwargs).compile().cost_analysis()
        if isinstance(ca, (list, tuple)):
            ca = ca[0]
        return float(ca.get("flops", 0.0)), float(ca.get("bytes accessed", 0.0))
    except Exception:
        return None, None


def corr_iter_flops(D: int, M: int, nk: int, nl: int, iters: int) -> float:
    """Arithmetic of the correlation burst's inner ``fori_loop`` body ×
    iterations (train/fft_corr.corr_iterate) — invisible to XLA's cost
    model (while bodies are costed once).

    Per iteration, on the bias-extended tape (dDe=D+1, dMe=M+1, P=nk·nl,
    n2=(4⌊nk/2⌋+1)(4⌊nl/2⌋+1) composed-support lags):

    - composed kernel: einsum [dD,dMe,P]×[dMe,dDe,P] + scatter
      [dde,P²]@[P²,n2]
    - R(ΔK): einsum over (e,c,u,d,L) → 2·dD·dDe²·n2²
    - Tg gather: [dde,n2]@[n2,P²]
    - gc/gf einsums: ≈ 2 × the composed-kernel einsum
    """
    dDe, dMe = D + 1, M + 1
    dde = D * dDe
    P = nk * nl
    n2 = (4 * (nk // 2) + 1) * (4 * (nl // 2) + 1)
    k2 = 2 * D * dMe * dDe * P * P
    per_iter = (k2                      # composed kernel einsum
                + 2 * dde * P * P * n2  # (q,r)→u scatter matmul
                + 2 * D * dDe * dDe * n2 * n2   # R(ΔK)
                + 2 * dde * n2 * P * P  # Tg gather matmul
                + 2 * k2)               # gc + gf
    return float(per_iter * iters)


def spectral_conv_bytes(B: int, D: int, M: int, nx: int, ny: int) -> float:
    """Analytic HBM byte *bound* for one rfft2 → pointwise conv → irfft2
    round trip (the ``conv_spectral_*`` bench rows): every resolution-
    sized array counted once written + once read where it crosses a
    fusion boundary (input read, X/kernel/Y spectra w+r as split-complex
    f32, output write).  True traffic can only be LOWER (XLA may fuse
    some handovers), so pct_peak_bw against this bound is an upper
    bound on utilization — unlike XLA's bytes-accessed, it can never
    exceed physics."""
    nyr = ny // 2 + 1
    cplx = 8.0
    return float(B * D * nx * ny * 4            # x read
                 + 2 * B * D * nx * nyr * cplx  # X write+read
                 + 2 * M * D * nx * nyr * cplx  # kernel spectra w+r
                 + 2 * B * M * nx * nyr * cplx  # Y write+read
                 + B * M * nx * ny * 4)         # out write


def fft_step_bytes(B: int, D: int, M: int, nx: int, ny: int,
                   pairs: int) -> float:
    """Analytic HBM byte bound for one fused fwd+bwd ``train_step``
    (``modern_fft_step_*`` rows): forward traffic = the input/output
    planes plus each stage's activation spectra (write+read, split-
    complex) down the pooled pyramid and back up; backward ≈ 2× forward
    (re-read activations + write cotangents).  A bound, not an exact
    count — XLA's fusions can only move less."""
    nyr_of = lambda r: r // 2 + 1
    fwd = B * D * nx * ny * 4.0 + B * D * nx * ny * 4.0   # x read, recon w
    for s in range(pairs):
        r = nx >> (s + 1)                # resolution after encoder pool s
        din = D if s == 0 else M
        # encoder stage s: read in-spectra, write out-spectra (and the
        # mirrored decoder stage moves the same planes back up)
        stage = (B * din * r * nyr_of(r) * 8.0
                 + B * M * r * nyr_of(r) * 8.0)
        fwd += 2 * stage
    return float(3.0 * fwd)


def corr_burst_bytes(B: int, D: int, nx: int, ny: int) -> float:
    """Analytic device-memory byte bound for the correlation burst's
    precompute (the 100 iterations move only window-sized tensors):
    signal spectra write+read plus the [D², nx, nyr] XX and EG product
    planes (write + one read by the lag-window transforms)."""
    nyr = ny // 2 + 1
    x_read = B * D * nx * ny * 4.0
    spectra = 2 * B * D * nx * nyr * 8.0            # w+r, complex64
    planes = 2 * (D * D) * nx * nyr * 8.0 * 2       # XX + EG, w+r each
    return float(x_read + spectra + B * planes)


def utilization(flops: float | None, bytes_: float | None,
                seconds: float, peaks: Peaks) -> dict:
    """Per-row utilization dict for bench_details.json."""
    out = {}
    if flops is not None:
        out["gflop"] = round(flops / 1e9, 3)
        out["gflops_per_s"] = round(flops / seconds / 1e9, 1)
        out["pct_peak_flops_f32"] = round(
            100.0 * flops / seconds / peaks.f32, 2)
    if bytes_ is not None:
        out["gb"] = round(bytes_ / 1e9, 3)
        out["gb_per_s"] = round(bytes_ / seconds / 1e9, 1)
        out["pct_peak_bw"] = round(100.0 * bytes_ / seconds / peaks.hbm, 2)
    return out
