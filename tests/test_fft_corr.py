"""Correlation-space burst vs the ω-space bursts (CPU, 8 virtual devices).

The corr burst reorganizes the reference's frozen-input inner loop
(source/fft_backproplib.cu:1446-1464) into precomputed cross-correlation
tensors + per-iteration small tensor algebra; these tests pin its
semantics to the jnp ω-space burst across kernels shapes, aliasing grids,
batching, momentum chains, multiobjective, and the DP×TP shard_map path.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from spectralae.core.config import Config, LayerParams
from spectralae.core.types import initial_spec, init_params
from spectralae.dist import mesh as dist
from spectralae.model import autoencoder as model
from spectralae.train.fft import fft_burst, FFTBurstResult
from spectralae.train.fft_dp import fft_burst_dp, distributed_burst
from spectralae.train.fft_corr import fft_burst_corr, burst_corr


def setup(nx=16, d=2, m=4, lk=1, ll=None, seed=0, b=None, ny=None):
    ll = lk if ll is None else ll
    ny = nx if ny is None else ny
    cfg = Config(nx=nx, ny=ny, d=d,
                 layer=LayerParams(depth=m, lk=lk, ll=ll, scale=1, rmax=0.5))
    spec = initial_spec(cfg)
    params = init_params(jax.random.key(seed), spec, 0.5)
    shape = (d, nx, ny) if b is None else (b, d, nx, ny)
    x = jnp.asarray(np.random.default_rng(seed).normal(
        size=shape).astype(np.float32)) * 50
    out0 = model.forward_fft(params, x if b else x[None], spec.scales)
    out0 = out0 if b else out0[0]
    enc, dec = params.pair(0)
    return x, out0, enc, dec


def assert_matches(got, ref, rtol=1e-3, atol=1e-4):
    for name in ("mses", "c", "f", "b", "p"):
        np.testing.assert_allclose(np.asarray(getattr(got, name)),
                                   np.asarray(getattr(ref, name)),
                                   rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("nx,lk,ll,d,m", [
    (16, 1, 1, 2, 4),    # lag window (17²) wider than the grid: aliasing
    (24, 1, 2, 2, 3),    # non-square kernel 5×7
    (32, 2, 2, 3, 5),    # 7×7
    pytest.param(32, 5, 5, 2, 3, marks=pytest.mark.slow),
    # ^ 13×13: exercises the take-based XXd build (the one-hot map would
    #   be a 3.75 GB constant); ~60 s on this single-core rig
])
def test_corr_burst_matches_jnp(nx, lk, ll, d, m):
    x, out0, enc, dec = setup(nx=nx, d=d, m=m, lk=lk, ll=ll)
    ref = fft_burst(x, x, out0, enc.c, dec.c, enc.b, dec.b,
                    lr=0.2, iters=6, impl="dft")
    got = fft_burst_corr(x, x, out0, enc.c, dec.c, enc.b, dec.b,
                         lr=0.2, iters=6)
    assert_matches(got, ref)


def test_corr_burst_momentum_carry():
    x, out0, enc, dec = setup()
    r1 = fft_burst_corr(x, x, out0, enc.c, dec.c, enc.b, dec.b,
                        lr=0.2, iters=3)
    r2 = fft_burst_corr(x, x, out0, r1.c, r1.f, r1.b, r1.p, mom=r1.mom,
                        lr=0.2, iters=3)
    a1 = fft_burst(x, x, out0, enc.c, dec.c, enc.b, dec.b,
                   lr=0.2, iters=3, impl="dft")
    a2 = fft_burst(x, x, out0, a1.c, a1.f, a1.b, a1.p, mom=a1.mom,
                   lr=0.2, iters=3, impl="dft")
    assert_matches(r2, a2)


def test_corr_burst_maxdiff():
    x, out0, enc, dec = setup()
    got = fft_burst_corr(x, x, out0, enc.c, dec.c, enc.b, dec.b,
                         lr=0.2, iters=4, maxdiff=True)
    ref = fft_burst(x, x, out0, enc.c, dec.c, enc.b, dec.b,
                    lr=0.2, iters=4, impl="dft", maxdiff=True)
    assert_matches(got, ref)


def test_corr_burst_no_dm_scaling():
    x, out0, enc, dec = setup()
    got = fft_burst_corr(x, x, out0, enc.c, dec.c, enc.b, dec.b,
                         lr=0.2, iters=4, scale_by_dm=False)
    ref = fft_burst(x, x, out0, enc.c, dec.c, enc.b, dec.b,
                    lr=0.2, iters=4, impl="dft", scale_by_dm=False)
    assert_matches(got, ref)


def test_corr_burst_batched_matches_dp():
    xb, ob, enc, dec = setup(b=4, seed=3)
    got = fft_burst_corr(xb, xb, ob, enc.c, dec.c, enc.b, dec.b,
                         lr=0.2, iters=5)
    ref = fft_burst_dp(xb, xb, ob, enc.c, dec.c, enc.b, dec.b,
                       lr=0.2, iters=5, body="omega")
    assert_matches(got, ref)


def test_corr_burst_long_run_tracks_convergence():
    """100 iterations: the correlation algebra tracks the ω-space burst
    through a ~350× MSE reduction (fp32 cancellation floor is far below)."""
    x, out0, enc, dec = setup()
    got = fft_burst_corr(x, x, out0, enc.c, dec.c, enc.b, dec.b,
                         lr=0.2, iters=100)
    ref = fft_burst(x, x, out0, enc.c, dec.c, enc.b, dec.b,
                    lr=0.2, iters=100, impl="dft")
    m_got, m_ref = np.asarray(got.mses), np.asarray(ref.mses)
    assert m_got[-1] < m_got[0] * 0.01
    np.testing.assert_allclose(m_got, m_ref, rtol=5e-3, atol=1e-4)
    np.testing.assert_allclose(np.asarray(got.c), np.asarray(ref.c),
                               rtol=1e-3, atol=1e-4)


def test_corr_burst_dp_tp_shard_map():
    """DP×TP (data=4, model=2): tensors pmean over data, irfft2 planes
    sharded over model — numerically equal to the single-device burst
    (SURVEY.md §2.9 TP extension)."""
    assert len(jax.devices()) == 8
    m = dist.make_mesh(n_data=4, n_model=2)
    xs, out8, enc, dec = setup(b=8, seed=1)

    def local(xb, eb, ob, c, f, b, p):
        return burst_corr(xb, eb, ob, c, f, b, p, lr=0.2, iters=5,
                          axis_name="data", model_axis="model")

    bspec = P("data", None, None, None)
    rep = P()
    run = jax.jit(shard_map(
        local, mesh=m,
        in_specs=(bspec, bspec, bspec, rep, rep, rep, rep),
        out_specs=FFTBurstResult(c=rep, f=rep, b=rep, p=rep,
                                 mom=(rep, rep, rep, rep), mses=rep),
        check_vma=False))
    got = run(dist.shard_batch(np.asarray(xs), m),
              dist.shard_batch(np.asarray(xs), m),
              dist.shard_batch(np.asarray(out8), m),
              enc.c, dec.c, enc.b, dec.b)
    want = fft_burst_dp(xs, xs, out8, enc.c, dec.c, enc.b, dec.b,
                        lr=0.2, iters=5, body="omega")
    assert_matches(got, want)


def test_distributed_burst_default_is_corr_and_matches():
    """distributed_burst's default body (corr) on an 8-way data mesh."""
    m = dist.make_mesh(n_data=8, n_model=1)
    xs, out8, enc, dec = setup(b=8, seed=2)
    run = distributed_burst(m, lr=0.2, iters=10)
    got = run(dist.shard_batch(np.asarray(xs), m),
              dist.shard_batch(np.asarray(xs), m),
              dist.shard_batch(np.asarray(out8), m),
              enc.c, dec.c, enc.b, dec.b)
    want = fft_burst_dp(xs, xs, out8, enc.c, dec.c, enc.b, dec.b,
                        lr=0.2, iters=10, body="omega")
    assert_matches(got, want)


def test_distributed_burst_dp_tp_mesh():
    """distributed_burst on a data×model mesh engages the TP precompute."""
    m = dist.make_mesh(n_data=2, n_model=4)
    xs, out8, enc, dec = setup(b=4, seed=5)
    run = distributed_burst(m, lr=0.2, iters=4)
    got = run(dist.shard_batch(np.asarray(xs), m),
              dist.shard_batch(np.asarray(xs), m),
              dist.shard_batch(np.asarray(out8), m),
              enc.c, dec.c, enc.b, dec.b)
    want = fft_burst_dp(xs, xs, out8, enc.c, dec.c, enc.b, dec.b,
                        lr=0.2, iters=4, body="omega")
    assert_matches(got, want)


def test_corr_burst_pixel_scale_precision():
    """Regression: at pixel scale (values ~1e3) the naive correlation
    algebra cancels at signal-energy scale and fp32 produced NEGATIVE
    MSEs and diverging weights; the anchored decomposition (E₀/G₀/ΔK)
    keeps cancellation at initial-error scale."""
    cfg = Config(nx=32, ny=32, d=3,
                 layer=LayerParams(depth=10, lk=1, ll=1, scale=1, rmax=1.0))
    spec = initial_spec(cfg)
    params = init_params(jax.random.key(0), spec, 1.0)
    rng = np.random.default_rng(0)
    x = jnp.asarray((rng.random((3, 32, 32)) * 1000).astype(np.float32))
    out0 = model.forward_fft(params, x[None], spec.scales)[0]
    enc, dec = params.pair(0)
    got = fft_burst_corr(x, x, out0, enc.c, dec.c, enc.b, dec.b,
                         lr=0.2, iters=100)
    ref = fft_burst(x, x, out0, enc.c, dec.c, enc.b, dec.b,
                    lr=0.2, iters=100, impl="dft")
    m_got, m_ref = np.asarray(got.mses), np.asarray(ref.mses)
    assert np.all(m_got > 0), "MSE went negative (cancellation regression)"
    assert m_got[-1] < m_got[0] * 0.05
    # trajectories track exactly while far from the fp32 floor
    np.testing.assert_allclose(m_got[:20], m_ref[:20], rtol=5e-3)


def test_corr_burst_reanchoring_matches_unsegmented():
    """reanchor_every segments run the identical reference recursion —
    segmented == unsegmented while above the fp32 floor."""
    x, out0, enc, dec = setup()
    whole = fft_burst_corr(x, x, out0, enc.c, dec.c, enc.b, dec.b,
                           lr=0.2, iters=9)
    seg = fft_burst_corr(x, x, out0, enc.c, dec.c, enc.b, dec.b,
                         lr=0.2, iters=9, reanchor_every=3)
    assert len(np.asarray(seg.mses)) == 10
    assert_matches(seg, whole)


def test_corr_burst_reanchoring_extends_convergence():
    """Pixel-scale long burst: re-anchoring resets the cancellation floor
    so a 300-iteration run keeps tracking the ω-space burst."""
    cfg = Config(nx=32, ny=32, d=3,
                 layer=LayerParams(depth=10, lk=1, ll=1, scale=1, rmax=1.0))
    spec = initial_spec(cfg)
    params = init_params(jax.random.key(0), spec, 1.0)
    rng = np.random.default_rng(0)
    x = jnp.asarray((rng.random((3, 32, 32)) * 1000).astype(np.float32))
    out0 = model.forward_fft(params, x[None], spec.scales)[0]
    enc, dec = params.pair(0)
    got = fft_burst_corr(x, x, out0, enc.c, dec.c, enc.b, dec.b,
                         lr=0.2, iters=300, reanchor_every=100)
    ref = fft_burst(x, x, out0, enc.c, dec.c, enc.b, dec.b,
                    lr=0.2, iters=300, impl="dft")
    m_got, m_ref = np.asarray(got.mses), np.asarray(ref.mses)
    assert np.all(m_got > 0)
    # the normalized/clipped update makes long trajectories chaotic (two
    # exact implementations decorrelate), so assert: close tracking early
    # (2% absorbs ulp-level reassociation between the restricted-iDFT
    # precompute and the ω-space path), and the same convergence level at
    # the end
    np.testing.assert_allclose(m_got[:60], m_ref[:60], rtol=2e-2)
    assert m_got[-1] < m_got[0] * 0.05
    assert m_got[-1] < 2.0 * m_ref[-1]


def test_corr_burst_zero_iters_is_identity():
    x, out0, enc, dec = setup()
    r = fft_burst_corr(x, x, out0, enc.c, dec.c, enc.b, dec.b,
                       lr=0.2, iters=0)
    np.testing.assert_array_equal(np.asarray(r.c), np.asarray(enc.c))
    ref = fft_burst(x, x, out0, enc.c, dec.c, enc.b, dec.b,
                    lr=0.2, iters=0, impl="dft")
    np.testing.assert_allclose(np.asarray(r.mses), np.asarray(ref.mses),
                               rtol=1e-4)


def test_corr_burst_expout_none_equals_explicit():
    """expout=None (train against the input) is bit-identical to passing
    the input explicitly — it only changes what XLA can CSE."""
    x, out0, enc, dec = setup()
    a = fft_burst_corr(x, None, out0, enc.c, dec.c, enc.b, dec.b,
                       lr=0.2, iters=7)
    b = fft_burst_corr(x, x, out0, enc.c, dec.c, enc.b, dec.b,
                       lr=0.2, iters=7)
    np.testing.assert_array_equal(np.asarray(a.c), np.asarray(b.c))
    np.testing.assert_array_equal(np.asarray(a.mses), np.asarray(b.mses))


@pytest.mark.parametrize("nx,ny,d,m,lk,ll,b", [
    (16, 16, 2, 4, 1, 1, None),   # base case
    (16, 16, 2, 4, 1, 1, 3),      # batched (B>1)
    (16, 16, 3, 5, 1, 1, None),   # D≠M channel counts, D=3
    (16, 24, 2, 4, 1, 1, None),   # non-square grid
    (16, 15, 2, 3, 1, 1, 2),      # odd ny (no self-conjugate column)
    (20, 20, 2, 3, 1, 2, None),   # hx≠hy (5×7 kernels)
])
def test_fused_precompute_matches_unfused(nx, ny, d, m, lk, ll, b):
    """out0=None fuses the anchor forward into the precompute: the T dict
    must equal corr_precompute fed the explicit biased two-stage forward
    (G₀ collapses to the DC bias scalars)."""
    from spectralae.train.fft_corr import (corr_precompute,
                                           corr_precompute_fused,
                                           _true_forward)
    x, _, enc, dec = setup(nx=nx, ny=ny, d=d, m=m, lk=lk, ll=ll, b=b)
    xb = x if b else x[None]
    out0 = _true_forward(xb, enc.c, dec.c, enc.b, dec.b, True)
    Tu = corr_precompute(xb, xb, out0, enc.c, dec.c)
    Tf = corr_precompute_fused(xb, enc.c, dec.c, enc.b, dec.b)
    assert set(Tu) == set(Tf)
    # the unfused window transform's fp32 noise floor scales with the
    # |X|·|signal| plane magnitudes it sums, not with the entry values
    # (G0's windows are tiny numbers extracted from large products) — a
    # shared absolute floor from the largest lag tensor
    lag_scale = max(float(np.max(np.abs(np.asarray(Tu[k]))))
                    for k in ("XX", "XE0", "XG0"))
    for k in Tu:
        want = np.asarray(Tu[k])
        atol = (1e-5 * lag_scale if k in ("XX", "XE0", "XG0")
                else 1e-5 * float(np.max(np.abs(want))) + 1e-6)
        np.testing.assert_allclose(np.asarray(Tf[k]), want,
                                   rtol=2e-3, atol=atol, err_msg=k)


@pytest.mark.parametrize("batch,reanchor", [(None, None), (3, None),
                                            (None, 4)])
def test_fused_burst_matches_explicit_out0(batch, reanchor):
    """A full fused burst (out0=None) equals the unfused burst anchored on
    the explicitly-computed model forward — incl. batched and
    within-burst reanchoring (which re-anchors without any pixel-space
    round-trip on the fused path)."""
    from spectralae.train.fft_corr import _true_forward
    x, _, enc, dec = setup(b=batch)
    xb = x if batch else x[None]
    out0 = _true_forward(xb, enc.c, dec.c, enc.b, dec.b, True)
    out0 = out0 if batch else out0[0]
    ref = fft_burst_corr(x, None, out0, enc.c, dec.c, enc.b, dec.b,
                         lr=0.2, iters=9, reanchor_every=reanchor)
    got = fft_burst_corr(x, None, None, enc.c, dec.c, enc.b, dec.b,
                         lr=0.2, iters=9, reanchor_every=reanchor)
    assert_matches(got, ref, rtol=2e-4, atol=2e-4)


def test_fused_burst_rejects_foreign_expout():
    x, _, enc, dec = setup()
    with pytest.raises(ValueError, match="expout"):
        burst_corr(x, x + 1.0, None, enc.c, dec.c, enc.b, dec.b, iters=3)


@pytest.mark.parametrize("nx,lk,ll,d,m,b", [
    (16, 1, 1, 2, 4, None),   # XX window (17²) wider than the grid: aliasing
    pytest.param(32, 1, 2, 2, 3, 2,
                 marks=pytest.mark.slow),   # non-square kernel, batched
    pytest.param(32, 2, 2, 3, 4, None,
                 marks=pytest.mark.slow),   # 7×7 kernels (~40 s single-core)
])
def test_pixel_precompute_matches_spectral(nx, lk, ll, d, m, b):
    """The FFT-free pixel-space precompute (ops/pixel_corr.py) produces
    the same T dict as the spectral route — windows, energies, and DC
    scalars, including the mod-N lag aliasing when the window is wider
    than the grid."""
    from spectralae.train.fft_corr import corr_precompute_fused
    x, _, enc, dec = setup(nx=nx, d=d, m=m, lk=lk, ll=ll, b=b)
    xb = x if b else x[None]
    Ts = corr_precompute_fused(xb, enc.c, dec.c, enc.b, dec.b,
                               precompute="spectral")
    Tp = corr_precompute_fused(xb, enc.c, dec.c, enc.b, dec.b,
                               precompute="pixel")
    assert set(Ts) == set(Tp)
    lag_scale = max(float(np.max(np.abs(np.asarray(Ts[k]))))
                    for k in ("XX", "XE0", "XG0"))
    for k in Ts:
        want = np.asarray(Ts[k])
        atol = (1e-5 * lag_scale if k in ("XX", "XE0", "XG0")
                else 1e-5 * float(np.max(np.abs(want))) + 1e-6)
        np.testing.assert_allclose(np.asarray(Tp[k]), want,
                                   rtol=2e-3, atol=atol, err_msg=k)


@pytest.mark.parametrize("batch,maxdiff,reanchor", [
    (None, False, None), (2, False, None), (None, True, None),
    (None, False, 4),
])
def test_pixel_burst_matches_spectral(batch, maxdiff, reanchor):
    """Full fused bursts through the pixel-space precompute equal the
    spectral ones (weights, momentum, MSE trajectory)."""
    x, _, enc, dec = setup(b=batch)
    kw = dict(lr=0.2, iters=9, maxdiff=maxdiff, reanchor_every=reanchor)
    ref = fft_burst_corr(x, None, None, enc.c, dec.c, enc.b, dec.b,
                         precompute="spectral", **kw)
    got = fft_burst_corr(x, None, None, enc.c, dec.c, enc.b, dec.b,
                         precompute="pixel", **kw)
    assert_matches(got, ref, rtol=2e-4, atol=2e-4)


def test_pixel_precompute_rejects_model_axis():
    from spectralae.train.fft_corr import corr_precompute_fused
    x, _, enc, dec = setup()
    devs = jax.devices()[:2]
    m = jax.sharding.Mesh(np.array(devs), ("model",))

    def run(xb):
        return corr_precompute_fused(xb, enc.c, dec.c, enc.b, dec.b,
                                     model_axis="model",
                                     precompute="pixel")
    with pytest.raises(ValueError, match="pixel"):
        shard_map(run, mesh=m, in_specs=(P(),), out_specs=P(),
                  check_vma=False)(x[None])


@pytest.mark.parametrize("precompute,fused,match", [
    ("fft", True, "routes are"),           # no such route
    ("pixel", False, "fused-anchor"),      # pixel needs out0=None
])
def test_precompute_route_errors(precompute, fused, match):
    x, out0, enc, dec = setup()
    with pytest.raises(ValueError, match=match):
        fft_burst_corr(x, None, None if fused else out0, enc.c, dec.c,
                       enc.b, dec.b, iters=2, precompute=precompute)


def test_fused_burst_matches_dft_at_large_grid():
    """VERDICT r2 item 3 'done' criterion: corr-vs-dft equality at a
    large (non-square) grid through the fused path — the whole chain
    signal FFT → fused anchor → lag windows → iterations against the
    literal ω-space recursion."""
    from spectralae.train.fft_corr import _true_forward
    cfg = Config(nx=256, ny=384, d=2,
                 layer=LayerParams(depth=3, lk=1, ll=1, scale=1, rmax=0.5))
    spec = initial_spec(cfg)
    params = init_params(jax.random.key(9), spec, 0.5)
    x = jnp.asarray(np.random.default_rng(9).normal(
        size=(2, 256, 384)).astype(np.float32)) * 50
    enc, dec = params.pair(0)
    out0 = _true_forward(x[None], enc.c, dec.c, enc.b, dec.b, True)[0]
    ref = fft_burst(x, x, out0, enc.c, dec.c, enc.b, dec.b,
                    lr=0.2, iters=5, impl="dft")
    got = fft_burst_corr(x, None, None, enc.c, dec.c, enc.b, dec.b,
                         lr=0.2, iters=5)
    assert_matches(got, ref)


def test_corr_burst_non_square_grid():
    """nx ≠ ny exercises the separable lag bases' distinct axis handling."""
    cfg = Config(nx=16, ny=24, d=2,
                 layer=LayerParams(depth=3, lk=1, ll=1, scale=1, rmax=0.5))
    spec = initial_spec(cfg)
    params = init_params(jax.random.key(4), spec, 0.5)
    x = jnp.asarray(np.random.default_rng(4).normal(
        size=(2, 16, 24)).astype(np.float32)) * 50
    out0 = model.forward_fft(params, x[None], spec.scales)[0]
    enc, dec = params.pair(0)
    ref = fft_burst(x, x, out0, enc.c, dec.c, enc.b, dec.b,
                    lr=0.2, iters=6, impl="dft")
    got = fft_burst_corr(x, None, out0, enc.c, dec.c, enc.b, dec.b,
                         lr=0.2, iters=6)
    assert_matches(got, ref)


def test_serialized_fft_equality(monkeypatch):
    """At >_XLA_FFT_SERIALIZE_PIXELS total plane-pixels the fused precompute
    serializes the signal rfft2 one plane at a time (lax.map; ~planes×
    lower transient peak).  The serialized transform is the same FFT per
    plane, so the T dict must match the batched route to 1e-6."""
    from spectralae.train import fft_corr as fc
    x, _, enc, dec = setup(nx=32, d=3, b=2)
    batched = fc.corr_precompute_fused(x, enc.c, dec.c, enc.b, dec.b,
                                       precompute="spectral")
    monkeypatch.setattr(fc, "_XLA_FFT_SERIALIZE_PIXELS", 0)
    serial = fc.corr_precompute_fused(x, enc.c, dec.c, enc.b, dec.b,
                                      precompute="spectral")
    assert set(batched) == set(serial)
    for k in batched:
        np.testing.assert_allclose(np.asarray(serial[k]),
                                   np.asarray(batched[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
