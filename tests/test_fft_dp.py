"""Data-parallel burst: B=1 equivalence, convergence, 8-device sharding."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from spectralae.core.config import Config, LayerParams
from spectralae.core.types import initial_spec, init_params
from spectralae.dist import mesh as dist
from spectralae.model import autoencoder as model
from spectralae.train.fft import fft_burst
from spectralae.train.fft_dp import fft_burst_dp, distributed_burst


def setup(nx=16, d=2, m=4, b=8, seed=0):
    cfg = Config(nx=nx, ny=nx, d=d,
                 layer=LayerParams(depth=m, lk=1, ll=1, scale=1, rmax=0.5))
    spec = initial_spec(cfg)
    params = init_params(jax.random.key(seed), spec, 0.5)
    xs = jnp.asarray(np.random.default_rng(seed).normal(
        size=(b, d, nx, nx)).astype(np.float32)) * 50
    out0 = model.forward_fft(params, xs, spec.scales)
    enc, dec = params.pair(0)
    return xs, out0, enc, dec


def test_dp_burst_b1_matches_reference_burst():
    xs, out0, enc, dec = setup(b=1)
    ref = fft_burst(xs[0], xs[0], out0[0], enc.c, dec.c, enc.b, dec.b,
                    lr=0.2, iters=5, impl="dft")
    got = fft_burst_dp(xs, xs, out0, enc.c, dec.c, enc.b, dec.b,
                       lr=0.2, iters=5)
    np.testing.assert_allclose(np.asarray(got.mses), np.asarray(ref.mses),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(got.c), np.asarray(ref.c),
                               rtol=1e-4, atol=1e-5)


def test_dp_burst_converges_on_batch():
    xs, out0, enc, dec = setup(b=4)
    res = fft_burst_dp(xs, xs, out0, enc.c, dec.c, enc.b, dec.b,
                       lr=0.2, iters=60)
    mses = np.asarray(res.mses)
    assert np.isfinite(mses).all()
    assert mses[-1] < mses[0] * 0.9


def test_carried_momentum_chains_bursts():
    """Two k-iteration bursts with carried momentum and a refreshed out0
    equal one 2k-iteration burst — the --carry-momentum streaming
    semantics (the reference zeroes per burst: fft_backproplib.cu:1420)."""
    from spectralae.core.config import Config, LayerParams
    from spectralae.core.types import AEParams, ConvStage, initial_spec, \
        init_params
    cfg = Config(nx=16, ny=16, d=2,
                 layer=LayerParams(depth=4, lk=1, ll=1, scale=1, rmax=0.5))
    spec = initial_spec(cfg)
    params = init_params(jax.random.key(5), spec, 0.5)
    xs = jnp.asarray(np.random.default_rng(5).normal(
        size=(2, 2, 16, 16)).astype(np.float32)) * 50
    out0 = model.forward_fft(params, xs, spec.scales)
    enc, dec = params.pair(0)
    whole = fft_burst_dp(xs, xs, out0, enc.c, dec.c, enc.b, dec.b,
                         lr=0.2, iters=8)
    r1 = fft_burst_dp(xs, xs, out0, enc.c, dec.c, enc.b, dec.b,
                      lr=0.2, iters=4)
    p1 = AEParams(stages=(ConvStage(c=r1.c, b=r1.b),
                          ConvStage(c=r1.f, b=r1.p)))
    out1 = model.forward_fft(p1, xs, spec.scales)
    r2 = fft_burst_dp(xs, xs, out1, r1.c, r1.f, r1.b, r1.p, r1.mom,
                      lr=0.2, iters=4)
    np.testing.assert_allclose(np.asarray(r2.c), np.asarray(whole.c),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(r2.mses),
                               np.asarray(whole.mses)[4:], rtol=1e-4,
                               atol=1e-5)
    # zeroed momentum (reference semantics) diverges from the chained run
    r2z = fft_burst_dp(xs, xs, out1, r1.c, r1.f, r1.b, r1.p, None,
                       lr=0.2, iters=4)
    assert not np.allclose(np.asarray(r2z.c), np.asarray(whole.c),
                           rtol=1e-4, atol=1e-5)


def test_distributed_burst_matches_single_device():
    assert len(jax.devices()) == 8
    m = dist.make_mesh(n_data=8, n_model=1)
    xs, out0, enc, dec = setup(b=8)
    xs_s = dist.shard_batch(np.asarray(xs), m)
    out0_s = dist.shard_batch(np.asarray(out0), m)
    run = distributed_burst(m, lr=0.2, iters=10)
    got = run(xs_s, xs_s, out0_s, enc.c, dec.c, enc.b, dec.b)
    want = fft_burst_dp(xs, xs, out0, enc.c, dec.c, enc.b, dec.b,
                        lr=0.2, iters=10)
    np.testing.assert_allclose(np.asarray(got.mses), np.asarray(want.mses),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(got.c), np.asarray(want.c),
                               rtol=1e-4, atol=1e-5)


# ---------------------------------------------------- coord-domain DP step

def _coord_setup(nx=16, d=2, m=4, b=4, seed=0):
    from spectralae.train.coord import coord_step
    cfg = Config(nx=nx, ny=nx, d=d,
                 layer=LayerParams(depth=m, lk=1, ll=1, scale=1, rmax=0.5))
    spec = initial_spec(cfg)
    params = init_params(jax.random.key(seed), spec, 0.5)
    rng = np.random.default_rng(seed)
    in_b = jnp.asarray(rng.normal(size=(b, d, nx, nx)).astype(np.float32)) * 50
    acts = model.forward_coord(params, in_b, spec.scales, tap_mode="ref_gpu")
    hin_b, out_b = acts[2], acts[-2]
    enc, dec = params.pair(0)
    zeros = (jnp.zeros_like(enc.c), jnp.zeros_like(dec.c),
             jnp.zeros_like(enc.b), jnp.zeros_like(dec.b))
    return in_b, out_b, hin_b, enc, dec, zeros


def test_coord_step_dp_b1_matches_coord_step():
    from spectralae.train.coord import coord_step, coord_step_dp
    in_b, out_b, hin_b, enc, dec, z = _coord_setup(b=1)
    ref = coord_step(in_b[0], out_b[0], hin_b[0], enc.c, dec.c, enc.b, dec.b,
                     z, z, lr=0.2)
    got = coord_step_dp(in_b, out_b, hin_b, enc.c, dec.c, enc.b, dec.b,
                        z, z, lr=0.2)
    np.testing.assert_allclose(np.asarray(got.c), np.asarray(ref.c),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(got.mse), np.asarray(ref.mse),
                               rtol=1e-6)


def test_coord_step_dp_averages_gradients():
    """A batch of identical frames must equal the single-frame step, and a
    mixed batch must equal the update from hand-averaged gradients."""
    from spectralae.train.coord import (coord_ref_gradients, coord_step,
                                        coord_step_dp, _apply_update)
    in_b, out_b, hin_b, enc, dec, z = _coord_setup(b=4, seed=2)
    # identical frames
    rep = lambda t: jnp.broadcast_to(t[:1], t.shape)
    got = coord_step_dp(rep(in_b), rep(out_b), rep(hin_b), enc.c, dec.c,
                        enc.b, dec.b, z, z, lr=0.2)
    ref = coord_step(in_b[0], out_b[0], hin_b[0], enc.c, dec.c, enc.b, dec.b,
                     z, z, lr=0.2)
    np.testing.assert_allclose(np.asarray(got.c), np.asarray(ref.c),
                               rtol=1e-5, atol=1e-6)
    # mixed batch == update from mean gradients
    nk, nl = enc.c.shape[-2], enc.c.shape[-1]
    gs = [coord_ref_gradients(i, o, h, dec.c, nk, nl, tap_mode="ref_gpu")
          for i, o, h in zip(in_b, out_b, hin_b)]
    gmean = jax.tree.map(lambda *t: jnp.mean(jnp.stack(t), axis=0), *gs)
    mses = [jnp.sum((i - o) ** 2) for i, o in zip(in_b, out_b)]
    d_, m_ = in_b.shape[1], hin_b.shape[1]
    mse = jnp.mean(jnp.stack(mses)) / (d_ * m_ * nk * nl
                                       * in_b.shape[-2] * in_b.shape[-1])
    want = _apply_update(gmean, mse, enc.c, dec.c, enc.b, dec.b, z, z,
                         lr=0.2, alpha=0.9, sym=False, active=False)
    got = coord_step_dp(in_b, out_b, hin_b, enc.c, dec.c, enc.b, dec.b,
                        z, z, lr=0.2)
    np.testing.assert_allclose(np.asarray(got.c), np.asarray(want.c),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(got.mse), np.asarray(want.mse),
                               rtol=1e-5)


def test_distributed_coord_step_matches_single_device():
    from spectralae.train.coord import coord_step_dp, distributed_coord_step
    assert len(jax.devices()) == 8
    m = dist.make_mesh(n_data=8, n_model=1)
    in_b, out_b, hin_b, enc, dec, z = _coord_setup(b=8, seed=4)
    sb = lambda t: dist.shard_batch(np.asarray(t), m)
    run = distributed_coord_step(m, lr=0.2)
    got = run(sb(in_b), sb(out_b), sb(hin_b), enc.c, dec.c, enc.b, dec.b)
    want = coord_step_dp(in_b, out_b, hin_b, enc.c, dec.c, enc.b, dec.b,
                         z, z, lr=0.2)
    np.testing.assert_allclose(np.asarray(got.c), np.asarray(want.c),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(got.mse), np.asarray(want.mse),
                               rtol=1e-5)


def test_dp_burst_maxdiff_b1_matches_reference_burst():
    """The multiobjective combination in the DP body (and the corr body
    it dispatches to on the GPU) equals the single-frame reference burst."""
    xs, out0, enc, dec = setup(b=1)
    ref = fft_burst(xs[0], xs[0], out0[0], enc.c, dec.c, enc.b, dec.b,
                    lr=0.2, iters=5, impl="dft", maxdiff=True)
    got = fft_burst_dp(xs, xs, out0, enc.c, dec.c, enc.b, dec.b,
                       lr=0.2, iters=5, maxdiff=True)
    np.testing.assert_allclose(np.asarray(got.c), np.asarray(ref.c),
                               rtol=1e-4, atol=1e-5)
    corr = fft_burst_dp(xs, xs, out0, enc.c, dec.c, enc.b, dec.b,
                        lr=0.2, iters=5, maxdiff=True, body="corr")
    np.testing.assert_allclose(np.asarray(corr.c), np.asarray(ref.c),
                               rtol=1e-4, atol=1e-5)


def test_cli_burst_maxdiff_and_reanchor(tmp_path, capsys):
    from spectralae.cli.main import main
    main(["train", "--nx", "16", "--steps", "1", "--batch", "2",
          "--mode", "burst", "--iters", "6", "--maxdiff", "--reanchor", "3",
          "--log-every", "1"])
    out = capsys.readouterr().out
    assert '"mse0"' in out and '"mseN"' in out


def test_reanchor_forces_corr_path_on_any_platform():
    """--reanchor must never be silently dropped: on CPU (where the
    fallback would be the ω-space body) fft_burst_dp with reanchor_every
    routes to the correlation path."""
    from spectralae.train.fft_corr import fft_burst_corr
    xs, out0, enc, dec = setup(b=2)
    got = fft_burst_dp(xs, xs, out0, enc.c, dec.c, enc.b, dec.b,
                       lr=0.2, iters=8, reanchor_every=4)
    want = fft_burst_corr(xs, xs, out0, enc.c, dec.c, enc.b, dec.b,
                          lr=0.2, iters=8, reanchor_every=4)
    np.testing.assert_allclose(np.asarray(got.c), np.asarray(want.c),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(got.mses), np.asarray(want.mses),
                               rtol=1e-6)


def test_reanchor_with_explicit_omega_body_rejected():
    """An explicit body="omega" (ω-space cross-validation body) plus
    reanchor_every is contradictory — fft_burst_dp raises like
    distributed_burst instead of silently rerouting (ADVICE r2)."""
    xs, out0, enc, dec = setup(b=2)
    with pytest.raises(ValueError, match="reanchor"):
        fft_burst_dp(xs, xs, out0, enc.c, dec.c, enc.b, dec.b,
                     lr=0.2, iters=4, body="omega", reanchor_every=2)
