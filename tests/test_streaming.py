"""Streaming multi-burst driver: scan == sequential bursts (VERDICT r2 #4)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from spectralae.train.streaming import (fft_stream, stream_bursts,
                                        stream_reference_loop)


def setup(k=3, b=None, d=2, m=3, n=16, nk=3, seed=0):
    rng = np.random.default_rng(seed)
    shape = (k, d, n, n) if b is None else (k, b, d, n, n)
    xs = jnp.asarray(rng.normal(size=shape).astype(np.float32))
    c = jnp.asarray(rng.normal(size=(m, d, nk, nk)).astype(np.float32) * .3)
    f = jnp.asarray(rng.normal(size=(d, m, nk, nk)).astype(np.float32) * .3)
    bb = jnp.asarray(rng.normal(size=(m,)).astype(np.float32) * .1)
    p = jnp.asarray(rng.normal(size=(d,)).astype(np.float32) * .1)
    return xs, c, f, bb, p


@pytest.mark.parametrize("carry", [True, False])
def test_stream_equals_sequential_bursts(carry):
    xs, c, f, b, p = setup(k=3)
    got = fft_stream(xs, c, f, b, p, iters=8, carry_momentum=carry)
    want = stream_reference_loop(xs, c, f, b, p, iters=8,
                                 carry_momentum=carry)
    np.testing.assert_allclose(np.asarray(got.c), np.asarray(want.c),
                               rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(got.f), np.asarray(want.f),
                               rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(got.mses), np.asarray(want.mses),
                               rtol=2e-5, atol=1e-7)
    assert got.mses.shape == (3, 9)


def test_stream_batched_frames():
    xs, c, f, b, p = setup(k=2, b=3)
    got = fft_stream(xs, c, f, b, p, iters=5)
    want = stream_reference_loop(xs, c, f, b, p, iters=5)
    np.testing.assert_allclose(np.asarray(got.c), np.asarray(want.c),
                               rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(got.mses), np.asarray(want.mses),
                               rtol=2e-5, atol=1e-7)


def test_stream_trains_on_static_scene():
    """A repeated frame is steady-state training: the per-frame entry MSE
    must fall monotonically-ish across the stream and substantially
    overall (the capability the driver exists for)."""
    xs, c, f, b, p = setup(k=6, seed=3)
    xs = jnp.broadcast_to(xs[:1], xs.shape)  # static scene
    r = fft_stream(xs, c, f, b, p, iters=60, lr=2.0)
    entry = np.asarray(r.mses[:, 0])
    assert np.all(np.diff(entry) < 0)       # every frame helps
    assert entry[-1] < 0.55 * entry[0]      # measured: 0.448
    # within-frame trajectories decrease too
    assert np.asarray(r.mses[0, -1]) < np.asarray(r.mses[0, 0])


def test_stream_reanchor_within_frame():
    xs, c, f, b, p = setup(k=2, seed=5)
    got = fft_stream(xs, c, f, b, p, iters=9, reanchor_every=4)
    want = stream_reference_loop(xs, c, f, b, p, iters=9, reanchor_every=4)
    np.testing.assert_allclose(np.asarray(got.c), np.asarray(want.c),
                               rtol=2e-5, atol=1e-6)
    assert got.mses.shape == (2, 10)


def test_stream_maxdiff_smoke():
    xs, c, f, b, p = setup(k=2, seed=7)
    r = fft_stream(xs, c, f, b, p, iters=4, maxdiff=True)
    for leaf in (r.c, r.f, r.b, r.p):
        assert np.all(np.isfinite(np.asarray(leaf)))


def _deep_net(nx=16, d=3, depth=4, seed=0):
    from spectralae.core.config import Config, LayerParams
    from spectralae.core.types import initial_spec, init_params
    cfg = Config(nx=nx, ny=nx, d=d,
                 layer=LayerParams(depth=depth, lk=0, ll=0, scale=2,
                                   rmax=0.4))
    spec = initial_spec(cfg).add_pair(cfg.layer)
    params = init_params(jax.random.key(seed), spec, cfg.layer.rmax)
    return params, spec


def test_pair_input_matches_forward_layers():
    """_pair_input == forward_fft(return_layers=True)'s pooled-input
    activation layers[2·n_l+1] — the burst trainers' input contract."""
    from spectralae.model import autoencoder as model
    from spectralae.train.streaming import _pair_input
    params, spec = _deep_net()
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=(2, 3, 16, 16)).astype(np.float32))
    _, layers = jax.jit(lambda p, xx: model.forward_fft(
        p, xx, spec.scales, return_layers=True))(params, x)
    for n_l in range(spec.n_pairs):
        got = jax.jit(lambda p, xx, n=n_l: _pair_input(
            p, xx, spec.scales, n))(params, x)
        np.testing.assert_allclose(np.asarray(got),
                                   np.asarray(layers[2 * n_l + 1]),
                                   rtol=1e-5, atol=1e-5)


def test_stream_pair_dp_equals_single_device():
    """Inner-pair streaming under data parallelism (per-frame batch
    sharded over 'data', lag tensors pmean'd) equals the single-device
    batched stream."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from spectralae.dist.mesh import make_mesh
    from spectralae.train.streaming import (StreamResult, fft_stream_pair,
                                            stream_bursts_pair)
    params, spec = _deep_net()
    ndev = len(jax.devices())
    rng = np.random.default_rng(4)
    xs = jnp.asarray(rng.normal(size=(2, ndev, 3, 16, 16))
                     .astype(np.float32))
    want = fft_stream_pair(xs, params, spec.scales, 1, iters=5)
    mesh = make_mesh(n_data=ndev, n_model=1)
    sharded = shard_map(
        lambda xs_, pp: stream_bursts_pair(xs_, pp, spec.scales, 1,
                                           iters=5, axis_name="data"),
        mesh=mesh, in_specs=(P(None, "data"), P()),
        out_specs=StreamResult(c=P(), f=P(), b=P(), p=P(),
                               mom=(P(), P(), P(), P()), mses=P()),
        check_vma=False)
    got = jax.jit(sharded)(xs, params)
    np.testing.assert_allclose(np.asarray(got.c), np.asarray(want.c),
                               rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(got.mses), np.asarray(want.mses),
                               rtol=2e-5, atol=1e-7)


@pytest.mark.parametrize("carry", [
    pytest.param(True, marks=pytest.mark.slow),   # ~25 s single-core
    False,
])
def test_stream_sweep_equals_sequential_pair_sweep(carry):
    """stream_bursts_sweep == the host loop [per frame: per pair:
    activation through the pairs already updated this frame → fused
    burst → replace_pair] — the keyboard 'z'/'x' sweep oracle."""
    from spectralae.core.types import ConvStage
    from spectralae.train.fft_corr import burst_corr
    from spectralae.train.streaming import (_pair_input, fft_stream_sweep)
    params, spec = _deep_net()
    rng = np.random.default_rng(6)
    xs = jnp.asarray(rng.normal(size=(2, 2, 3, 16, 16)).astype(np.float32))
    got = fft_stream_sweep(xs, params, spec.scales, iters=4,
                           carry_momentum=carry)

    prm = params
    moms = {n: tuple(jnp.zeros_like(t)
                     for t in (prm.pair(n)[0].c, prm.pair(n)[1].c,
                               prm.pair(n)[0].b, prm.pair(n)[1].b))
            for n in range(spec.n_pairs)}
    act = jax.jit(lambda p, xx, n: _pair_input(p, xx, spec.scales, n),
                  static_argnums=2)
    mses = []
    for k in range(xs.shape[0]):
        row = []
        for n_l in range(spec.n_pairs):
            in_b = act(prm, xs[k], n_l)
            enc, dec = prm.pair(n_l)
            mo = (moms[n_l] if carry else
                  tuple(jnp.zeros_like(t) for t in moms[n_l]))
            r = burst_corr(in_b, None, None, enc.c, dec.c, enc.b, dec.b,
                           mo, iters=4)
            prm = prm.replace_pair(n_l, ConvStage(c=r.c, b=r.b),
                                   ConvStage(c=r.f, b=r.p))
            moms[n_l] = r.mom
            row.append(r.mses)
        mses.append(jnp.stack(row))
    assert got.mses.shape == (2, spec.n_pairs, 5)
    for n_l in range(spec.n_pairs):
        ge, gd = got.params.pair(n_l)
        we, wd = prm.pair(n_l)
        np.testing.assert_allclose(np.asarray(ge.c), np.asarray(we.c),
                                   rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(np.asarray(gd.c), np.asarray(wd.c),
                                   rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(got.mses), np.stack(mses),
                               rtol=2e-5, atol=1e-7)


def test_stream_sweep_trains_every_pair():
    """On a static scene, every pair's entry MSE falls across frames."""
    from spectralae.train.streaming import fft_stream_sweep
    params, spec = _deep_net()
    rng = np.random.default_rng(8)
    x = jnp.asarray(rng.normal(size=(1, 2, 3, 16, 16)).astype(np.float32))
    xs = jnp.broadcast_to(x, (4,) + x.shape[1:])
    r = fft_stream_sweep(xs, params, spec.scales, iters=30, lr=1.0)
    entry = np.asarray(r.mses[:, :, 0])     # [K, n_pairs]
    assert np.all(entry[-1] < entry[0])
    assert np.all(np.isfinite(np.asarray(r.mses)))


def test_stream_sweep_dp_equals_single_device():
    """Per-frame all-pairs sweep under data parallelism equals the
    single-device batched sweep."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from spectralae.dist.mesh import make_mesh
    from spectralae.train.streaming import (SweepResult, fft_stream_sweep,
                                            stream_bursts_sweep)
    params, spec = _deep_net()
    ndev = len(jax.devices())
    rng = np.random.default_rng(9)
    xs = jnp.asarray(rng.normal(size=(2, ndev, 3, 16, 16))
                     .astype(np.float32))
    want = fft_stream_sweep(xs, params, spec.scales, iters=4)
    mesh = make_mesh(n_data=ndev, n_model=1)
    mom_spec = tuple((P(), P(), P(), P()) for _ in range(spec.n_pairs))
    sharded = shard_map(
        lambda xs_, pp: stream_bursts_sweep(xs_, pp, spec.scales,
                                            iters=4, axis_name="data"),
        mesh=mesh, in_specs=(P(None, "data"), P()),
        out_specs=SweepResult(params=P(), moms=mom_spec, mses=P()),
        check_vma=False)
    got = jax.jit(sharded)(xs, params)
    for n_l in range(spec.n_pairs):
        ge, _ = got.params.pair(n_l)
        we, _ = want.params.pair(n_l)
        np.testing.assert_allclose(np.asarray(ge.c), np.asarray(we.c),
                                   rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(got.mses), np.asarray(want.mses),
                               rtol=2e-5, atol=1e-7)


@pytest.mark.parametrize("n_l,q", [(0, 1), (1, 2)])
def test_coord_stream_equals_sequential_steps(n_l, q):
    """stream_coord_steps == the host loop [forward_coord → center_crop →
    coord_step → replace_pair] (the engine's coord-domain '1' loop)."""
    from spectralae.core.types import ConvStage
    from spectralae.model import autoencoder as model
    from spectralae.ops import coord as coord_ops
    from spectralae.train.coord import coord_step
    from spectralae.train.streaming import coord_stream
    params, spec = _deep_net()
    rng = np.random.default_rng(11)
    xs = jnp.asarray(rng.normal(size=(3, 3, 16, 16)).astype(np.float32))
    got = coord_stream(xs, params, spec.scales, n_l, q=q, lr=0.3)

    prm = params
    enc, dec = prm.pair(n_l)
    mom = tuple(jnp.zeros_like(t) for t in (enc.c, dec.c, enc.b, dec.b))
    pg = tuple(jnp.zeros_like(t) for t in mom)
    mses = []
    n_acts = 2 * prm.n_stages + 1
    fwd = jax.jit(lambda p, xx: model.forward_coord(
        p, xx, spec.scales, tap_mode="ref_gpu"))
    for k in range(xs.shape[0]):
        acts = fwd(prm, xs[k][None])
        in_s = coord_ops.center_crop(acts[2 * n_l + 1][0], q)
        hin_s = coord_ops.center_crop(acts[2 * n_l + 2][0], q)
        out_s = coord_ops.center_crop(acts[n_acts - 2 - 2 * n_l][0], q)
        e2, d2 = prm.pair(n_l)
        r = coord_step(in_s, out_s, hin_s, e2.c, d2.c, e2.b, d2.b,
                       mom, pg, lr=0.3)
        mom, pg = r.mom, r.prev_grad
        prm = prm.replace_pair(n_l, ConvStage(c=r.c, b=r.b),
                               ConvStage(c=r.f, b=r.p))
        mses.append(r.mse)
    for i in range(len(prm.stages)):
        np.testing.assert_allclose(
            np.asarray(got.params.stages[i].c),
            np.asarray(prm.stages[i].c), rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(got.mses), np.asarray(mses),
                               rtol=2e-5, atol=1e-7)


def test_coord_stream_dp_equals_single_device():
    """Coordinate streaming under DP (per-frame batch sharded, averaged
    gradients pmean'd) equals the single-device batched stream."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from spectralae.dist.mesh import make_mesh
    from spectralae.train.streaming import (CoordStreamResult, coord_stream,
                                            stream_coord_steps)
    params, spec = _deep_net()
    ndev = len(jax.devices())
    rng = np.random.default_rng(13)
    xs = jnp.asarray(rng.normal(size=(2, ndev, 3, 16, 16))
                     .astype(np.float32))
    want = coord_stream(xs, params, spec.scales, 1, q=2, lr=0.3)
    mesh = make_mesh(n_data=ndev, n_model=1)
    r4 = (P(), P(), P(), P())
    sharded = shard_map(
        lambda xs_, pp: stream_coord_steps(xs_, pp, spec.scales, 1, q=2,
                                           lr=0.3, axis_name="data"),
        mesh=mesh, in_specs=(P(None, "data"), P()),
        out_specs=CoordStreamResult(params=P(), mom=r4, prev_grad=r4,
                                    mses=P()),
        check_vma=False)
    got = jax.jit(sharded)(xs, params)
    for i in range(len(params.stages)):
        np.testing.assert_allclose(
            np.asarray(got.params.stages[i].c),
            np.asarray(want.params.stages[i].c), rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(got.mses), np.asarray(want.mses),
                               rtol=2e-5, atol=1e-7)


def test_coord_stream_trains_and_supports_sym():
    """Static scene: the per-frame coord mse falls; sym=True keeps f tied
    to c-transposed across the whole stream."""
    from spectralae.train.streaming import coord_stream
    params, spec = _deep_net()
    rng = np.random.default_rng(12)
    x = jnp.asarray(rng.normal(size=(1, 3, 16, 16)).astype(np.float32))
    xs = jnp.broadcast_to(x, (12,) + x.shape[1:])
    r = coord_stream(xs, params, spec.scales, 0, lr=1.0)
    entry = np.asarray(r.mses)
    assert entry[-1] < entry[0]
    rs = coord_stream(xs, params, spec.scales, 0, lr=1.0, sym=True)
    e, d = rs.params.pair(0)
    np.testing.assert_array_equal(
        np.asarray(d.c), np.transpose(np.asarray(e.c), (1, 0, 2, 3)))


def test_stream_pair_equals_sequential_inner_bursts():
    """stream_bursts_pair(n_l=1) == the per-frame host loop
    [pair activation via forward layers → fused burst → carry]."""
    from spectralae.model import autoencoder as model
    from spectralae.train.fft_corr import burst_corr
    from spectralae.train.streaming import fft_stream_pair
    params, spec = _deep_net()
    n_l = 1
    rng = np.random.default_rng(2)
    xs = jnp.asarray(rng.normal(size=(3, 2, 3, 16, 16)).astype(np.float32))
    got = fft_stream_pair(xs, params, spec.scales, n_l, iters=6)

    fwd = jax.jit(lambda p, xx: model.forward_fft(
        p, xx, spec.scales, return_layers=True))
    enc, dec = params.pair(n_l)
    c, f, b, p = enc.c, dec.c, enc.b, dec.b
    mom = tuple(jnp.zeros_like(t) for t in (c, f, b, p))
    mses = []
    for k in range(xs.shape[0]):
        # outer stages frozen: any pair weights give the same layers[2n+1]
        _, layers = fwd(params, xs[k])
        r = burst_corr(layers[2 * n_l + 1], None, None, c, f, b, p, mom,
                       iters=6)
        c, f, b, p, mom = r.c, r.f, r.b, r.p, r.mom
        mses.append(r.mses)
    np.testing.assert_allclose(np.asarray(got.c), np.asarray(c),
                               rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(got.f), np.asarray(f),
                               rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(got.mses), np.stack(mses),
                               rtol=2e-5, atol=1e-7)
