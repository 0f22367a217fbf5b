"""Data-parallel momentum-space bursts: one kernel pair, many frames.

A *new* capability beyond the reference (whose burst trains on a single
frozen frame, SURVEY.md §2.9): the analytic frequency-domain gradients are
averaged over a batch of frozen patches each inner iteration, and the batch
shards over the mesh's ``data`` axis — gradients cross the interconnect via
``pmean`` under ``shard_map`` (XLA lowers the collective; NCCL on GPUs).

Semantics reduce exactly to the reference burst at B=1 (tested), making
this the scaling path for batched video streams.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import dft, spectral
from ..ops.spectral import HIGHEST
from ..optim.update import burst_inertia
from .fft import FFTBurstResult


def _gradient_k_io_batch(X, Y, O, Cf, Ff, b, nx, ny, axis_name=None):
    """Batch-averaged analytic gradients (see train.fft.gradient_k_io)."""
    dM, dD = Cf.shape[0], Cf.shape[1]
    norm = nx * ny
    Norm = norm * 2.0 * dM * dD * nx * ny
    E = O - Y                                               # [B, D, x, y]
    S = jnp.einsum("bdxy,dmxy->bmxy", E, jnp.conj(Ff),
                   precision=HIGHEST)
    H = jnp.einsum("mdxy,bdxy->bmxy", Cf, X,
                   precision=HIGHEST)
    H = H.at[:, :, 0, 0].add(b.astype(H.dtype) * norm)
    nb = X.shape[0]
    dc = jnp.einsum("bmxy,bdxy->mdxy", S, jnp.conj(X),
                   precision=HIGHEST) / (Norm * nb)
    df = jnp.einsum("bdxy,bmxy->dmxy", E, jnp.conj(H),
                   precision=HIGHEST) / (Norm * nb)
    db = jnp.mean(S[:, :, 0, 0].real, axis=0) * norm / Norm
    dp = jnp.mean(E[:, :, 0, 0].real, axis=0) * norm / Norm
    if axis_name is not None:
        dc, df, db, dp = jax.tree.map(
            lambda t: lax.pmean(t, axis_name), (dc, df, db, dp))
    return dc, df, db, dp


def _burst_dp_body(x, expout, out0, c, f, b, p, mom, *, lr, alpha, iters,
                   scale_by_dm, axis_name, maxdiff=False, w0=1.0, w1=10.0):
    nx, ny = x.shape[-2], x.shape[-1]
    dM, dD, nk, nl = c.shape
    del_eff = 0.1 * lr
    X = spectral.rfft2(x)
    Y = spectral.rfft2(expout)
    O = spectral.rfft2(out0)

    def batch_mse(Yb, Ob):
        m = jax.vmap(lambda a, o: spectral.parseval_mse(a, o, dD, dM, nx, ny)
                     )(Yb, Ob)
        m = jnp.mean(m)
        return lax.pmean(m, axis_name) if axis_name else m

    mses = jnp.zeros((iters + 1,), x.dtype).at[0].set(batch_mse(Y, O))

    def inertia(w, g, mo):
        return burst_inertia(w, g, mo, del_eff, alpha)

    def body(i, carry):
        # Cf/Ff ride the carry: the gradient pass needs the CURRENT
        # weights' spectra, which are exactly the post-update spectra the
        # previous iteration computed for its forward — recomputing them
        # at the top doubled the DFT matmuls per iteration (fori_loop CSE
        # cannot fold across iterations; same scheme as train/fft.py)
        c, f, b, p, Dc, Df, Db, Dp, O, Cf, Ff, mses = carry
        dc, df, db, dp = _gradient_k_io_batch(X, Y, O, Cf, Ff, b, nx, ny,
                                              axis_name)
        gc = dft.kernel_project(dc, nk, nl, nx, ny)
        gf = dft.kernel_project(df, nk, nl, nx, ny)
        if maxdiff:
            # multiobjective: reconstruction vs kernel diversity
            # (backprop_double, fft_backproplib.cu:657-704; w's set at 1252)
            from ..losses.losses import diversity_gradients
            cd, fd, bd, pd = diversity_gradients(c, f, b, p)
            gc, gf = w0 * gc - w1 * cd, w0 * gf - w1 * fd
            db, dp = w0 * db - w1 * bd, w0 * dp - w1 * pd
        c, Dc = inertia(c, gc, Dc)
        f, Df = inertia(f, gf, Df)
        b, Db = inertia(b, db, Db)
        p, Dp = inertia(p, dp, Dp)
        Cf = dft.kernel_spectrum(c, nx, ny)
        Ff = dft.kernel_spectrum(f, nx, ny)
        H = spectral.spectral_conv(X, Cf, b, nx, ny, scale_by_dm=scale_by_dm)
        O = spectral.spectral_conv(H, Ff, p, nx, ny, scale_by_dm=scale_by_dm)
        mses = mses.at[i + 1].set(batch_mse(Y, O))
        return (c, f, b, p, Dc, Df, Db, Dp, O, Cf, Ff, mses)

    init = (c, f, b, p, *mom, O, dft.kernel_spectrum(c, nx, ny),
            dft.kernel_spectrum(f, nx, ny), mses)
    out = lax.fori_loop(0, iters, body, init)
    c, f, b, p, Dc, Df, Db, Dp = out[:8]
    return FFTBurstResult(c=c, f=f, b=b, p=p, mom=(Dc, Df, Db, Dp),
                          mses=out[-1])


_BODIES = ("corr", "omega")


def _check_body(body, reanchor_every):
    if body is not None and body not in _BODIES:
        raise ValueError(f"body={body!r}: choose one of {_BODIES} or None "
                         "(the backend's choice)")
    if body == "omega" and reanchor_every is not None:
        # the ω-space body recomputes the forward every iteration and has
        # no anchored decomposition to reset
        raise ValueError("reanchor_every requires the correlation-space "
                         "body (body='omega' cannot reanchor)")


@functools.partial(jax.jit, static_argnames=("iters", "scale_by_dm",
                                             "body", "maxdiff",
                                             "reanchor_every"))
def fft_burst_dp(x: jax.Array, expout: jax.Array, out0: jax.Array,
                 c: jax.Array, f: jax.Array, b: jax.Array, p: jax.Array,
                 mom: tuple | None = None, *, lr: float = 0.2,
                 alpha: float = 0.9, iters: int = 100,
                 scale_by_dm: bool = True,
                 body: str | None = None,
                 maxdiff: bool = False, w0: float = 1.0, w1: float = 10.0,
                 reanchor_every: int | None = None) -> FFTBurstResult:
    """Single-device batched burst: ``x/expout/out0`` are ``[B, D, h, w]``.

    ``expout=None`` trains against the input itself (lets XLA CSE the
    expected-output transforms out of the corr precompute).  ``maxdiff``
    enables the multiobjective kernel-diversity combination;
    ``reanchor_every`` resets the cancellation floor on long bursts.

    ``body``: ``"corr"`` (the correlation-space body, train/fft_corr),
    ``"omega"`` (the jnp ω-space body, kept for cross-validation), or
    ``None`` — :func:`spectralae.core.backend.burst_body` decides."""
    _check_body(body, reanchor_every)
    if body is None:
        from ..core.backend import burst_body
        body = burst_body()
    if mom is None:
        mom = (jnp.zeros_like(c), jnp.zeros_like(f),
               jnp.zeros_like(b), jnp.zeros_like(p))
    if body == "corr":
        from .fft_corr import burst_corr
        return burst_corr(x, expout, out0, c, f, b, p, mom,
                          lr=lr, alpha=alpha, iters=iters,
                          maxdiff=maxdiff, w0=w0, w1=w1,
                          scale_by_dm=scale_by_dm,
                          reanchor_every=reanchor_every)
    if expout is None:
        expout = x  # the ω-space body has no None handling
    return _burst_dp_body(x, expout, out0, c, f, b, p, mom, lr=lr,
                          alpha=alpha, iters=iters, scale_by_dm=scale_by_dm,
                          axis_name=None, maxdiff=maxdiff, w0=w0, w1=w1)


def distributed_burst(mesh: Mesh, *, lr: float = 0.2, alpha: float = 0.9,
                      iters: int = 100, scale_by_dm: bool = True,
                      body: str = "corr",
                      maxdiff: bool = False, w0: float = 1.0,
                      w1: float = 10.0,
                      reanchor_every: int | None = None,
                      fused: bool = False):
    """Build a jitted multi-chip burst: batch sharded over 'data', params
    replicated.

    Default body is the correlation-space burst (train/fft_corr): ONE
    pmean of the lag tensors over 'data' replaces the per-iteration
    gradient collectives, and a >1-sized 'model' axis tensor-shards the
    resolution-dependent precompute — iterations run replicated and
    collective-free.  ``body="omega"`` selects the per-iteration ω-space
    jnp body (gradients pmean'd every iteration) for cross-validation.

    ``fused=True``: the fused-anchor contract (train against the input,
    anchor = the model's own forward, computed inside the precompute) —
    the returned callable takes ``run(x, c, f, b, p, mom=None)`` with no
    expout/out0.  With a >1 'model' axis this shards the ENTIRE
    resolution-scaled precompute (FFTs, kernel DFTs, products, windows),
    so per-device FLOPs drop ~1/n_model (tests/test_tp_proof.py).
    """
    _check_body(body, reanchor_every)
    if fused and body != "corr":
        raise ValueError("fused anchoring only exists on the "
                         "correlation-space body (body='corr')")
    from jax import shard_map

    batch_spec = P("data", None, None, None)
    rep = P()
    n_model = mesh.shape.get("model", 1)
    model_axis = "model" if n_model > 1 else None

    if fused:
        from .fft_corr import burst_corr

        def local_fused(x, c, f, b, p, Dc, Df, Db, Dp):
            return burst_corr(x, None, None, c, f, b, p,
                              (Dc, Df, Db, Dp), lr=lr, alpha=alpha,
                              iters=iters, scale_by_dm=scale_by_dm,
                              maxdiff=maxdiff, w0=w0, w1=w1,
                              axis_name="data", model_axis=model_axis,
                              reanchor_every=reanchor_every)

        sharded = shard_map(
            local_fused, mesh=mesh,
            in_specs=(batch_spec, rep, rep, rep, rep, rep, rep, rep, rep),
            out_specs=FFTBurstResult(c=rep, f=rep, b=rep, p=rep,
                                     mom=(rep, rep, rep, rep), mses=rep),
            check_vma=False)

        @jax.jit
        def run_fused(x, c, f, b, p, mom=None):
            if mom is None:
                mom = (jnp.zeros_like(c), jnp.zeros_like(f),
                       jnp.zeros_like(b), jnp.zeros_like(p))
            return sharded(x, c, f, b, p, *mom)

        return run_fused

    def local(x, expout, out0, c, f, b, p, Dc, Df, Db, Dp):
        if body == "corr":
            from .fft_corr import burst_corr
            return burst_corr(x, expout, out0, c, f, b, p,
                              (Dc, Df, Db, Dp), lr=lr, alpha=alpha,
                              iters=iters, scale_by_dm=scale_by_dm,
                              maxdiff=maxdiff, w0=w0, w1=w1,
                              axis_name="data",
                              model_axis=model_axis,
                              reanchor_every=reanchor_every)
        return _burst_dp_body(x, expout, out0, c, f, b, p,
                              (Dc, Df, Db, Dp), lr=lr, alpha=alpha,
                              iters=iters, scale_by_dm=scale_by_dm,
                              axis_name="data")

    sharded = shard_map(
        local, mesh=mesh,
        in_specs=(batch_spec, batch_spec, batch_spec,
                  rep, rep, rep, rep, rep, rep, rep, rep),
        out_specs=FFTBurstResult(c=rep, f=rep, b=rep, p=rep,
                                 mom=(rep, rep, rep, rep), mses=rep),
        check_vma=False)

    @jax.jit
    def run(x, expout, out0, c, f, b, p, mom=None):
        if expout is None:
            expout = x  # same traced value → XLA CSEs the Y-side work
        if mom is None:
            mom = (jnp.zeros_like(c), jnp.zeros_like(f),
                   jnp.zeros_like(b), jnp.zeros_like(p))
        return sharded(x, expout, out0, c, f, b, p, *mom)

    return run
