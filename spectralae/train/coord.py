"""Coordinate-space training step (reference-semantics gradients, vectorized).

The reference launches one CUDA grid + two device→host Thrust reductions *per
weight element* — M·D·Nk·Nl sequential launches per step
(``backprop_gpu``, source/backproplib.cu:363-417).  The gradients themselves
are linear functionals of the activations, so here the full gradient set
is three transposed reference-semantics convolutions (``jax.linear_transpose``
— no primal forwards) replacing the launch storm; a patch-matmul
formulation is available via ``impl='patches'``.

Identity derivation: with E = out−in and the reference conv ``∗`` (tap-window
semantics of :mod:`spectralae.ops.coord`, no /dM, no bias, identity act),

  dDdC = ∂/∂c ⟨E, f ∗ (c ∗ in)⟩ / Norm       (gradient_CF/CFBP, 186-288)
  dDdF = ∂/∂f ⟨E, f ∗ hin⟩ / Norm
  dDdB = Σ_pix ∂/∂h ⟨E, f ∗ h⟩|_{h=hin} / Norm
  dDdP = Σ_pix E / Norm

with Norm = D·M·Nk·Nl·Nx·Ny (backproplib.cu:303).

Deliberate bug-fixes vs the reference (documented per SURVEY.md §7):
- ``dDdB`` accumulates over all input channels (the reference's ``dDdB2=``
  assignment at backproplib.cu:220 drops all but the last — the symmetric
  variant at line 457 uses ``+=``, showing the intent);
- the ``(i-ik)*Nx``/``j-ik`` indexing bugs (lines 226, 283) are not copied.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..core.config import TapMode
from ..ops import coord
from ..optim.update import normalized_momentum_update


class CoordGrads(NamedTuple):
    dc: jax.Array   # [M, D, Nk, Nl]
    df: jax.Array   # [D, M, Nk, Nl]
    db: jax.Array   # [M]
    dp: jax.Array   # [D]


def _transpose_patches(E: jax.Array, nk: int, nl: int,
                       tap_mode: TapMode) -> jax.Array:
    """Patches ``P[c, (k,l), a, b] = E_padded[c, a+ik0+k, b+il0+l]``.

    The transpose of the reference tap window ``out[i] = Σ c[k]·in[i−ik0−k]``
    — its padding is the forward padding reversed.
    """
    from ..core.config import tap_anchor
    ik0, il0 = tap_anchor(nk, tap_mode), tap_anchor(nl, tap_mode)
    pad = ((-ik0, nk - 1 + ik0), (-il0, nl - 1 + il0))
    p = lax.conv_general_dilated_patches(
        E[None], filter_shape=(nk, nl), window_strides=(1, 1), padding=pad,
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        precision=lax.Precision.HIGHEST)[0]
    return p.reshape(E.shape[0], nk * nl, E.shape[1], E.shape[2])


def coord_ref_gradients(in_s: jax.Array, out_s: jax.Array, hin_s: jax.Array,
                        f: jax.Array, nk: int, nl: int, *,
                        tap_mode: TapMode = "ref_gpu",
                        impl: str = "transpose") -> CoordGrads:
    """Reference-exact coordinate gradients for one stage pair.

    Args:
      in_s/out_s: ``[D, h, w]`` cropped input / reconstruction
        (``Portion`` of the *full-frame* forward — the reference trains on
        mismatched crop boundaries by design, autoencoder.cpp:169).
      hin_s: ``[M, h, w]`` cropped hidden feature maps.
      f: ``[D, M, Nk, Nl]`` decoder kernels.
      impl: 'transpose' (default) — three transposed convs via
        jax.linear_transpose, 77 MFLOP / ~5 MB at 128² (measured: the old
        3×jax.grad closures compile to the SAME 3-conv HLO after DCE, so
        this is a clarity win, not a speed win — the step is
        dispatch-bound, not compute-bound).  'patches'
        materializes tap-window patches and forms the gradients as
        long-contraction matmuls; it moves ~16× more HBM bytes and
        measured slower — kept as a tested alternative formulation.
    """
    D, Nx, Ny = in_s.shape
    M = hin_s.shape[0]
    Norm = float(D * M * nk * nl * Nx * Ny)
    E = out_s - in_s

    if impl == "patches":
        # δh[m] = Σ_{d',k,l} f[d',m,k,l]·E[d', ·+ik0+k, ·+il0+l]
        # df[d',m,k,l] = Σ_ab hin[m,ab]·E[d', a+ik0+k, b+il0+l]
        # dc[m,d,k,l]  = Σ_ab in[d,ab]·δh[m, a+ik0+k, b+il0+l]
        if tap_mode == "ref_cpu":
            # the strict `i-ik > 0` bound (netlib.cpp:344) masks the conv
            # *inputs*' row/col 0; transposes inherit the diagonal mask
            in_s = in_s.at[:, 0, :].set(0.0).at[:, :, 0].set(0.0)
            hin_s = hin_s.at[:, 0, :].set(0.0).at[:, :, 0].set(0.0)
        PE = _transpose_patches(E, nk, nl, tap_mode)         # [D,P,Nx,Ny]
        fp = f.reshape(D, M, nk * nl)
        delta_h = jnp.einsum("dmp,dpab->mab", fp, PE,
                             precision=lax.Precision.HIGHEST)
        if tap_mode == "ref_cpu":
            delta_h = delta_h.at[:, 0, :].set(0.0).at[:, :, 0].set(0.0)
        Pd = _transpose_patches(delta_h, nk, nl, tap_mode)   # [M,P,Nx,Ny]
        dc = jnp.einsum("dab,mpab->mdp", in_s, Pd,
                        precision=lax.Precision.HIGHEST).reshape(M, D, nk, nl)
        df = jnp.einsum("mab,dpab->dmp", hin_s, PE,
                        precision=lax.Precision.HIGHEST).reshape(D, M, nk, nl)
    else:
        # three transposed convs via jax.linear_transpose (no primal
        # forwards — the maps are linear)
        conv_h = lambda h: coord.conv2d(h[None], f, None, tap_mode=tap_mode,
                                        scale_by_dm=False)[0]
        conv_cw = lambda cc: coord.conv2d(in_s[None], cc, None,
                                          tap_mode=tap_mode,
                                          scale_by_dm=False)[0]
        conv_fw = lambda ff: coord.conv2d(hin_s[None], ff, None,
                                          tap_mode=tap_mode,
                                          scale_by_dm=False)[0]
        (delta_h,) = jax.linear_transpose(conv_h, hin_s)(E)
        (dc,) = jax.linear_transpose(
            conv_cw,
            jax.ShapeDtypeStruct((M, D, nk, nl), in_s.dtype))(delta_h)
        (df,) = jax.linear_transpose(conv_fw, f)(E)
    dc = dc / Norm
    df = df / Norm
    db = jnp.sum(delta_h, axis=(-2, -1)) / Norm
    dp = jnp.sum(E, axis=(-2, -1)) / Norm
    return CoordGrads(dc=dc, df=df, db=db, dp=dp)


class CoordStepResult(NamedTuple):
    c: jax.Array
    f: jax.Array
    b: jax.Array
    p: jax.Array
    mom: tuple          # (Dc, Df, Db, Dp)
    prev_grad: tuple    # (ddc, ddf, ddb, ddp) for the adaptive-lr rule
    mse: jax.Array      # the printed coord mse (backproplib.cu:356)


@functools.partial(jax.jit,
                   static_argnames=("tap_mode", "sym", "active"))
def coord_step(in_s: jax.Array, out_s: jax.Array, hin_s: jax.Array,
               c: jax.Array, f: jax.Array, b: jax.Array, p: jax.Array,
               mom: tuple, prev_grad: tuple, *,
               lr: float = 0.2, alpha: float = 0.9,
               tap_mode: TapMode = "ref_gpu", sym: bool = False,
               active: bool = False) -> CoordStepResult:
    """One coordinate-space train step on the selected stage pair.

    ``sym=False``: ``backprop_gpu`` (backproplib.cu:291-418) — untied c and f.
    ``sym=True``: ``backprop_gpu_cc`` (521-644) — the c and f gradients are
    folded (Norm doubled, line 533), only c is updated, and f is re-tied to
    ``cᵀ`` (line 622).  Biases remain independently trained.
    """
    dM, dD, nk, nl = c.shape
    g = coord_ref_gradients(in_s, out_s, hin_s, f, nk, nl, tap_mode=tap_mode)
    from ..losses.losses import mse_coord
    mse = mse_coord(in_s, out_s, dM, nk, nl)
    return _apply_update(g, mse, c, f, b, p, mom, prev_grad,
                         lr=lr, alpha=alpha, sym=sym, active=active)


def _apply_update(g: CoordGrads, mse, c, f, b, p, mom, prev_grad, *,
                  lr, alpha, sym, active) -> CoordStepResult:
    Dc, Df, Db, Dp = mom
    ddc, ddf, ddb, ddp = prev_grad
    if sym:
        gc = 0.5 * (g.dc + jnp.transpose(g.df, (1, 0, 2, 3)))
        gb, gp = 0.5 * g.db, 0.5 * g.dp
        c, Dc, ddc = normalized_momentum_update(c, gc, Dc, ddc, lr, alpha,
                                                active=active)
        b, Db, ddb = normalized_momentum_update(b, gb, Db, ddb, lr, alpha,
                                                active=active)
        p, Dp, ddp = normalized_momentum_update(p, gp, Dp, ddp, lr, alpha,
                                                active=active)
        f = jnp.transpose(c, (1, 0, 2, 3))
        mse = mse / 2.0  # Norm doubled in the cc variant (line 533)
    else:
        c, Dc, ddc = normalized_momentum_update(c, g.dc, Dc, ddc, lr, alpha,
                                                active=active)
        f, Df, ddf = normalized_momentum_update(f, g.df, Df, ddf, lr, alpha,
                                                active=active)
        b, Db, ddb = normalized_momentum_update(b, g.db, Db, ddb, lr, alpha,
                                                active=active)
        p, Dp, ddp = normalized_momentum_update(p, g.dp, Dp, ddp, lr, alpha,
                                                active=active)
    return CoordStepResult(c=c, f=f, b=b, p=p,
                           mom=(Dc, Df, Db, Dp),
                           prev_grad=(ddc, ddf, ddb, ddp), mse=mse)


@functools.partial(jax.jit,
                   static_argnames=("tap_mode", "sym", "active",
                                    "axis_name"))
def coord_step_dp(in_b: jax.Array, out_b: jax.Array, hin_b: jax.Array,
                  c: jax.Array, f: jax.Array, b: jax.Array, p: jax.Array,
                  mom: tuple, prev_grad: tuple, *,
                  lr: float = 0.2, alpha: float = 0.9,
                  tap_mode: TapMode = "ref_gpu", sym: bool = False,
                  active: bool = False,
                  axis_name: str | None = None) -> CoordStepResult:
    """Batched coordinate-space step: reference-exact gradients averaged
    over a batch of frames (the coord analog of ``fft_burst_dp``).

    The reference coord trainer is batch-of-one and dispatch-bound (77
    MFLOP at 128²); batching B frames into one step amortizes the
    dispatch while keeping reference update semantics.  At B=1 it equals
    :func:`coord_step` exactly.  Inside ``shard_map`` with the batch sharded
    over ``axis_name``, the (tiny) averaged gradients are ``pmean``-ed each
    step — the same collective pattern as the distributed burst.
    """
    dM, dD, nk, nl = c.shape
    # under shard_map (axis_name set), the 'transpose' impl's
    # jax.linear_transpose w.r.t. the *replicated* kernel arg auto-inserts
    # a hidden psum over the data axis (an unvarying input's cotangent must
    # be unvarying), double-counting the batch; the einsum-only 'patches'
    # formulation has no transposition and stays per-shard
    impl = "patches" if axis_name is not None else "transpose"
    grads = jax.vmap(
        lambda i, o, h: coord_ref_gradients(i, o, h, f, nk, nl,
                                            tap_mode=tap_mode, impl=impl)
    )(in_b, out_b, hin_b)
    g = jax.tree.map(lambda t: jnp.mean(t, axis=0), grads)
    mse = jnp.mean(
        jnp.sum((in_b - out_b) ** 2, axis=(-3, -2, -1))
    ) / (dD * dM * nk * nl * in_b.shape[-2] * in_b.shape[-1])
    if axis_name is not None:
        g = jax.tree.map(lambda t: lax.pmean(t, axis_name), g)
        mse = lax.pmean(mse, axis_name)
    return _apply_update(g, mse, c, f, b, p, mom, prev_grad,
                         lr=lr, alpha=alpha, sym=sym, active=active)


def distributed_coord_step(mesh, *, lr: float = 0.2, alpha: float = 0.9,
                           tap_mode: TapMode = "ref_gpu", sym: bool = False,
                           active: bool = False):
    """Build a jitted multi-chip coord step: frame batch sharded over
    'data', params replicated, gradients pmean-ed over the mesh — the coord
    analog of :func:`spectralae.train.fft_dp.distributed_burst`.

    The per-step collective moves ``M·D·Nk·Nl·2 + M + D`` floats (the
    averaged gradient tensors), nothing resolution-sized.
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    batch = P("data", None, None, None)
    rep = P()

    def local(in_b, out_b, hin_b, c, f, b, p, mom, prev_grad):
        return coord_step_dp(in_b, out_b, hin_b, c, f, b, p, mom,
                             prev_grad, lr=lr, alpha=alpha,
                             tap_mode=tap_mode, sym=sym, active=active,
                             axis_name="data")

    rep4 = (rep, rep, rep, rep)
    sharded = shard_map(
        local, mesh=mesh,
        in_specs=(batch, batch, batch, rep, rep, rep, rep, rep4, rep4),
        out_specs=CoordStepResult(c=rep, f=rep, b=rep, p=rep, mom=rep4,
                                  prev_grad=rep4, mse=rep))

    @jax.jit
    def run(in_b, out_b, hin_b, c, f, b, p, mom=None, prev_grad=None):
        zeros = lambda: (jnp.zeros_like(c), jnp.zeros_like(f),
                         jnp.zeros_like(b), jnp.zeros_like(p))
        return sharded(in_b, out_b, hin_b, c, f, b, p,
                       mom if mom is not None else zeros(),
                       prev_grad if prev_grad is not None else zeros())

    return run
