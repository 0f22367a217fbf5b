"""Batched whole-network training — the production path.

The reference trains one stage pair at a time on a single frame.  This path
generalizes to: batched frames, all stages trained jointly (or a selected
pair via ``train_pair``), gradients by autodiff through the full forward in
either domain, and the reference's normalized-gradient inertia optimizer.
It is the unit the distribution layer shards over the device mesh
(:mod:`spectralae.dist.mesh`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.types import AEParams, OptState
from ..model import autoencoder as model
from ..optim.update import tree_update


class TrainStepResult(NamedTuple):
    params: AEParams
    opt: OptState
    loss: jax.Array


def reconstruction_loss(params: AEParams, x: jax.Array, scales, *,
                        domain: str = "fft", tap_mode: str = "centered",
                        scale_by_dm: bool = True, act=None,
                        compute_dtype=None, remat: bool = False) -> jax.Array:
    """½·mean squared reconstruction error over the batch.

    ``compute_dtype=jnp.bfloat16`` runs the forward in bf16
    with fp32 params/loss — the production mixed-precision path.  In the
    fft domain the FFTs stay f32 (XLA requirement) and the pointwise convs
    stream bf16 operands with f32 accumulation.  ``act`` applies only in
    the coordinate domain (the spectral forward is linear by construction;
    the reference's activation is identity there too, backproplib.cu:38-44).
    ``remat`` checkpoints per-stage blocks (see the forwards' docstrings).
    """
    x32 = x.astype(jnp.float32)   # full-precision target in BOTH domains
    if domain == "fft":
        out = model.forward_fft(params, x, scales, scale_by_dm=scale_by_dm,
                                compute_dtype=compute_dtype, remat=remat)
    else:
        if compute_dtype is not None:
            params = jax.tree.map(lambda t: t.astype(compute_dtype), params)
            x = x.astype(compute_dtype)
        out = model.forward_coord(params, x, scales, tap_mode=tap_mode,
                                  scale_by_dm=scale_by_dm, act=act,
                                  remat=remat)[-1]
    return 0.5 * jnp.mean((out.astype(jnp.float32) - x32) ** 2)


def _accumulated_loss_and_grads(params, x, scales, accum_steps, **loss_kw):
    """Loss and grads microbatched over ``accum_steps`` sequential chunks.

    ``lax.scan`` over equal batch chunks keeps peak activation memory at
    one chunk's worth while averaging to (numerically) the full-batch
    gradient — the standard large-batch trick on memory-bound configs.
    """
    b = x.shape[0]
    if b % accum_steps:
        raise ValueError(
            f"batch {b} not divisible by accum_steps {accum_steps}")
    xs = x.reshape(accum_steps, b // accum_steps, *x.shape[1:])
    gfn = jax.value_and_grad(reconstruction_loss)

    def body(carry, xc):
        lsum, gsum = carry
        l, g = gfn(params, xc, scales, **loss_kw)
        g = jax.tree.map(lambda a, s: s + a.astype(jnp.float32), g, gsum)
        return (lsum + l, g), None

    zeros = jax.tree.map(lambda t: jnp.zeros(t.shape, jnp.float32), params)
    (lsum, gsum), _ = jax.lax.scan(body, (jnp.float32(0.0), zeros), xs)
    inv = 1.0 / accum_steps
    return lsum * inv, jax.tree.map(lambda t: t * inv, gsum)


def _mask_grads(grads: AEParams, params: AEParams, train_pair: int) -> AEParams:
    """Zero gradients of all but the selected encoder/decoder stage pair —
    the reference's per-layer training focus (autoencoder.cpp:161-201)."""
    n = params.n_stages
    stages = []
    for i, g in enumerate(grads.stages):
        keep = i == train_pair or i == n - 1 - train_pair
        stages.append(jax.tree.map(lambda t: t if keep else jnp.zeros_like(t), g)
                      if not keep else g)
    return AEParams(stages=tuple(stages))


@functools.partial(
    jax.jit,
    static_argnames=("scales", "domain", "tap_mode", "scale_by_dm",
                     "train_pair", "active", "act", "compute_dtype",
                     "remat", "accum_steps"))
def train_step(params: AEParams, opt: OptState, x: jax.Array,
               scales: tuple, *, lr: float = 0.2, alpha: float = 0.9,
               domain: str = "fft", tap_mode: str = "centered",
               scale_by_dm: bool = True, train_pair: int = -1,
               active: bool = False, act=None,
               compute_dtype=None, remat: bool = False,
               accum_steps: int = 1) -> TrainStepResult:
    """One batched train step.

    Args:
      x: ``[B, D, Nx, Ny]`` batch of frames.
      scales: static per-stage pooling scales (NetSpec.scales).
      train_pair: ``-1`` trains all stages; ``n`` trains only pair ``n``.
      remat: per-stage rematerialization (memory for recompute).
      accum_steps: gradient accumulation over ``accum_steps`` microbatches
        (batch must divide evenly); one optimizer update per call.
    """
    loss_kw = dict(domain=domain, tap_mode=tap_mode,
                   scale_by_dm=scale_by_dm, act=act,
                   compute_dtype=compute_dtype, remat=remat)
    if accum_steps > 1:
        loss, grads = _accumulated_loss_and_grads(
            params, x, scales, accum_steps, **loss_kw)
    else:
        loss, grads = jax.value_and_grad(reconstruction_loss)(
            params, x, scales, **loss_kw)
    grads = jax.tree.map(lambda g: g.astype(jnp.float32), grads)
    if train_pair >= 0:
        grads = _mask_grads(grads, params, train_pair)
    new_params, new_mom, new_pg = tree_update(
        params, grads, opt.mom, opt.prev_grad, lr, alpha, active=active)
    return TrainStepResult(params=new_params,
                           opt=OptState(mom=new_mom, prev_grad=new_pg),
                           loss=loss)


def make_optax_train_step(optimizer, *, domain: str = "fft",
                          tap_mode: str = "centered",
                          scale_by_dm: bool = True, train_pair: int = -1,
                          act=None, compute_dtype=None,
                          remat: bool = False, accum_steps: int = 1):
    """Build a jitted train step around any optax GradientTransformation.

    The reference-semantics optimizer (normalized-gradient inertia) stays
    the default in :func:`train_step`; this is the pluggable production
    alternative — Adam/AdamW/SGD + schedules, weight decay, clipping, etc.
    compose via optax chains.  ``AEParams`` is a pytree, so optax state and
    updates follow its structure.

    Returns ``step(params, opt_state, x, scales) -> TrainStepResult``;
    initialize ``opt_state = optimizer.init(params)``.
    """
    import optax

    loss_kw = dict(domain=domain, tap_mode=tap_mode,
                   scale_by_dm=scale_by_dm, act=act,
                   compute_dtype=compute_dtype, remat=remat)

    @functools.partial(jax.jit, static_argnames=("scales",))
    def step(params, opt_state, x, scales) -> TrainStepResult:
        if accum_steps > 1:
            loss, grads = _accumulated_loss_and_grads(
                params, x, scales, accum_steps, **loss_kw)
        else:
            loss, grads = jax.value_and_grad(reconstruction_loss)(
                params, x, scales, **loss_kw)
        grads = jax.tree.map(lambda g: g.astype(jnp.float32), grads)
        if train_pair >= 0:
            grads = _mask_grads(grads, params, train_pair)
        updates, new_state = optimizer.update(grads, opt_state, params)
        new_params = optax.apply_updates(params, updates)
        return TrainStepResult(params=new_params, opt=new_state, loss=loss)

    return step


def make_optimizer(name: str, lr: float, *, schedule: str = "constant",
                   warmup_steps: int = 0, total_steps: int = 0,
                   end_lr_frac: float = 0.0):
    """Named optax optimizers for the CLI (``--optimizer``).

    ``schedule``: 'constant', 'cosine' (cosine decay to
    ``end_lr_frac·lr`` over ``total_steps``), or 'linear'; any schedule
    composes with ``warmup_steps`` of linear warmup from 0.
    """
    import optax
    sched: float | optax.Schedule
    if schedule == "constant":
        sched = lr
        if warmup_steps:
            sched = optax.schedules.linear_schedule(0.0, lr, warmup_steps)
    elif schedule in ("cosine", "linear"):
        if total_steps <= 0:
            raise ValueError(f"schedule={schedule!r} needs total_steps>0 "
                             "(the CLI passes --steps)")
        decay = max(1, total_steps - warmup_steps)
        if schedule == "cosine":
            body = optax.schedules.cosine_decay_schedule(
                lr, decay, alpha=end_lr_frac)
        else:
            body = optax.schedules.linear_schedule(lr, lr * end_lr_frac,
                                                   decay)
        if warmup_steps:
            sched = optax.schedules.join_schedules(
                [optax.schedules.linear_schedule(0.0, lr, warmup_steps),
                 body], [warmup_steps])
        else:
            sched = body
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    if name == "adam":
        return optax.adam(sched)
    if name == "adamw":
        return optax.adamw(sched)
    if name == "sgd":
        return optax.sgd(sched, momentum=0.9)
    raise ValueError(f"unknown optimizer {name!r} "
                     "(choose adam, adamw, or sgd)")
