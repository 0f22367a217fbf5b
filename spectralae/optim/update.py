"""The reference's optimizer as composable JAX updates.

Update rule (used identically in every training path of the reference —
backproplib.cu:392-396, 620-621; fft_backproplib.cu:616-617):

    dw ← (1−α)·lr·g / max(|g|, 10) + α·dw_prev
    w  ← w − dw

i.e. momentum ("inertia") over a normalized/clipped gradient.  The adaptive
learning rate ``lr = |Δw_prev / Δg|`` exists in the reference but is dead code
(``del=delmax`` unconditionally re-applied, backproplib.cu:34; device variants
commented out at fft_backproplib.cu:615-623).  Here the *intended* rule is
implemented behind ``active=True`` and the reference behavior is
``active=False`` (the default), per SURVEY.md §7 "reference quirks".
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp


GRAD_CLIP = 10.0  # the max(|g|, 10) normalization floor


class UpdateResult(NamedTuple):
    w: jax.Array
    mom: jax.Array
    prev_grad: jax.Array


def normalized_momentum_update(w: jax.Array, g: jax.Array, mom: jax.Array,
                               prev_grad: jax.Array, lr: float | jax.Array,
                               alpha: float | jax.Array, *,
                               active: bool = False) -> UpdateResult:
    """One inertia step on a single tensor; returns (w', mom', prev_grad')."""
    if active:
        # Intended adaptive rule: per-weight secant step |Δw / Δg|, capped at
        # the keyboard-set lr (cf. adapt_rate, backproplib.cu:28-35).
        # Bootstrap: with zero momentum (fresh start / after a layer-focus
        # reset) the secant numerator is 0 and would freeze training
        # forever — fall back to the plain lr until momentum exists.
        dg = g - prev_grad
        lr_eff = jnp.where((dg != 0) & (mom != 0),
                           jnp.abs(mom / jnp.where(dg == 0, 1, dg)),
                           lr)
        lr_eff = jnp.minimum(lr_eff, lr)
    else:
        lr_eff = lr
    dw = (1.0 - alpha) * lr_eff * g / jnp.maximum(jnp.abs(g), GRAD_CLIP) \
        + alpha * mom
    return UpdateResult(w - dw, dw, g)


def tree_update(params, grads, moms, prev_grads, lr, alpha, *, active=False):
    """Apply the update across a pytree; returns (params', moms', prev_grads')."""
    flat_w, treedef = jax.tree.flatten(params)
    flat_g = treedef.flatten_up_to(grads)
    flat_m = treedef.flatten_up_to(moms)
    flat_pg = treedef.flatten_up_to(prev_grads)
    out = [normalized_momentum_update(w, g, m, pg, lr, alpha, active=active)
           for w, g, m, pg in zip(flat_w, flat_g, flat_m, flat_pg)]
    new_w = treedef.unflatten([o.w for o in out])
    new_m = treedef.unflatten([o.mom for o in out])
    new_pg = treedef.unflatten([o.prev_grad for o in out])
    return new_w, new_m, new_pg


def burst_inertia(w: jax.Array, g: jax.Array, mom: jax.Array,
                  lr_eff: float, alpha: float, scale=None):
    """The burst weight update (``backprop_d``, fft_backproplib.cu:605-652):
    normalized/clipped gradient with inertia, effective lr already scaled
    (the reference burst uses ``0.1·del``).  Shared by every jnp-level
    burst body so the clipping rule lives in ONE place.

    ``scale``: optional per-entry rescale of the clipped step (not the
    momentum) — the extended-tape corr body uses it to convert the
    reference-scale gradient step to entry scale and to freeze the
    constant-maker entries (zero scale).

    Returns ``(new_w, new_mom)``.
    """
    step = (1.0 - alpha) * lr_eff * g / jnp.maximum(jnp.abs(g), GRAD_CLIP)
    if scale is not None:
        step = scale * step
    dw = step + alpha * mom
    return w - dw, dw
