"""Coordinate-space ops: convolution (three reference tap windows) and pooling.

Design: the reference's hand-written CUDA forward kernel
(``conv_parallel``, source/backproplib.cu:70-111) and host max-pool
(source/netlib.cpp:114-164) become a ``lax.conv_general_dilated`` (cuDNN on
the GPU, at full f32 precision) and a block-max that XLA fuses.  The
reference's quirky *off-center* tap windows are reproduced exactly via
asymmetric padding (see :func:`spectralae.core.config.tap_anchor`).

All ops take batched ``[B, C, H, W]`` activations; the reference's batch-of-one
camera loop is the ``B=1`` special case.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..core.config import TapMode, tap_anchor


def _conv_padding(nk: int, nl: int, mode: TapMode) -> tuple[tuple[int, int], tuple[int, int]]:
    """Asymmetric SAME padding implementing ``out[i] = Σ_k c[k]·in[i-(ik0+k)]``.

    With the kernel flipped, lax correlation gives
    ``out[i] = Σ_k c[Nk-1-k]·in[i + k - lo]``; choosing ``lo = ik0 + Nk - 1``
    reproduces the reference tap window for any anchor ``ik0``.
    """
    ik0 = tap_anchor(nk, mode)
    il0 = tap_anchor(nl, mode)
    lo_k = ik0 + nk - 1
    lo_l = il0 + nl - 1
    return (lo_k, nk - 1 - lo_k), (lo_l, nl - 1 - lo_l)


def conv2d(x: jax.Array, c: jax.Array, b: jax.Array | None = None, *,
           tap_mode: TapMode = "centered", scale_by_dm: bool = True,
           act=None) -> jax.Array:
    """Reference-semantics 2-D convolution.

    Args:
      x: ``[B, D, H, W]`` input activations.
      c: ``[M, D, Nk, Nl]`` kernels (reference layout, netlib.cpp:246).
      b: ``[M]`` biases, added post-conv (backproplib.cu:107).
      tap_mode: which of the reference's tap windows to reproduce.
      scale_by_dm: pre-divide the input by the *output* depth M
        (backproplib.cu:134; the CPU reference ``Conv`` omits this).
      act: activation; ``None`` = identity (the reference's current ``act``,
        backproplib.cu:38-44).

    Reference: ``Conv`` netlib.cpp:318-358 (tap_mode='ref_cpu'),
    ``Conv_gpu``/``conv_parallel`` backproplib.cu:70-182 (tap_mode='ref_gpu').
    """
    m, _, nk, nl = c.shape
    if scale_by_dm:
        x = x / m
    if tap_mode == "ref_cpu":
        # CPU boundary quirk: the bound check is `i-ik > 0` *strictly*
        # (netlib.cpp:344), so input row 0 / col 0 never contribute.
        x = x.at[:, :, 0, :].set(0.0).at[:, :, :, 0].set(0.0)
    w = c[:, :, ::-1, ::-1]  # flip: reference indexing is convolution-like
    pad = _conv_padding(nk, nl, tap_mode)
    # f32 at full precision (a DEFAULT-precision f32 conv may run in TF32
    # on the GPU); reduced-dtype inputs keep their own precision
    prec = lax.Precision.HIGHEST if x.dtype == jnp.float32 else None
    y = lax.conv_general_dilated(
        x, w, window_strides=(1, 1), padding=pad,
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        preferred_element_type=x.dtype, precision=prec)
    if b is not None:
        y = y + b[None, :, None, None]
    if act is not None:
        y = act(y)
    return y


def max_pool(x: jax.Array, scale: int, *,
             quantize: bool = False) -> jax.Array:
    """Max-pool over ``scale×scale`` blocks, implicitly clamped at zero.

    The reference initializes the block max to 0 — and declares it ``int``
    (``int smax=0``, netlib.cpp:127), so each assignment truncates the
    float toward zero: the executed reference computes
    ``floor(max(0, block max))`` (verified bit-level against the compiled
    netlib.cpp in tests/test_reference_binary.py).  ``quantize=True``
    reproduces that exactly; the default keeps full precision — a
    documented quirk-fix (the truncation is an accidental declaration, it
    quantizes activations to integer levels and zeroes sub-1 features).
    Reference: ``Pool`` with scale>0, netlib.cpp:117-140.
    """
    b, c, h, w = x.shape
    blocks = x.reshape(b, c, h // scale, scale, w // scale, scale)
    pooled = jnp.max(blocks, axis=(3, 5))
    pooled = jnp.maximum(pooled, jnp.array(0.0, x.dtype))
    if quantize:
        pooled = jnp.floor(pooled)
    return pooled


def nn_upsample(x: jax.Array, scale: int) -> jax.Array:
    """Nearest-neighbor upsample by ``scale`` (reference: netlib.cpp:141-163)."""
    x = jnp.repeat(x, scale, axis=-2)
    return jnp.repeat(x, scale, axis=-1)


def pool(x: jax.Array, scale: int, *, quantize: bool = False) -> jax.Array:
    """Signed-scale pooling: ``scale>0`` downsample, ``scale<0`` upsample.

    Matches the reference's single ``Pool`` entry point (netlib.cpp:114);
    ``quantize`` selects the executed reference's integer-truncated
    downsample (see :func:`max_pool` — upsampling never truncates).
    """
    if scale > 1:
        return max_pool(x, scale, quantize=quantize)
    if scale < -1:
        return nn_upsample(x, -scale)
    return x


def center_crop(x: jax.Array, q: int) -> jax.Array:
    """Center crop to ``(H/q, W/q)`` — the training patch ``Portion``.

    Reference: netlib.cpp:292-315 (random offset is commented out there too).
    """
    h, w = x.shape[-2], x.shape[-1]
    dh = (h - h // q) // 2
    dw = (w - w // q) // 2
    return x[..., dh:dh + h // q, dw:dw + w // q]


def leaky_relu(x: jax.Array, a: float = 0.01) -> jax.Array:
    """The reference's commented-out activation (backproplib.cu:38-51)."""
    return jnp.where(x > 0, x, a * x)
