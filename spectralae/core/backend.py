"""The one place that chooses an algorithm by backend.

Every routing decision of the package checks the backend from
``jax.default_backend()`` here, and nowhere else:

- :func:`burst_body` — which momentum-space burst body ``auto_burst``
  (train/fft_corr.py) and ``fft_burst_dp`` (train/fft_dp.py) run;
- :func:`spectral_conv_impl` — how ``spectral_conv`` (ops/spectral.py)
  evaluates the pointwise complex-multiply conv.

Two backends are known, and both take the choices measured on the GPU
(CHANGES.md): ``"gpu"`` (an NVIDIA card through XLA's CUDA backend) and
``"cpu"`` (tests and rehearsal, which so run the card's code).  Any other
backend is an error that names it, never a silent default.
"""

from __future__ import annotations

import jax

BACKENDS = ("gpu", "cpu")


def backend(name: str | None = None) -> str:
    """``name`` or the default JAX backend, checked against the table."""
    name = jax.default_backend() if name is None else name
    if name not in BACKENDS:
        raise RuntimeError(
            f"spectralae has no routing for backend {name!r}; "
            f"known backends: {', '.join(BACKENDS)}")
    return name


def burst_body(name: str | None = None) -> str:
    """The burst body: ``"corr"``, the correlation-space body
    (train/fft_corr.py — one precompute, then resolution-independent
    iterations), faster on the GPU than the ω-space body (train/fft.py,
    four FFT-sized passes per iteration) at every frame size measured."""
    backend(name)
    return "corr"


def spectral_conv_impl(compute_dtype=None, name: str | None = None) -> str:
    """How ``spectral_conv`` evaluates: ``"split"``, re/im
    broadcast-multiply-sums that XLA fuses with their neighbours (the
    fastest batched autodiff step on the GPU, ahead of the einsum and of a
    Pallas kernel on the Triton route); ``"einsum"`` for reduced-precision
    operand streaming (``compute_dtype``), which the split form lacks."""
    backend(name)
    return "split" if compute_dtype is None else "einsum"
