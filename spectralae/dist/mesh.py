"""Device mesh + sharding layer: SPMD data/model parallelism.

The reference is strictly single-device (SURVEY.md §2.9 — no DP/TP/PP, no
communication backend).  These are *new* first-class components: a
``jax.sharding.Mesh`` with named axes, ``NamedSharding`` annotations on the
batch and (optionally) the feature dimension of kernels, and XLA-inserted
collectives (NCCL over NVLink between GPUs).  No hand-written communication
layer.  The mesh follows the algorithm, not a physical topology.

Axes:
  - ``data``:  batch dimension of frames (DP; gradients psum-reduced by XLA).
  - ``model``: the M (feature-map) dimension of the spectral pointwise conv
    (TP; the Σ_d contraction shards over m with an all-gather-free layout,
    and the decoder-side contraction over m becomes a reduce-scatter/psum,
    all chosen by the partitioner).
"""

from __future__ import annotations

import functools
from typing import Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.types import AEParams, ConvStage, OptState


def make_mesh(n_data: int | None = None, n_model: int = 1,
              devices: Sequence[jax.Device] | None = None) -> Mesh:
    """Build a ('data', 'model') mesh over the available devices."""
    devices = list(devices if devices is not None else jax.devices())
    if n_data is None:
        # max(1, ...): n_model > device count would otherwise give
        # n_data = 0, a zero-device mesh that skips the error below and
        # fails opaquely at the first sharded computation
        n_data = max(1, len(devices) // n_model)
    need = n_data * n_model
    if len(devices) < need:
        raise ValueError(
            f"make_mesh needs {need} devices for a {n_data}x{n_model} "
            f"(data, model) mesh but only {len(devices)} are available. "
            "For a virtual multi-device run on CPU set JAX_PLATFORMS=cpu and "
            f"XLA_FLAGS=--xla_force_host_platform_device_count={need} before "
            "backend init (see tests/conftest.py).")
    devs = np.asarray(devices[:need]).reshape(n_data, n_model)
    return Mesh(devs, axis_names=("data", "model"))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Frames sharded over the data axis: ``[B, D, H, W]`` → B split."""
    return NamedSharding(mesh, P("data", None, None, None))


def stage_sharding(mesh: Mesh, stage: ConvStage) -> ConvStage:
    """Shard a stage's kernels over the model axis on M when it divides."""
    sh = _stage_shardings(mesh, stage)
    return ConvStage(c=jax.device_put(stage.c, sh.c),
                     b=jax.device_put(stage.b, sh.b))


def shard_params(params: AEParams, mesh: Mesh) -> AEParams:
    """Place parameters on the mesh (replicated over data, M-sharded over
    model where divisible)."""
    return AEParams(stages=tuple(stage_sharding(mesh, s)
                                 for s in params.stages))


def _stage_shardings(mesh: Mesh, stage: ConvStage) -> ConvStage:
    """The shardings :func:`stage_sharding` would use, without placing
    any data (M-sharded over 'model' where divisible, else replicated)."""
    n_model = mesh.shape["model"]
    if n_model > 1 and stage.c.shape[0] % n_model == 0:
        return ConvStage(c=NamedSharding(mesh, P("model", None, None, None)),
                         b=NamedSharding(mesh, P("model")))
    return ConvStage(c=NamedSharding(mesh, P()), b=NamedSharding(mesh, P()))


def shard_opt_state(opt: OptState, params: AEParams, mesh: Mesh) -> OptState:
    shardings = AEParams(stages=tuple(_stage_shardings(mesh, s)
                                      for s in params.stages))
    return OptState(
        mom=jax.tree.map(jax.device_put, opt.mom, shardings),
        prev_grad=jax.tree.map(jax.device_put, opt.prev_grad, shardings))


def shard_batch(x: jax.Array | np.ndarray, mesh: Mesh) -> jax.Array:
    return jax.device_put(x, batch_sharding(mesh))


def grid_sharding(mesh: Mesh) -> NamedSharding:
    """Spectra ``[B, C, Nx, Nyr]`` with the frequency-grid rows sharded
    over 'model' — spatial parallelism for resolutions whose working set
    exceeds one chip's HBM (SURVEY.md §5.7)."""
    return NamedSharding(mesh, P(None, None, "model", None))


def spatial_forward(mesh: Mesh, scales, *, scale_by_dm: bool = True):
    """Jitted momentum-space forward with every stage's spectrum
    constrained to shard its grid rows over the 'model' axis.

    The pointwise spectral conv (the resolution-scaling op) then runs
    fully sharded; XLA inserts the FFT-boundary collectives (the 2-D FFT
    itself needs whole transform axes).  Batch stays sharded over 'data'.
    """
    from ..model.autoencoder import forward_fft

    def constrain(X):
        nm = mesh.shape["model"]
        if X.shape[-2] % nm:
            return X  # sub-grid stage no longer divisible — keep local
        return jax.lax.with_sharding_constraint(
            X, NamedSharding(mesh, P("data", None, "model", None)))

    @jax.jit
    def fwd(params, x):
        x = jax.lax.with_sharding_constraint(x, batch_sharding(mesh))
        return forward_fft(params, x, scales, scale_by_dm=scale_by_dm,
                           constrain=constrain)

    return fwd


def distributed_train_step(mesh: Mesh):
    """Return a jitted DP/TP train step bound to ``mesh``.

    Gradients reduce over 'data' and activations/kernels shard over 'model'
    purely through sharding propagation — XLA inserts the psum/all-gather
    collectives (SURVEY.md §5.8).
    """
    from ..train.modern import train_step

    @functools.partial(jax.jit,
                       static_argnames=("scales", "domain", "tap_mode",
                                        "scale_by_dm", "train_pair", "active"))
    def step(params, opt, x, scales, *, lr=0.2, alpha=0.9, domain="fft",
             tap_mode="centered", scale_by_dm=True, train_pair=-1,
             active=False):
        x = jax.lax.with_sharding_constraint(x, batch_sharding(mesh))
        return train_step(params, opt, x, scales, lr=lr, alpha=alpha,
                          domain=domain, tap_mode=tap_mode,
                          scale_by_dm=scale_by_dm, train_pair=train_pair,
                          active=active)

    return step
