"""Every dot and conv of the f32 main path states full f32 precision.

On the GPU a DEFAULT-precision f32 ``dot_general`` or conv may run in TF32
(about three decimal digits).  Each entry point's jaxpr — including its
loop bodies, scans, shard_map bodies and (for the trainers) the backward
pass — is walked, and every ``dot_general`` / ``conv_general_dilated``
must carry ``Precision.HIGHEST`` on both operands.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.lax import Precision

from spectralae.core.config import Config, LayerParams
from spectralae.core.types import initial_spec, init_opt_state, init_params
from spectralae.model import autoencoder as model
from spectralae.ops import dft, spectral

_OPS = ("dot_general", "conv_general_dilated")


def _sub_jaxprs(v):
    if hasattr(v, "eqns"):
        yield v
    elif hasattr(v, "jaxpr") and hasattr(v.jaxpr, "eqns"):
        yield v.jaxpr
    elif isinstance(v, (tuple, list)):
        for u in v:
            yield from _sub_jaxprs(u)


def matmul_precisions(jaxpr):
    """(primitive name, precision param) of every dot/conv, recursively."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name in _OPS:
            out.append((eqn.primitive.name, eqn.params.get("precision")))
        for v in eqn.params.values():
            for sub in _sub_jaxprs(v):
                out.extend(matmul_precisions(sub))
    return out


def _is_highest(p):
    if isinstance(p, tuple):
        return all(q == Precision.HIGHEST for q in p)
    return p == Precision.HIGHEST


def _net(nx=16, pairs=2, scale=2):
    layer = LayerParams(depth=4, lk=1, ll=1, scale=scale, rmax=0.5)
    spec = initial_spec(Config(nx=nx, ny=nx, d=3, layer=layer))
    for _ in range(pairs - 1):
        spec = spec.add_pair(layer)
    return spec, init_params(jax.random.key(0), spec, 0.5)


def _frames(*shape):
    return jnp.asarray(np.random.default_rng(0).normal(
        size=shape).astype(np.float32))


def _entry_points():
    from spectralae.train.coord import coord_step
    from spectralae.train.fft import fft_burst
    from spectralae.train.fft_corr import fft_burst_corr
    from spectralae.train.fft_dp import fft_burst_dp
    from spectralae.train.modern import train_step
    from spectralae.train.streaming import fft_stream

    spec, params = _net()
    spec1, params1 = _net(pairs=1, scale=1)
    enc, dec = params1.pair(0)
    kargs = (enc.c, dec.c, enc.b, dec.b)
    x = _frames(2, 3, 16, 16)
    opt = init_opt_state(params)
    mom = tuple(jnp.zeros_like(t) for t in kargs)
    return {
        "forward_fft": lambda: model.forward_fft(params, x, spec.scales),
        "forward_coord": lambda: model.forward_coord(params, x,
                                                     spec.scales)[-1],
        "encode_fft": lambda: model.encode(params, x, spec.scales),
        "train_step_fft": lambda: train_step(params, opt, x, spec.scales,
                                             domain="fft"),
        "train_step_coord": lambda: train_step(params, opt, x, spec.scales,
                                               domain="coord"),
        "burst_corr": lambda: fft_burst_corr(x[0], None, x[0], *kargs,
                                             iters=3),
        "burst_corr_fused": lambda: fft_burst_corr(x[0], None, None, *kargs,
                                                   iters=3,
                                                   reanchor_every=2),
        "burst_omega_dft": lambda: fft_burst(x[0], x[0], x[0], *kargs,
                                             iters=3, impl="dft"),
        "burst_omega_fft": lambda: fft_burst(x[0], x[0], x[0], *kargs,
                                             iters=3, impl="fft"),
        "burst_dp_omega": lambda: fft_burst_dp(x, None, x, *kargs, iters=3,
                                               body="omega"),
        "stream": lambda: fft_stream(x[:, None], *kargs, iters=3),
        "coord_step": lambda: coord_step(x[0], x[0], _frames(4, 16, 16),
                                         *kargs, mom, mom),
        "kernel_transforms": lambda: dft.kernel_project(
            dft.kernel_spectrum(enc.c, 16, 16), 3, 3, 16, 16),
        "spectral_conv": lambda: spectral.spectral_conv_einsum(
            jnp.fft.rfft2(x), dft.kernel_spectrum(enc.c, 16, 16), enc.b,
            16, 16),
    }


ENTRY_POINTS = ["burst_corr", "burst_corr_fused", "burst_dp_omega",
                "burst_omega_dft", "burst_omega_fft", "coord_step",
                "encode_fft", "forward_coord", "forward_fft",
                "kernel_transforms", "spectral_conv", "stream",
                "train_step_coord", "train_step_fft"]


def test_entry_point_list_is_complete():
    assert sorted(_entry_points()) == ENTRY_POINTS


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_every_matmul_is_highest(name):
    jaxpr = jax.make_jaxpr(_entry_points()[name])().jaxpr
    found = matmul_precisions(jaxpr)
    assert found, f"{name}: no dot/conv found — the walk is broken"
    bad = [f for f in found if not _is_highest(f[1])]
    assert not bad, (f"{name}: {len(bad)} of {len(found)} not HIGHEST: "
                     f"{bad[:3]}")


def test_walker_sees_an_unpinned_dot():
    """The check is not vacuous: a default-precision einsum is reported."""
    jaxpr = jax.make_jaxpr(lambda a: jnp.einsum("ij,jk->ik", a, a))(
        jnp.ones((2, 2))).jaxpr
    (found,) = matmul_precisions(jaxpr)
    assert not _is_highest(found[1])
