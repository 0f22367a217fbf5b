"""Parity against the EXECUTED reference binary (VERDICT r2 item 1).

The reference's CPU translation unit (source/netlib.cpp) is compiled in
place by tests/reference_build.py and driven through flat-array ctypes
entry points (tests/ref_shim.cpp).  Every test here compares this repo's
ops against the *running* reference code, not a transcription —
tests/oracle.py remains as a fast documented fallback, but this file is
the authority for:

  Conv            -> ops.coord.conv2d(tap_mode='ref_cpu')
  backprop        -> train.coord.coord_step(tap_mode='ref_cpu', alpha=0)
  Pool            -> ops.coord.pool (both signs)
  Portion         -> ops.coord.center_crop
  SaveLoad_conv   -> io.checkpoint export_conv/import_conv/conv_filename
                     (byte-for-byte file parity + the filename scheme)
"""

from __future__ import annotations

import os

import numpy as np
import pytest

import jax.numpy as jnp

from spectralae.ops import coord
from spectralae.core.config import half_extent

from tests.reference_build import load_reference_lib, as_ptr

pytestmark = pytest.mark.slow  # compiles the reference netlib.cpp in place


@pytest.fixture(scope="module")
def ref():
    try:
        return load_reference_lib()
    except (RuntimeError, FileNotFoundError) as e:  # pragma: no cover
        pytest.skip(f"reference binary unavailable: {e}")


def _rand(rng, *shape):
    return rng.uniform(-1.0, 1.0, size=shape).astype(np.float32)


# --------------------------------------------------------------- Conv (N8)

@pytest.mark.parametrize("nk,nl", [(3, 3), (5, 5), (5, 3), (7, 7)])
def test_conv_matches_executed_reference(ref, nk, nl):
    rng = np.random.default_rng(hash((nk, nl)) % 2**31)
    D, M, Nx, Ny = 3, 4, 16, 20
    x = _rand(rng, D, Nx, Ny)
    c = _rand(rng, M, D, nk, nl)
    b = _rand(rng, M)
    want = np.empty((M, Nx, Ny), np.float32)
    ref.ref_conv(as_ptr(x), D, Nx, Ny, as_ptr(c), M, nk, nl, as_ptr(b),
                 as_ptr(want))
    got = np.asarray(coord.conv2d(jnp.asarray(x)[None], jnp.asarray(c),
                                  jnp.asarray(b), tap_mode="ref_cpu",
                                  scale_by_dm=False)[0])
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_conv_image_scale_inputs(ref):
    """0..255-range inputs (the reference feeds unnormalized pixels,
    netlib.cpp:46-48) — catches tolerance bugs hidden by small values."""
    rng = np.random.default_rng(7)
    D, M, Nx, Ny = 3, 10, 32, 32
    x = rng.uniform(0, 255, size=(D, Nx, Ny)).astype(np.float32)
    c = _rand(rng, M, D, 5, 5)
    b = _rand(rng, M)
    want = np.empty((M, Nx, Ny), np.float32)
    ref.ref_conv(as_ptr(x), D, Nx, Ny, as_ptr(c), M, 5, 5, as_ptr(b),
                 as_ptr(want))
    got = np.asarray(coord.conv2d(jnp.asarray(x)[None], jnp.asarray(c),
                                  jnp.asarray(b), tap_mode="ref_cpu",
                                  scale_by_dm=False)[0])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-2)


# --------------------------------------------------------------- Pool (N4)

def test_pool_downsample_matches(ref):
    """Executed-reference parity surfaced that ``Pool`` integer-truncates
    every block max (``int smax``, netlib.cpp:127): the result is
    ``floor(max(0, blockmax))``, which ``quantize=True`` reproduces."""
    rng = np.random.default_rng(1)
    D, Nx, Ny, s = 3, 12, 8, 2
    # image-scale values + negatives: exercises truncation AND the 0 clamp
    x = (_rand(rng, D, Nx, Ny) * 200.0).astype(np.float32)
    want = np.empty((D, Nx // s, Ny // s), np.float32)
    ref.ref_pool(as_ptr(x), D, Nx, Ny, s, as_ptr(want), Nx // s, Ny // s)
    got = np.asarray(coord.pool(jnp.asarray(x)[None], s, quantize=True)[0])
    np.testing.assert_array_equal(got, want)
    # sub-1 features: the reference zeroes them all
    x2 = np.abs(_rand(rng, D, Nx, Ny)) * 0.99
    ref.ref_pool(as_ptr(x2), D, Nx, Ny, s, as_ptr(want), Nx // s, Ny // s)
    np.testing.assert_array_equal(want, 0.0)
    got2 = np.asarray(coord.pool(jnp.asarray(x2)[None], s,
                                 quantize=True)[0])
    np.testing.assert_array_equal(got2, want)


def test_pool_upsample_matches(ref):
    rng = np.random.default_rng(2)
    D, Nx, Ny, s = 2, 6, 5, 3
    x = _rand(rng, D, Nx, Ny)
    want = np.empty((D, Nx * s, Ny * s), np.float32)
    ref.ref_pool(as_ptr(x), D, Nx, Ny, -s, as_ptr(want), Nx * s, Ny * s)
    got = np.asarray(coord.pool(jnp.asarray(x)[None], -s)[0])
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ Portion (N7)

@pytest.mark.parametrize("q", [2, 4])
def test_portion_matches(ref, q):
    rng = np.random.default_rng(3)
    D, M, Nx, Ny = 3, 5, 16, 24
    xin = _rand(rng, D, Nx, Ny)
    hin = _rand(rng, M, Nx, Ny)
    out = _rand(rng, D, Nx, Ny)
    w_in = np.empty((D, Nx // q, Ny // q), np.float32)
    w_hin = np.empty((M, Nx // q, Ny // q), np.float32)
    w_out = np.empty((D, Nx // q, Ny // q), np.float32)
    ref.ref_portion(as_ptr(xin), as_ptr(hin), as_ptr(out), D, M, Nx, Ny, q,
                    as_ptr(w_in), as_ptr(w_hin), as_ptr(w_out))
    np.testing.assert_array_equal(
        np.asarray(coord.center_crop(jnp.asarray(xin), q)), w_in)
    np.testing.assert_array_equal(
        np.asarray(coord.center_crop(jnp.asarray(hin), q)), w_hin)
    np.testing.assert_array_equal(
        np.asarray(coord.center_crop(jnp.asarray(out), q)), w_out)


# ----------------------------------------------------------- backprop (N9)

def _ref_backprop_step(ref, xin, out, hin, c, b, f, p, lr):
    c, b, f, p = (a.copy() for a in (c, b, f, p))
    D, Nx, Ny = xin.shape
    M, _, nk, nl = c.shape
    ref.ref_backprop(as_ptr(xin), as_ptr(out), as_ptr(hin), D, M, Nx, Ny,
                     nk, nl, as_ptr(c), as_ptr(b), as_ptr(f), as_ptr(p),
                     lr)
    return c, b, f, p


@pytest.mark.parametrize("nk", [3, 5])
def test_backprop_step_matches_executed_reference(ref, nk):
    """One CPU reference train step == coord_step(ref_cpu taps, alpha=0) —
    the gpu=0 training dispatch (autoencoder.cpp:200, engine A5)."""
    from spectralae.train.coord import coord_step
    rng = np.random.default_rng(40 + nk)
    D, M, Nx, Ny = 3, 4, 12, 12
    xin = _rand(rng, D, Nx, Ny)
    hin = _rand(rng, M, Nx, Ny)
    out = _rand(rng, D, Nx, Ny)
    c = _rand(rng, M, D, nk, nk)
    f = _rand(rng, D, M, nk, nk)
    b = _rand(rng, M)
    p = _rand(rng, D)
    lr = 0.2

    wc, wb, wf, wp = _ref_backprop_step(ref, xin, out, hin, c, b, f, p, lr)

    zeros = tuple(jnp.zeros_like(jnp.asarray(a)) for a in (c, f, b, p))
    res = coord_step(jnp.asarray(xin), jnp.asarray(out), jnp.asarray(hin),
                     jnp.asarray(c), jnp.asarray(f), jnp.asarray(b),
                     jnp.asarray(p), zeros, zeros, lr=lr, alpha=0.0,
                     tap_mode="ref_cpu")
    np.testing.assert_allclose(np.asarray(res.c), wc, rtol=3e-5, atol=3e-6)
    np.testing.assert_allclose(np.asarray(res.f), wf, rtol=3e-5, atol=3e-6)
    np.testing.assert_allclose(np.asarray(res.b), wb, rtol=3e-5, atol=3e-6)
    np.testing.assert_allclose(np.asarray(res.p), wp, rtol=3e-5, atol=3e-6)


def test_backprop_three_chained_steps(ref):
    """Chained steps (each on the previous step's weights) — catches drift
    and any update-rule mismatch a single step can mask."""
    from spectralae.train.coord import coord_step
    rng = np.random.default_rng(99)
    D, M, Nx, Ny, nk = 3, 3, 10, 10, 5
    xin = _rand(rng, D, Nx, Ny)
    hin = _rand(rng, M, Nx, Ny)
    out = _rand(rng, D, Nx, Ny)
    c = _rand(rng, M, D, nk, nk)
    f = _rand(rng, D, M, nk, nk)
    b = _rand(rng, M)
    p = _rand(rng, D)
    lr = 0.1

    wc, wb, wf, wp = c, b, f, p
    for _ in range(3):
        wc, wb, wf, wp = _ref_backprop_step(ref, xin, out, hin, wc, wb, wf,
                                            wp, lr)

    jc, jf, jb, jp = (jnp.asarray(a) for a in (c, f, b, p))
    zeros = tuple(jnp.zeros_like(a) for a in (jc, jf, jb, jp))
    for _ in range(3):
        res = coord_step(jnp.asarray(xin), jnp.asarray(out),
                         jnp.asarray(hin), jc, jf, jb, jp, zeros, zeros,
                         lr=lr, alpha=0.0, tap_mode="ref_cpu")
        jc, jf, jb, jp = res.c, res.f, res.b, res.p
    np.testing.assert_allclose(np.asarray(jc), wc, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(jf), wf, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(jb), wb, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(jp), wp, rtol=1e-4, atol=1e-5)


# ----------------------------------------------- SaveLoad_conv / .conv (N6)

def test_conv_file_byte_parity_and_filename(ref, tmp_path, monkeypatch):
    """The reference writes a .conv; our shim must (a) produce the
    byte-identical file for the same weights and (b) predict the
    reference's exact filename (shape metadata lives in the name only,
    netlib.cpp:230-234)."""
    from spectralae.io.checkpoint import (conv_filename, export_conv,
                                          import_conv)
    from spectralae.core.types import ConvStage
    rng = np.random.default_rng(5)
    M, D, nk, nl, scale, L = 4, 3, 5, 5, 2, 1
    c = _rand(rng, M, D, nk, nl)
    b = _rand(rng, M)

    monkeypatch.chdir(tmp_path)  # SaveLoad_conv writes to ./weights/
    os.makedirs("weights")
    ref.ref_saveload_conv(as_ptr(c), as_ptr(b), M, D, nk, nl, scale, L,
                          0, 1)
    files = sorted(os.listdir("weights"))
    assert files == [conv_filename(L, 0, D, M, nk, nl, scale)]

    ours = tmp_path / "ours.conv"
    export_conv(ConvStage(c=jnp.asarray(c), b=jnp.asarray(b)), ours)
    assert ours.read_bytes() == (tmp_path / "weights" / files[0]).read_bytes()

    # round-trip: the reference LOADS a file we wrote, bit-for-bit
    rng2 = np.random.default_rng(6)
    c2 = _rand(rng2, M, D, nk, nl)
    b2 = _rand(rng2, M)
    export_conv(ConvStage(c=jnp.asarray(c2), b=jnp.asarray(b2)),
                tmp_path / "weights" / files[0])
    got_c = np.zeros_like(c)
    got_b = np.zeros_like(b)
    ref.ref_saveload_conv(as_ptr(got_c), as_ptr(got_b), M, D, nk, nl,
                          scale, L, 0, 0)
    np.testing.assert_array_equal(got_c, c2)
    np.testing.assert_array_equal(got_b, b2)

    # and we LOAD a file the reference wrote, bit-for-bit
    st = import_conv(tmp_path / "weights" / files[0], M, D, nk, nl)
    np.testing.assert_array_equal(np.asarray(st.c), c2)
    np.testing.assert_array_equal(np.asarray(st.b), b2)


def test_conv_filename_scheme_sweep(ref, tmp_path, monkeypatch):
    """Filename parity across shapes/levels/in-out/scales — the half-extent
    math Lk=(Nk-1)/2-1 must match the reference exactly."""
    from spectralae.io.checkpoint import conv_filename
    monkeypatch.chdir(tmp_path)
    os.makedirs("weights")
    cases = [(2, 3, 3, 3, 1, 0, 0), (10, 3, 5, 5, 2, 0, 1),
             (7, 10, 7, 5, 4, 2, 0), (1, 1, 3, 7, -2, 3, 1)]
    for M, D, nk, nl, scale, L, io in cases:
        c = np.zeros((M, D, nk, nl), np.float32)
        b = np.zeros((M,), np.float32)
        ref.ref_saveload_conv(as_ptr(c), as_ptr(b), M, D, nk, nl, scale, L,
                              io, 1)
        want = conv_filename(L, io, D, M, nk, nl, scale)
        assert (tmp_path / "weights" / want).exists(), want
    assert half_extent(5) == 1  # Nk=2(L+1)+1 inverse, autoencoder.cpp:43
