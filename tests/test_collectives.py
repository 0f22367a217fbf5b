"""Collective traffic proof (VERDICT r4 item 7): the multi-chip scaling
model's load-bearing claim, asserted from the compiled SPMD HLO.

The correlation-space burst's DP design (train/fft_corr.py) moves ONE
pmean of the lag-tensor dict per burst — `XX [D,D,n4] + XE0/XG0 [D,D,n2]
+ 3 scalars + 3 [D] vectors`, ~16 KB at D=3/5×5 — and nothing
resolution-sized, so DP scaling is resolution-independent (the model in
docs/DESIGN.md §5).  The TP (model-axis) path adds exactly one
resolution-sized collective: the all_gather of the X half-spectra.

These tests compile `distributed_burst` over the 8-virtual-device CPU
mesh and parse the optimized HLO's collectives: shapes, counts, bytes.
"""

import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from spectralae.dist.mesh import make_mesh
from spectralae.train.fft_dp import distributed_burst

_SHAPE = re.compile(r"(f|s|u|c|bf|pred)[0-9]*\[([0-9,]*)\]")


def _setup(n=256, b=8, d=3, m=10, nk=5, seed=0):
    rng = np.random.default_rng(seed)
    xs = jnp.asarray(rng.normal(size=(b, d, n, n)).astype(np.float32))
    enc_c = jnp.asarray(rng.normal(size=(m, d, nk, nk)).astype(np.float32))
    dec_c = jnp.asarray(rng.normal(size=(d, m, nk, nk)).astype(np.float32))
    return xs, enc_c, dec_c, jnp.zeros((m,), jnp.float32), \
        jnp.zeros((d,), jnp.float32)


def _collectives(mesh, args, iters=5):
    """[(op, max_elems_in_line)] for every collective in the optimized
    HLO of the compiled distributed burst."""
    run = distributed_burst(mesh, lr=0.2, iters=iters, fused=True)
    txt = run.lower(*args).compile().as_text()
    out = []
    for line in txt.splitlines():
        m = re.search(r"\b(all-reduce|all-gather|reduce-scatter|"
                      r"collective-permute|all-to-all)(-start)?\(", line)
        if not m or "-done" in line:
            continue
        elems = [int(np.prod([int(x) for x in dims.split(",") if x]))
                 for _, dims in _SHAPE.findall(line)]
        out.append((m.group(1), max(elems) if elems else 0))
    return out


def _expected_payload_elems(d=3, nk=5):
    h = nk // 2
    n4 = (4 * h + 1) * (4 * h + 1) * 0 + (2 * (4 * h) + 1) ** 2
    n2 = (2 * (2 * h) + 1) ** 2
    return d * d * n4 + 2 * d * d * n2 + 3 * d + 3


def test_dp_burst_collectives_are_window_sized():
    """Pure-DP burst: every collective operand is lag-window-sized
    (≤ the T-dict payload, resolution-INDEPENDENT) — no spectra, planes,
    or per-iteration gradients ever cross the interconnect."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    args = _setup(n=256, b=8)
    colls = _collectives(make_mesh(8, 1), args)
    assert colls, "the DP burst must reduce its lag tensors over the mesh"
    budget = _expected_payload_elems()           # 2,964 elems at D=3/5×5
    for op, elems in colls:
        assert op == "all-reduce", colls
        assert elems <= budget, (op, elems, budget)
    # one pmean per burst: XLA may split the dict reduction into a few
    # all-reduces, but there is nothing per-iteration to reduce
    assert len(colls) <= 12, colls
    total = sum(e for _, e in colls)
    assert total <= 2 * budget, (total, budget)


def test_dp_collective_bytes_are_resolution_independent():
    """The same burst at 2× the resolution compiles to the same
    collective payload — the scaling model's core claim."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = make_mesh(8, 1)
    lo = _collectives(mesh, _setup(n=128, b=8))
    hi = _collectives(mesh, _setup(n=256, b=8))
    assert sum(e for _, e in lo) == sum(e for _, e in hi), (lo, hi)


def test_tp_burst_single_resolution_sized_gather():
    """data×model mesh: the ONLY resolution-sized collective is the one
    all_gather of the X half-spectra (B·D·nx·nyr complex per burst);
    everything else stays window/scalar-sized."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    n, b = 256, 2
    args = _setup(n=n, b=b)
    colls = _collectives(make_mesh(2, 4), args)
    nyr = n // 2 + 1
    x_gather = b * 3 * n * nyr                   # complex spectra elems
    big = [(op, e) for op, e in colls if e > 4 * _expected_payload_elems()]
    assert big, "the TP path must gather the sharded spectra"
    for op, elems in big:
        assert op == "all-gather", (op, elems, colls)
        # the gathered spectra (re/im may appear split or complex, and
        # padding may round the shard) — within 2× of B·D·nx·nyr
        assert elems <= 2 * x_gather + 4096, (elems, x_gather)
    assert len(big) <= 2, big                    # re+im at most
