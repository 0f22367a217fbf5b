"""Multi-process (multi-host) distribution: 2 OS processes × 4 CPU devices
form one 8-device global mesh; the distributed train step and burst run
across the process boundary with gloo collectives (the CPU stand-in for
NCCL between hosts — the reference has no multi-process capability at all,
SURVEY.md §2.9)."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytestmark = pytest.mark.slow  # subprocess pair + gloo init (~60 s)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_train_and_burst():
    root = Path(__file__).resolve().parents[1]
    worker = root / "tests" / "multihost_worker.py"
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS", "PYTHONPATH")}
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(port), str(pid)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=str(root), env=env) for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            try:
                # generous: the workers pass in ~36s on an idle host, but
                # under a parallel (xdist) suite the 2×4-virtual-device
                # init + gloo handshake contends with compile-heavy peers
                # and 240s tripped
                out, err = p.communicate(timeout=900)
            except subprocess.TimeoutExpired:
                pytest.fail("multihost worker timed out")
            assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
            lines = [l for l in out.splitlines() if l.startswith("{")]
            assert lines, (f"worker printed no JSON result\n"
                           f"stdout: {out[-1500:]}\nstderr: {err[-1500:]}")
            outs.append(json.loads(lines[-1]))
    finally:
        # a failed/early-asserted first worker must not orphan the second
        # (it would block in its distributed handshake for its full
        # internal timeout with open pipes)
        for q in procs:
            if q.poll() is None:
                q.kill()

    r0, r1 = sorted(outs, key=lambda r: r["pid"])
    assert r0["coordinator"] and not r1["coordinator"]
    # both processes observe the identical replicated trajectory
    np.testing.assert_allclose(r0["losses"], r1["losses"], rtol=1e-6)
    np.testing.assert_allclose(r0["burst_mse0"], r1["burst_mse0"], rtol=1e-6)
    assert r0["losses"][-1] < r0["losses"][0]
    assert r0["burst_mseN"] < r0["burst_mse0"]
    # the DP×TP burst (model axis crossing the process boundary) agrees
    # with the DP-only burst on the same data and descends identically
    np.testing.assert_allclose(r0["tp_mse0"], r0["burst_mse0"], rtol=1e-4)
    np.testing.assert_allclose(r0["tp_mseN"], r0["burst_mseN"], rtol=1e-3)
    np.testing.assert_allclose(r0["tp_mseN"], r1["tp_mseN"], rtol=1e-6)
    # the streaming trainer runs across the process boundary and descends
    assert r0["stream_mseN"] < r0["stream_mse0"]
    np.testing.assert_allclose(r0["stream_mseN"], r1["stream_mseN"],
                               rtol=1e-6)
