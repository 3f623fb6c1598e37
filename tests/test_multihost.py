"""Multi-host distributed layer: 2 processes x 4 virtual CPU devices over
localhost TCP (standing in for the network between hosts), one
process-spanning mesh.

The worker (scripts/multihost_worker.py) runs distributed BA and the
distributed Sim3 pose graph over the global mesh and checks equivalence
with the single-device solvers; this test asserts the process group forms,
both workers exit 0, and process 0 prints PASS. Covers BASELINE.md's
scaling north star (>= 2 hosts) at the correctness level."""

import os
import socket
import subprocess
import sys

import pytest

pytestmark = pytest.mark.heavy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_mesh_matches_single_device():
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    # each process forms its own backend: scrub the test session's own
    # device-count forcing so the worker's init_multihost controls it
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(REPO, "scripts", "multihost_worker.py"),
             str(pid), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            cwd=REPO, text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-4000:]}"
    assert "PASS" in outs[0], outs[0][-4000:]
