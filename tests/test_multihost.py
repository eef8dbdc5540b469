"""2-process multihost rehearsal on CPU.

Spawns two OS processes, each with 4 virtual CPU devices, initializes
``jax.distributed`` (Gloo collectives), builds the (process, local)
mesh, and runs the sharded halo PCG — asserting both processes converge
to the single-process solution.  This is the CI stand-in for a
multi-host cluster (SURVEY.md §7 stage 8).
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_halo_pcg():
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)  # workers set their own device counts
    env["PYTHONPATH"] = str(REPO)
    procs = [
        subprocess.Popen(
            [
                sys.executable,
                "-m",
                "tests.multihost_worker",
                str(pid),
                "2",
                str(port),
            ],
            cwd=REPO,
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=560)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-3000:]}"
        assert f"MULTIHOST p{pid}: converged=True" in out, out[-3000:]
