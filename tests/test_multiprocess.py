"""Real 2-process execution of the sharded Schur solver.

The reference proves its MPI layer by launching the same pytest suite under
``mpirun -np {2,3,4} -oversubscribe``
(/root/reference/.github/workflows/main_ci.yml:33-41).  This test is the
JAX analogue: two OS processes, each with 4 virtual CPU devices,
joined by ``jax.distributed`` into one 8-device mesh; the sharded solver's
psum/pmax collectives then actually cross the process boundary.
"""

import os
import socket
import subprocess
import sys

import pytest


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_workers(nprocs: int, mode: str, timeout: int):
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)), "multiprocess_worker.py")
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)  # worker sets its own device count
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), str(nprocs), str(port), mode],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(nprocs)
    ]
    outputs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outputs.append(out)
    for i, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"process {i} failed:\n{out}"
        assert f"WORKER_OK {i}" in out, f"process {i} output:\n{out}"
    return outputs


@pytest.mark.parametrize("nprocs", [2])
def test_two_process_sharded_solver(nprocs):
    _run_workers(nprocs, "toy", 300)


@pytest.mark.parametrize("nprocs", [2])
def test_two_process_production_fused_solve(nprocs):
    """The dryrun_multichip config across a REAL process boundary: 16-block
    Burgers chain, nk=922, b=128 winv panels, 2 blocks/shard
    (``group_offset`` live), fused solve to tol 1e-8 with serial parity,
    plus a non-divisible 11-on-8 solve — the analogue of the reference's
    ``mpirun -np 2`` suite tier
    (/root/reference/.github/workflows/main_ci.yml:33-41)."""
    outs = _run_workers(nprocs, "production", 900)
    assert any("PRODUCTION_OK" in o for o in outs)
