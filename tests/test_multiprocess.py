"""REAL multi-process distributed execution, CPU only.

Spawns two `jax.distributed` worker processes on localhost (CPU backend,
4 virtual devices each => an 8-device (hosts=2, edges=4) global mesh),
runs a fused LM optimization with globally-sharded edge batches built via
`jax.make_array_from_process_local_data`, and asserts exactness against the
same optimization run single-process in this test session.

This is the path `tests/test_sharded_schur.py::test_multihost_helpers_
single_process` cannot reach (`parallel/multihost.py` multi-process
branches).  The reference has no distributed backend at all (SURVEY.md
§5.8); semantics here are defined by single-process equivalence.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "scripts", "distributed_worker.py")

N_POSES = 200
ITERS = 10


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_workers(out_path, nproc=2, devices_per_proc=4, timeout=600):
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)          # worker sets its own device count
    procs = []
    for pid in range(nproc):
        procs.append(subprocess.Popen(
            [sys.executable, WORKER,
             "--coordinator", f"localhost:{port}",
             "--nproc", str(nproc), "--pid", str(pid),
             "--devices-per-proc", str(devices_per_proc),
             "--iters", str(ITERS), "--n-poses", str(N_POSES),
             "--out", out_path],
            cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outputs = []
    try:
        for pr in procs:
            out, _ = pr.communicate(timeout=timeout)
            outputs.append(out)
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
    for pr, out in zip(procs, outputs):
        assert pr.returncode == 0, f"worker failed:\n{out[-4000:]}"
    with open(out_path) as fh:
        return json.load(fh)


def test_two_process_distributed_matches_single(tmp_path):
    res = _run_workers(str(tmp_path / "out.json"), nproc=2,
                       devices_per_proc=4)
    assert res["process_count"] == 2
    assert res["n_devices"] == 8
    assert res["mesh_shape"] == {"hosts": 2, "edges": 4}

    # single-process reference in THIS session (8-device CPU mesh, f64)
    from g2o_tpu.core.lm_fused import optimize_fused
    from g2o_tpu.core.solvers import PCGSolver
    from g2o_tpu.parallel import replicate_estimates
    from g2o_tpu.parallel.multihost import (
        make_global_mesh, shard_problem_data_global)
    from g2o_tpu.sim.generators import create_manhattan

    g = create_manhattan(n_poses=N_POSES, seed=7)
    p = g.compile(pad_edges_to_multiple=8)
    mesh = make_global_mesh()
    p.data = shard_problem_data_global(p.data, mesh)
    p.estimates = replicate_estimates(p.estimates, mesh)
    ref = optimize_fused(p, PCGSolver(max_iter=100, tol=1e-10), ITERS)

    assert res["iterations"] == ref["iterations"]
    np.testing.assert_allclose(res["chi2_per_iteration"],
                               ref["chi2_per_iteration"], rtol=1e-9)
    np.testing.assert_allclose(res["chi2_final"], ref["chi2_final"],
                               rtol=1e-9)
