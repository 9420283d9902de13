"""Multi-process distributed worker — one process of an N-process JAX job.

Exercises the REAL multi-process path (`jax.distributed.initialize`,
`make_global_mesh(hosts_axis=True)`, `shard_problem_data_global` with
`jax.make_array_from_process_local_data`) that single-process tests cannot
reach.  Every process builds the identical problem deterministically (the
analogue of each host loading its dataset shard), shards the edge batches
over the (hosts, edges) mesh, runs a fused LM optimization, and process 0
writes the chi2 trajectory to ``--out`` for comparison against a
single-process run.

CPU only: every worker runs on the CPU fake backend (the reference for
multi-host semantics, SURVEY.md §5.8), so no two processes ever compete
for one GPU.  A multi-host GPU job would run the same code with one
process per host.

Usage (launched N times, e.g. by tests/test_multiprocess.py):
    python scripts/distributed_worker.py --coordinator localhost:PORT \
        --nproc 2 --pid 0 --devices-per-proc 4 --out /tmp/out.json
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--devices-per-proc", type=int, default=4)
    ap.add_argument("--out", default="")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--n-poses", type=int, default=200)
    ap.add_argument("--hosts-axis", action="store_true", default=True)
    args = ap.parse_args()

    # CPU fake backend with K local devices per process; both variables
    # must be set before JAX initializes its backend
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={args.devices_per_proc}"
    ).strip()
    import jax

    jax.config.update("jax_enable_x64", True)

    jax.distributed.initialize(coordinator_address=args.coordinator,
                               num_processes=args.nproc,
                               process_id=args.pid)
    assert jax.process_count() == args.nproc
    n_dev = len(jax.devices())
    assert n_dev == args.nproc * args.devices_per_proc

    import jax.numpy as jnp
    import numpy as np

    from g2o_tpu.core.lm_fused import optimize_fused
    from g2o_tpu.core.solvers import PCGSolver
    from g2o_tpu.parallel import replicate_estimates
    from g2o_tpu.parallel.multihost import (
        make_global_mesh, shard_problem_data_global)
    from g2o_tpu.sim.generators import create_manhattan

    # identical deterministic problem on every process
    g = create_manhattan(n_poses=args.n_poses, seed=7)
    p = g.compile(pad_edges_to_multiple=n_dev)

    mesh = make_global_mesh(hosts_axis=args.hosts_axis)
    p.data = shard_problem_data_global(p.data, mesh)
    p.estimates = replicate_estimates(p.estimates, mesh)

    solver = PCGSolver(max_iter=100, tol=1e-10)
    res = optimize_fused(p, solver, args.iters)

    out = {
        "process_count": jax.process_count(),
        "process_index": jax.process_index(),
        "n_devices": n_dev,
        "mesh_shape": dict(mesh.shape),
        "iterations": res["iterations"],
        "chi2_per_iteration": res["chi2_per_iteration"],
        "chi2_final": res["chi2_final"],
        "wall_s": res["wall_s"],
    }
    if args.out and jax.process_index() == 0:
        with open(args.out, "w") as fh:
            json.dump(out, fh)
    print(json.dumps({"pid": args.pid, "chi2_final": res["chi2_final"]}),
          flush=True)
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
