"""Scaling-efficiency harness — the BASELINE.json ">=70% at >=2 hosts"
metric.  Runs the fused SPMD optimization step on meshes of 1, 2, 4, ...
devices over whatever devices the runtime exposes and reports per-size
throughput + efficiency vs linear scaling.

With ``--cpu`` the multi-device rows come from the CPU fake backend
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``) — numerically
exact but not a hardware measurement; on a machine with several GPUs the
same script produces the hardware numbers.

Usage: python scripts/bench_scaling.py [--cpu] [N_POSES]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    force_cpu = "--cpu" in sys.argv
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    n_poses = int(args[0]) if args else 2500

    import jax

    if force_cpu:
        os.environ.setdefault(
            "XLA_FLAGS",
            "--xla_force_host_platform_device_count=8")
        jax.config.update("jax_platforms", "cpu")
    from g2o_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()

    import jax.numpy as jnp

    from g2o_tpu.core.solvers import PCGSolver
    from g2o_tpu.parallel import (
        make_fused_step, make_mesh, replicate_estimates, shard_problem_data,
    )
    from g2o_tpu.sim.generators import create_sphere

    n_dev_total = len(jax.devices())
    sizes = [d for d in (1, 2, 4, 8, 16, 32) if d <= n_dev_total]

    nodes = max(10, int(round((n_poses / 50) ** 0.5 * 7)))
    laps = max(2, n_poses // nodes)
    g = create_sphere(nodes_per_level=nodes, laps=laps, radius=50.0, seed=0)

    rows = []
    base_rate = None
    for nd in sizes:
        p = g.compile(pad_edges_to_multiple=nd)
        solver = PCGSolver(max_iter=50, tol=1e-6).setup(p)
        step = make_fused_step(p, solver, donate=False)
        mesh = make_mesh(nd)
        data = shard_problem_data(p.data, mesh)
        est = replicate_estimates(p.estimates, mesh)
        lam = jnp.asarray(1e-4, p.dtype)
        out = step(data, est, lam)
        jax.block_until_ready(out)           # warm-up/compile
        n_rep = 10
        t0 = time.perf_counter()
        for _ in range(n_rep):
            out = step(data, est, lam)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / n_rep
        rate = 1.0 / dt
        if base_rate is None:
            base_rate = rate
        eff = rate / (base_rate * nd)
        rows.append({"devices": nd, "steps_per_sec": round(rate, 3),
                     "efficiency": round(eff, 4)})

    result = {
        "metric": f"SPMD step scaling ({g.num_vertices} poses, "
                  f"{g.num_edges} edges, PCG)",
        "value": rows[-1]["efficiency"] if len(rows) > 1 else 1.0,
        "unit": "efficiency_at_max_devices",
        "vs_baseline": 0.0,
        "extra": {"rows": rows,
                  "backend": jax.default_backend(),
                  "note": ("fake CPU backend" if force_cpu or
                           jax.default_backend() == "cpu"
                           else "hardware")},
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
