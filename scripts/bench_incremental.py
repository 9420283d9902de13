"""Incremental warm-start benchmark — manhattan replay, warm vs cold.

Replays a manhattan pose graph in updates of ``--batch`` poses (the
reference ``g2o -inc`` replays edges sorted by max vertex id,
``apps/g2o_cli/g2o.cpp:373-460``), optimizing a few LM iterations per
update.  Compares per-update wall time of:

* cold   — per-solve preconditioner rebuild (every λ-trial);
* warm   — frozen preconditioner refreshed ONCE per update
           (``PCGSolver(precond_mode="frozen")``), the device-side analogue of the
           reference's CHOLMOD update/downdate factor reuse.

Usage: python scripts/bench_incremental.py [N_POSES] [BATCH] [ITERS]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def replay(mode, n_poses, batch, iters):
    from g2o_tpu.core.incremental import IncrementalOptimizer
    from g2o_tpu.core.solvers import PCGSolver
    from g2o_tpu.sim.generators import create_manhattan

    g = create_manhattan(n_poses=n_poses, seed=0)
    inc = IncrementalOptimizer(
        solver_factory=lambda: PCGSolver(max_iter=100, tol=1e-6,
                                         precond_mode=mode),
        vertex_chunk=max(batch * 2, 128), edge_chunk=max(batch * 4, 256))
    vs = sorted(g.vertices())
    recs, es = g.vertices(), g.edges()
    placed, added = set(), set()
    times = []
    i0 = 0
    while i0 < len(vs):
        for vid in vs[i0:i0 + batch]:
            r = recs[vid]
            inc.add_vertex(vid, r.vtype, r.estimate, fixed=r.fixed)
            placed.add(vid)
        for i, e in enumerate(es):
            if i not in added and set(e.vids) <= placed:
                inc.add_edge(e.etype, e.vids, e.measurement, e.information)
                added.add(i)
        t0 = time.perf_counter()
        inc.optimize(iters)
        times.append(time.perf_counter() - t0)
        i0 += batch
    # drop compile-bearing updates (first per capacity regime)
    steady = sorted(times)[:max(1, int(len(times) * 0.8))]
    return {
        "mode": mode,
        "updates": len(times),
        "recompiles": inc.recompiles,
        "mean_update_s": round(sum(times) / len(times), 4),
        "steady_update_s": round(sum(steady) / len(steady), 4),
        "final_chi2": float(inc.chi2()),
    }


def main():
    from g2o_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()

    n_poses = int(sys.argv[1]) if len(sys.argv) > 1 else 1000
    batch = int(sys.argv[2]) if len(sys.argv) > 2 else 50
    iters = int(sys.argv[3]) if len(sys.argv) > 3 else 3

    cold = replay("per_solve", n_poses, batch, iters)
    warm = replay("frozen", n_poses, batch, iters)
    speedup = (cold["steady_update_s"] / warm["steady_update_s"]
               if warm["steady_update_s"] else 0.0)
    print(json.dumps({
        "metric": f"incremental per-update wall time, manhattan{n_poses} "
                  f"(batch={batch}, {iters} LM iters/update)",
        "cold": cold, "warm": warm,
        "warm_speedup": round(speedup, 3),
    }))


if __name__ == "__main__":
    main()
