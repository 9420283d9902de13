"""Capture a GPU profiler trace of the fused Venice LM run and print the
top HLO ops by self time (read from the trace's Chrome-format events).

Usage: python scripts/trace_venice.py [N_CAMS] [N_PTS] [N_ITERS]
"""

import glob
import gzip
import io
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

TRACE_DIR = os.path.join(REPO, "chiprun_out", "venice_trace")


def main():
    import jax

    from g2o_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()

    from g2o_tpu.core.lm_fused import optimize_fused
    from g2o_tpu.core.solvers.schur_implicit import ImplicitSchurSolver
    from g2o_tpu.io.bal import load_bal_problem, synthetic_bal_cached

    n_cams = int(sys.argv[1]) if len(sys.argv) > 1 else 800
    n_pts = int(sys.argv[2]) if len(sys.argv) > 2 else 150_000
    n_iters = int(sys.argv[3]) if len(sys.argv) > 3 else 5

    text = synthetic_bal_cached(n_cameras=n_cams, n_points=n_pts,
                              n_obs_per_point=6, pixel_noise=1.0, seed=0)
    p = load_bal_problem(io.StringIO(text), huber=0.0, bucket_landmarks=True)
    solver = ImplicitSchurSolver(max_iter=100, tol=1e-2, precond="jacobi")
    optimize_fused(p, solver, 2)     # warm-up/compile

    with jax.profiler.trace(TRACE_DIR):
        optimize_fused(p, solver, n_iters)

    xplanes = sorted(glob.glob(
        os.path.join(TRACE_DIR, "**", "*.trace.json.gz"), recursive=True),
        key=os.path.getmtime)
    print("trace:", xplanes[-1], flush=True)

    # aggregate XLA op durations straight from the Chrome trace
    import collections
    import re

    with gzip.open(xplanes[-1]) as fh:
        tr = json.load(fh)
    ev = [e for e in tr["traceEvents"] if e.get("ph") == "X"]
    lanes = {}
    for e in tr["traceEvents"]:
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            lanes[(e["pid"], e["tid"])] = e["args"].get("name", "")
    ops = [e for e in ev
           if lanes.get((e["pid"], e.get("tid"))) == "XLA Ops"]
    agg, cnt, ex = (collections.Counter(), collections.Counter(), {})
    for e in ops:
        if e["name"].startswith("while"):
            continue
        agg[e["name"]] += e["dur"]
        cnt[e["name"]] += 1
        ex[e["name"]] = (e.get("args") or {}).get("long_name", "")[:130]
    print(f"total leaf-op time: "
          f"{sum(agg.values())/1e6:.3f} s over {sum(cnt.values())} ops")
    for name, dur in agg.most_common(25):
        print(f"{dur/1e3:8.1f} ms x{cnt[name]:<4} {name[:40]} | "
              f"{ex[name]}", flush=True)


if __name__ == "__main__":
    main()
