"""Venice-scale BA benchmark — the BASELINE.json config-4 analogue.

No dataset download exists in this environment, so a Venice-like synthetic
problem is generated (hundreds of cameras, hundreds of thousands of points,
~1M observations).  At this scale the explicit Schur pair list is memory-
prohibitive (sum of squared landmark degrees); the matrix-free implicit
Schur CG (O(observations) memory) is the scalable path — the square-root
CGLS solver (the fork's approach) is the alternative.

Usage: python scripts/bench_venice.py [N_CAMERAS] [N_POINTS] [N_ITERS]
"""

import io
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    from g2o_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()

    import jax.numpy as jnp
    import numpy as np

    from g2o_tpu.core.lm_fused import optimize_fused
    from g2o_tpu.core.solvers.schur_implicit import ImplicitSchurSolver
    from g2o_tpu.io.bal import load_bal_problem, synthetic_bal_cached

    n_cams = int(sys.argv[1]) if len(sys.argv) > 1 else 800
    n_pts = int(sys.argv[2]) if len(sys.argv) > 2 else 150_000
    n_iters = int(sys.argv[3]) if len(sys.argv) > 3 else 10

    t0 = time.perf_counter()
    text = synthetic_bal_cached(n_cameras=n_cams, n_points=n_pts,
                              n_obs_per_point=6, pixel_noise=1.0, seed=0)
    # the problem is loaded EXACTLY as the reference loads it (no robust
    # kernel, unperturbed estimates) so chi2 values and per-iteration wall
    # time compare 1:1 against the measured bal_example baseline
    # (baseline_measured.json "venice_ba"; recipe: write this text to a
    # file and run /tmp/g2o_ref_build/bin/bal_example -i 10 -v [-pcg])
    p = load_bal_problem(io.StringIO(text), huber=0.0,
                         bucket_landmarks=True)
    build_s = time.perf_counter() - t0
    n_obs = p.num_edges

    # eta-forcing: LM needs only an inexact step (the fork's own
    # LinearSolverPCGEigen terminates on ||s||^2 <= eta ||s0||^2,
    # ``solvers/eigen/linear_solver_pcg_eigen.h:184-188``); the trust
    # region absorbs the inexactness
    solver = ImplicitSchurSolver(max_iter=100, tol=1e-2, precond="jacobi")
    est0 = {t: np.array(v) for t, v in p.estimates.items()}
    res = optimize_fused(p, solver, 2)           # warm-up/compile
    # restore the initial estimates: the measured run (and its chi2
    # trajectory, compared 1:1 with the reference's) starts from scratch
    p.set_estimates({t: jnp.asarray(v, dtype=p.dtype)
                     for t, v in est0.items()})
    solver._host_state = None
    res = optimize_fused(p, solver, n_iters)

    sec_per_iter = res["wall_s"] / max(res["iterations"], 1)
    vs_baseline = 0.0
    ref_chi2 = None
    ref_path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "baseline_measured.json")
    if os.path.exists(ref_path) and (n_cams, n_pts) == (800, 150_000):
        with open(ref_path) as fh:
            ref = json.load(fh).get("venice_ba", {})
        if ref.get("sec_per_lm_iter_pcg"):
            # compare against the reference's FASTER config (PCG)
            vs_baseline = ref["sec_per_lm_iter_pcg"] / sec_per_iter
        ref_chi2 = ref.get("chi2_after_10_iters")

    out = {
        "metric": f"Venice-scale BA LM iterations/sec "
                  f"({n_cams} cams, {n_pts} pts, {n_obs} obs, implicit Schur)",
        "value": round(res["iterations"] / res["wall_s"], 4),
        "unit": "iter/s",
        "vs_baseline": round(vs_baseline, 4),
        "extra": {
            "sec_per_iter": round(sec_per_iter, 4),
            "chi2_initial": res["chi2_per_iteration"][0],
            "chi2_final": res["chi2_final"],
            "reference_chi2_after_10_iters": ref_chi2,
            "build_s": round(build_s, 1),
        },
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
