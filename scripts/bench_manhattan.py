"""Manhattan-world 2D pose graph benchmark — the BASELINE.json config-1
analogue ("manhattanOlson3500 2D pose graph, SE2 vertices, GN +
dense-block Cholesky, CPU-runnable").

manhattanOlson3500 itself is not redistributable in this environment, so an
equivalent synthetic Manhattan-world graph (3500 SE2 poses, grid walk with
loop closures — ``sim/generators.create_manhattan(seed=0)``) is used for
both sides.  The reference binary's numbers on the identical ``.g2o`` file
are recorded in ``baseline_measured.json`` ("manhattan3500") and its
optimized trajectory stored at ``data/manhattan3500_ref_opt.g2o`` for the
ATE-parity check (BASELINE.md "Trajectory ATE parity").

Parity facts (reproduced by tests / the CPU path):

* CPU float64 GN + supernodal Cholesky matches the reference's chi2
  trajectory bit-for-bit: 9144694.2 → 20923378 → 76367.5 → 9478.1 →
  **9116.756452780** (reference gn_var: 9116.756453).
* In float32 the undamped GN normal equations of this
  near-chain graph (cond ≳ 1e7) exceed single-precision direct
  factorization — LM's damping restores convergence, so the benchmarked
  config is LM + supernodal Cholesky vs the reference's lm_var, the
  algorithm-matched pair (chi2 9122.8 after 60 iterations vs the
  reference LM's 9146.5 after 30; both approach the GN fixed point
  9116.76).

At this problem size (T = 10500, a near-chain sparsity CSparse handles in
~10 ms/iter) a device LM iteration is dispatch-bound; see PERF.md for
the measured times.

Usage: python scripts/bench_manhattan.py [N_ITERS]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    from g2o_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp
    import numpy as np

    import g2o_tpu.types  # noqa: F401  (register tags)
    from g2o_tpu.core.lm_fused import optimize_fused
    from g2o_tpu.core.solvers.supernodal import SupernodalCholeskySolver
    from g2o_tpu.io import g2o_format
    from g2o_tpu.sim.generators import create_manhattan
    from g2o_tpu.utils.metrics import ate

    n_iters = int(sys.argv[1]) if len(sys.argv) > 1 else 60

    t0 = time.perf_counter()
    g = create_manhattan(n_poses=3500, seed=0)
    p = g.compile()
    build_s = time.perf_counter() - t0

    # LM + direct supernodal block Cholesky — the reference's lm_var
    # (CSparse) config (see module docstring for why not GN in f32)
    solver = SupernodalCholeskySolver()
    est0 = {t: np.array(v) for t, v in p.estimates.items()}
    res = optimize_fused(p, solver, 2)              # warm-up/compile
    p.set_estimates({t: jnp.asarray(v, dtype=p.dtype)
                     for t, v in est0.items()})
    solver._host_state = None
    res = optimize_fused(p, solver, n_iters)
    sec_per_iter = res["wall_s"] / max(res["iterations"], 1)

    ref_path = os.path.join(REPO, "baseline_measured.json")
    vs_baseline, ref_chi2, ref_lm = 0.0, None, {}
    if os.path.exists(ref_path):
        with open(ref_path) as fh:
            ref = json.load(fh).get("manhattan3500", {})
        if ref.get("lm_var_sec_per_iter"):
            vs_baseline = ref["lm_var_sec_per_iter"] / sec_per_iter
        ref_chi2 = ref.get("chi2_converged")
        ref_lm = {k: ref.get(k) for k in
                  ("lm_var_sec_per_iter", "lm_var_chi2_after_30_iters")}

    # time to the reference LM's own 30-iteration chi2 (+1%)
    tt = None
    if ref_lm.get("lm_var_chi2_after_30_iters"):
        target = ref_lm["lm_var_chi2_after_30_iters"] * 1.01
        chis = res["chi2_per_iteration"] + [res["chi2_final"]]
        tt = next((round(i * sec_per_iter, 3)
                   for i, c in enumerate(chis) if c <= target), None)

    # ATE parity against the reference's own optimized trajectory
    ate_vs_ref = None
    ref_opt = os.path.join(REPO, "data", "manhattan3500_ref_opt.g2o")
    if os.path.exists(ref_opt):
        gref = g2o_format.load(ref_opt)
        ours = p.estimates_by_vid()
        ref_est = {vid: rec.estimate for vid, rec in gref.vertices().items()}
        vids = sorted(set(ours) & set(ref_est))
        ate_vs_ref = ate(np.stack([ours[v] for v in vids]),
                         np.stack([ref_est[v] for v in vids]))

    out = {
        "metric": "manhattan3500 LM iterations/sec "
                  "(SE2, supernodal block Cholesky)",
        "value": round(res["iterations"] / res["wall_s"], 4),
        "unit": "iter/s",
        "vs_baseline": round(vs_baseline, 4),
        "extra": {
            "sec_per_iter": round(sec_per_iter, 5),
            "chi2_initial": res["chi2_per_iteration"][0],
            "chi2_final": res["chi2_final"],
            "reference_lm_sec_per_iter": ref_lm.get("lm_var_sec_per_iter"),
            "reference_lm_chi2_after_30_iters":
                ref_lm.get("lm_var_chi2_after_30_iters"),
            "reference_gn_chi2_converged": ref_chi2,
            "time_to_reference_lm_chi2_s": tt,
            "ate_vs_reference_m": ate_vs_ref,
            "build_s": round(build_s, 2),
        },
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
