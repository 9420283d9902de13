"""Benchmark harness — prints ONE JSON line with the headline metric plus
per-config results for EVERY north-star config (BASELINE.json).

Headline (``value``/``vs_baseline``): LM iterations/sec on sphere2500
(reference ``create_sphere`` dataset, Huber kernels) vs the reference g2o's
measured per-LM-iteration wall time on this machine's CPU
(``baseline_measured.json``, recipe ``scripts/measure_reference.md``).

``extra.configs`` carries the same treatment for manhattan3500 (reference
lm_var), Ladybug-scale BA and Venice-scale BA (reference ``bal_example``
PCG), each with sec/iter, chi2 trajectory anchors, time-to-reference-chi2,
and an MFU estimate from the analytic FLOP model
(``g2o_tpu/utils/flops.py`` — algorithmic FLOPs, conservative).  Stats
schema mirrors the reference's ``ba_benchmark`` dump
(``g2o/examples/ba/ba_benchmark.cpp:126-136``).
"""

import io
import json
import os
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))


def _ref():
    path = os.path.join(_HERE, "baseline_measured.json")
    if os.path.exists(path):
        with open(path) as fh:
            return json.load(fh)
    return {}


def _time_to_chi2(res, sec_per_iter, target):
    chis = res["chi2_per_iteration"] + [res["chi2_final"]]
    return next((round(i * sec_per_iter, 4)
                 for i, c in enumerate(chis) if c <= target), None)


def _memory_analysis(p, solver, n_iters):
    """``compiled.memory_analysis()`` of the fused LM program that
    ``optimize_fused`` cached on ``p`` (byte counts as XLA reports them)."""
    import jax.numpy as jnp

    (run,) = p._lm_runner_cache.values()
    sstate = getattr(solver, "state0", None)
    if sstate is None or not hasattr(solver, "_solve_state_fn"):
        sstate = jnp.zeros((), p.dtype)
    mem = run.lower(p.data, p.estimates, jnp.asarray(-1e-5, p.dtype),
                    jnp.asarray(2.0, p.dtype),
                    jnp.asarray(n_iters, jnp.int32), solver.aux,
                    sstate).compile().memory_analysis()
    return {k: int(getattr(mem, k)) for k in dir(mem)
            if k.endswith("_in_bytes")}


def _run(p, solver, n_iters, mfu_device, memory=False):
    """Warm-up + timed run from the original estimates; returns stats.
    ``memory``: also report the fused program's memory analysis."""
    import jax.numpy as jnp
    import numpy as np

    from g2o_tpu.core.lm_fused import optimize_fused
    from g2o_tpu.utils.flops import mfu_report

    est0 = {t: np.array(v) for t, v in p.estimates.items()}
    optimize_fused(p, solver, 2)                 # warm-up/compile
    p.set_estimates({t: jnp.asarray(v, dtype=p.dtype)
                     for t, v in est0.items()})
    solver._host_state = None
    res = optimize_fused(p, solver, n_iters)
    sec_per_iter = res["wall_s"] / max(res["iterations"], 1)
    out = {
        "sec_per_iter": round(sec_per_iter, 6),
        "iters_per_sec": round(res["iterations"] / res["wall_s"], 4),
        "iterations": res["iterations"],
        "chi2_initial": res["chi2_per_iteration"][0],
        "chi2_final": res["chi2_final"],
        "cg_iterations_total": int(sum(res.get("cg_per_iteration", []))),
        "levenberg_trials_total": int(sum(res["trials_per_iteration"])),
    }
    mfu = mfu_report(p, solver, res, mfu_device)
    if mfu:
        out["mfu"] = {k: (round(v, 6) if k.startswith("mfu") else
                          round(v / 1e12, 4))
                      for k, v in mfu.items()}
        out["mfu"]["_units"] = "TFLOP totals / TFLOP-per-s / ratio"
    if memory:
        out["memory_analysis"] = _memory_analysis(p, solver, n_iters)
    return res, sec_per_iter, out


def bench_sphere(dev):
    import jax.numpy as jnp

    import g2o_tpu.types  # noqa: F401  (register tags)
    from g2o_tpu.core.solvers import PCGSolver
    from g2o_tpu.io import g2o_format
    from g2o_tpu.sim.generators import create_sphere

    t0 = time.perf_counter()
    ref_sphere = os.path.join(_HERE, "data", "sphere2500.g2o")
    if os.path.exists(ref_sphere):
        g = g2o_format.load(ref_sphere)
        dataset = "sphere2500 (reference create_sphere)"
    else:
        g = create_sphere(nodes_per_level=50, laps=50, radius=100.0, seed=0)
        dataset = "sphere2500 (synthetic)"
    g.set_robust_kernel("Huber", 1.0)
    build_s = time.perf_counter() - t0
    # DEFAULT-precision assembly (TF32 on the GPU): sphere stops far from
    # the noise floor (chi2 ~29.6k), so the assembly rounding does not
    # decide whether the reference band is crossed
    p = g.compile(assembly_precision="default", dtype=jnp.float32)
    # chunked block-tridiagonal preconditioner + eta-forcing tol (sweep
    # notes: ROADMAP.md round-1 item 1) — best measured time-to-target
    solver = PCGSolver(max_iter=50, tol=1e-1, precond="chunk", chunk_size=16)
    res, sec_per_iter, out = _run(p, solver, 50, dev)

    ref = _ref().get("sphere2500", {})
    vs = (ref.get("sec_per_lm_iter", 0) / sec_per_iter
          if ref.get("sec_per_lm_iter") else 0.0)
    tt = None
    if ref.get("chi2_after_50_iters") and "reference" in dataset:
        tt = _time_to_chi2(res, sec_per_iter,
                           ref["chi2_after_50_iters"] * 1.01)
    out.update(dataset=dataset, build_s=round(build_s, 2),
               solver="PCG chunk16 tol=0.1 (fused LM)",
               vs_baseline=round(vs, 4), time_to_reference_chi2_s=tt,
               reference_sec_per_iter=ref.get("sec_per_lm_iter"))
    return out


def bench_manhattan(dev):
    import jax.numpy as jnp

    import g2o_tpu.types  # noqa: F401
    from g2o_tpu.core.lm_fused import optimize_fused_gn
    from g2o_tpu.core.solvers import PCGSolver
    from g2o_tpu.sim.generators import create_manhattan

    t0 = time.perf_counter()
    g = create_manhattan(n_poses=3500, seed=0)
    p = g.compile(dtype=jnp.float32)
    build_s = time.perf_counter() - t0
    # PHASE 1 — fast descent: two-level Schwarz preconditioner (chunk
    # solves + coarse chunk-graph correction propagating loop closures);
    # cap=32/tol=1e-2 bounds the spiky late solves.  Exact-f32 assembly
    # (the compile default): a reduced-precision assembly floors the
    # trajectory above even the +1% band.
    # every_k preconditioner refresh: a lax.cond-gated rebuild of the
    # chunk2 preconditioner (chunk Cholesky + coarse inverse) every 8th
    # solve inside the fused loop keeps the trajectory while skipping
    # most of the builds
    solver = PCGSolver(max_iter=32, tol=1e-2, precond="chunk2",
                       chunk_size=16, precond_mode="every_k",
                       precond_refresh_every=8)
    res, sec_per_iter, out = _run(p, solver, 60, dev)

    # PHASE 2 — polish to the reference chi2 (NO band): Gauss-Newton with
    # near-exact solves (deep CG + tight carry + exact-f32 matvecs)
    # crosses the reference lm_var 30-iter chi2 in ~3 iterations from the
    # fast plateau (9187 -> 9140 <= 9146.5).
    deep = PCGSolver(max_iter=128, tol=1e-6, precond="chunk2",
                     chunk_size=16, carry_factor=0.01,
                     matvec_precision="highest")
    import numpy as np

    import jax.numpy as jnp

    est_plateau = {t: np.array(v) for t, v in p.estimates.items()}
    optimize_fused_gn(p, deep, 1)                 # warm-up/compile
    p.set_estimates({t: jnp.asarray(v, dtype=p.dtype)
                     for t, v in est_plateau.items()})
    t1 = time.perf_counter()
    res2 = optimize_fused_gn(p, deep, 6)
    polish_wall = time.perf_counter() - t1
    spi2 = polish_wall / max(res2["iterations"], 1)

    # PHASE 3 — the gn_var fixed point: the reference's BEST manhattan
    # config (CSparse f64 GN) converges to chi2 9116.756 in 6 iterations.
    # The Jacobi-scaled Hessian has kappa ~2e9, beyond ANY f32 solve
    # (direct or CG both floor ~9135-9155), and an all-device f64 deep-CG
    # route needs ~1100 f64-CG iterations per GN solve — so this exact
    # tail runs the HYBRID: f64 linearize + H/b assembly on the device
    # (one fused jit, ~0.5 MB shipped), native host sparse Cholesky
    # (native/hostchol.cpp) for the sequential factorization,
    # apples-to-apples with the reference's own CSparse-on-CPU gn_var —
    # from the ORIGINAL estimates, like the reference run.  Reference:
    # optimization_algorithm_gauss_newton.cpp:50, baseline_measured.json
    # chi2_converged.
    from g2o_tpu.core.solvers.host_chol import (HostCholSolver,
                                                optimize_gn_host)

    p64 = g.compile(dtype=jnp.float64)
    est_orig = {t: np.array(v) for t, v in p64.estimates.items()}
    host = HostCholSolver().setup(p64)
    optimize_gn_host(p64, host, 2)                # warm-up/compile
    p64.set_estimates({t: jnp.asarray(v, dtype=jnp.float64)
                       for t, v in est_orig.items()})
    res3 = optimize_gn_host(p64, host, 8)
    exact_wall = res3["wall_s"]
    spi3 = exact_wall / max(res3["iterations"], 1)
    chis3 = res3["chi2_per_iteration"] + [res3["chi2_final"]]
    gn_target = _ref().get("manhattan3500", {}).get("chi2_converged",
                                                    9116.757)
    cross3 = next((i for i, c in enumerate(chis3)
                   if c <= gn_target + 0.25), None)

    ref = _ref().get("manhattan3500", {})
    vs = vs_tt = 0.0
    tt = None
    target = ref.get("lm_var_chi2_after_30_iters")
    if target:
        tt = _time_to_chi2(res, sec_per_iter, target * 1.01)
        ref_tt = 30 * ref.get("lm_var_sec_per_iter", 0.01)
        if tt:
            vs_tt = ref_tt / tt
    if ref.get("lm_var_sec_per_iter"):
        vs = ref["lm_var_sec_per_iter"] / sec_per_iter
    # wall time until the TRUE reference chi2 (no band): fast-phase wall +
    # polish iterations until crossing
    tt_exact = None
    if target:
        chis2 = res2["chi2_per_iteration"] + [res2["chi2_final"]]
        cross = next((i for i, c in enumerate(chis2) if c <= target), None)
        if cross is not None:
            tt_exact = round(res["wall_s"] + cross * spi2, 3)
    # wall to the gn_var fixed point: the hybrid GN runs from the ORIGINAL
    # estimates (the reference gn_var trajectory), so its crossing prefix
    # IS the whole time — no fast/polish phase in front
    tt_gn = None
    if cross3 is not None:
        tt_gn = round(sum(res3["iter_walls"][:cross3]), 3)
    ref_gn_total = ref.get("sec_per_gn_iter", 0.0112) * \
        (ref.get("converged_at_iteration", 5) + 1)
    out["chi2_final"] = res3["chi2_final"]
    out.update(dataset="manhattan3500 (create_manhattan seed=0)",
               build_s=round(build_s, 2),
               solver="PCG chunk2(16) tol=1e-2 cap=32 every8-refresh "
                      "(fused LM) + GN deep-CG polish + hybrid host-chol "
                      "f64 GN exact",
               polish={"algorithm": "GN, chunk2 cap=128 tol=1e-6 "
                                    "carry=0.01 matvec=HIGHEST",
                       "iterations": res2["iterations"],
                       "sec_per_iter": round(spi2, 5),
                       "chi2_final": res2["chi2_final"]},
               exact={"algorithm": "f64 GN from scratch, hybrid host "
                                   "native sparse Cholesky "
                                   "(native/hostchol.cpp)",
                      "iterations": res3["iterations"],
                      "sec_per_iter": round(spi3, 4),
                      "iter_walls": [round(w, 4)
                                     for w in res3["iter_walls"]],
                      "chi2_final": res3["chi2_final"],
                      "reference_gn_var_chi2": gn_target,
                      "time_to_gn_var_chi2_s": tt_gn,
                      "reference_gn_var_time_s": round(ref_gn_total, 4)},
               vs_baseline=round(vs, 4),
               time_to_reference_chi2_s=tt,
               time_to_reference_chi2_exact_s=tt_exact,
               vs_baseline_time_to_chi2=round(vs_tt, 4),
               reference_sec_per_iter=ref.get("lm_var_sec_per_iter"),
               reference_chi2_after_30_iters=target)
    return out


def _bench_bal(dev, n_cams, n_pts, n_obs_per_point, n_iters, ref_key,
               label, matvec="auto", deflate=False, bucket=True,
               memory=False):
    import jax.numpy as jnp

    from g2o_tpu.core.solvers.schur_implicit import ImplicitSchurSolver
    from g2o_tpu.io.bal import load_bal_problem, synthetic_bal_cached

    # disk-cached dataset (data/bal_cache) — the reference's bal_example
    # loads BAL files from disk too, so build_s compares like for like
    text = synthetic_bal_cached(n_cameras=n_cams, n_points=n_pts,
                                n_obs_per_point=n_obs_per_point,
                                pixel_noise=1.0, seed=0)

    # loaded EXACTLY as the reference's bal_example loads it (no robust
    # kernel, unperturbed estimates, and NO fixed camera — bal_example
    # leaves the full gauge to lambda damping; fixing camera 0 constrains
    # the problem to a different optimum, measured +4 chi2 units at the
    # ladybug floor): chi2 and per-iteration time compare 1:1 with
    # baseline_measured.json.  ``bucket=False`` loads without the
    # degree-bucketed landmark plan, so the solver's layout="auto" takes
    # the rows/segment_sum path instead of the bucketed one-hot one.
    t0 = time.perf_counter()
    p = load_bal_problem(io.StringIO(text), huber=0.0,
                         bucket_landmarks=bucket, fix_first_camera=False,
                         dtype=jnp.float32)
    build_cold_s = time.perf_counter() - t0
    kw = dict(max_iter=100, tol=1e-2, precond="jacobi",
              matvec_precision=matvec)
    if deflate:
        # free-gauge λ→0 solves are near-singular (the 7-dim gauge orbit);
        # projecting the analytic gauge basis out of the Schur CG removes
        # the λ-eigenvalue cluster from the Krylov space — at venice
        # scale the late-iteration 100-cap CG blowout disappears (max 21
        # iters).  At ladybug/stress scale it changed nothing —
        # venice-only.
        from g2o_tpu.types.bal import bal_gauge_basis
        kw["deflate_basis"] = bal_gauge_basis(p)
    solver = ImplicitSchurSolver(**kw)
    res, sec_per_iter, out = _run(p, solver, n_iters, dev, memory=memory)

    ref = _ref().get(ref_key, {})
    vs = (ref.get("sec_per_lm_iter_pcg", 0) / sec_per_iter
          if ref.get("sec_per_lm_iter_pcg") else 0.0)
    tt = None
    if ref.get("chi2_after_10_iters"):
        tt = _time_to_chi2(res, sec_per_iter,
                           ref["chi2_after_10_iters"] * 1.01)
    out.update(dataset=label, build_cold_s=round(build_cold_s, 1),
               n_observations=p.num_edges,
               solver="implicit Schur CG tol=1e-2 (fused LM, "
                      + ("bucketed)" if bucket else "rows)")
                      + (" + gauge deflation" if deflate else ""),
               vs_baseline=round(vs, 4), time_to_reference_chi2_s=tt,
               reference_sec_per_iter=ref.get("sec_per_lm_iter_pcg"),
               reference_chi2_after_10_iters=ref.get("chi2_after_10_iters"))
    return out


def bench_stress(dev):
    """Ill-conditioned synthetic BA: log-normal depths,
    hub-camera degree skew, 7% outliers + Huber, perturbed estimates —
    the config where preconditioner quality and the robust kernel earn
    their claims (CG counts grow 4->70 over 10 iters vs 3-9 on the easy
    Venice scene).  Reference: Huber-patched ``bal_example`` PCG on the
    identical file (``baseline_measured.json`` "bal_stress")."""
    import jax.numpy as jnp

    from g2o_tpu.core.solvers.schur_implicit import ImplicitSchurSolver
    from g2o_tpu.io.bal import load_bal_problem, stress_bal_cached

    text = stress_bal_cached()

    # free gauge, like the reference run (see _bench_bal note)
    t0 = time.perf_counter()
    p = load_bal_problem(io.StringIO(text), huber=1.0,
                         bucket_landmarks=True,
                         fix_first_camera=False, dtype=jnp.float32)
    build_cold_s = time.perf_counter() - t0
    # schur-jacobi preconditioner: ~10% fewer CG iterations than
    # Hpp-jacobi on this conditioning; exact-f32 matvecs: reduced-
    # precision S·v noise stalls CG at the cap under this conditioning
    # (chi2@10 13368517 vs 13338690)
    solver = ImplicitSchurSolver(max_iter=100, tol=1e-2,
                                 precond="schur_jacobi",
                                 matvec_precision="highest")
    res, sec_per_iter, out = _run(p, solver, 10, dev)

    ref = _ref().get("bal_stress", {})
    vs = (ref.get("sec_per_lm_iter_pcg", 0) / sec_per_iter
          if ref.get("sec_per_lm_iter_pcg") else 0.0)
    tt = None
    if ref.get("chi2_after_10_iters"):
        tt = _time_to_chi2(res, sec_per_iter,
                           ref["chi2_after_10_iters"] * 1.01)
    out.update(dataset="synthetic-stress120 (make_stress_bal seed=0)",
               build_cold_s=round(build_cold_s, 1),
               n_observations=p.num_edges,
               solver="implicit Schur CG tol=1e-2 schur_jacobi (fused LM, "
                      "bucketed) + Huber",
               vs_baseline=round(vs, 4), time_to_reference_chi2_s=tt,
               reference_sec_per_iter=ref.get("sec_per_lm_iter_pcg"),
               reference_chi2_after_10_iters=ref.get("chi2_after_10_iters"))
    return out


RUNNERS = [
    ("sphere2500", bench_sphere),
    ("manhattan3500", bench_manhattan),
    # exact-f32 matvecs: at DEFAULT precision the S·v products stall CG at
    # the cap once LM converges (ladybug chi2@10 48791.0 vs the reference
    # 48790.33; highest reaches 48790.34 at the same speed)
    ("ladybug_ba", lambda dev: _bench_bal(
        dev, 49, 7000, 5, 10, "ladybug_ba", "synthetic-ladybug49",
        matvec="highest")),
    ("venice_ba", lambda dev: _bench_bal(
        dev, 800, 150_000, 6, 10, "venice_ba",
        "synthetic-venice800 (see BASELINE.md synthetic caveat)",
        deflate=True, memory=True)),
    ("bal_stress", bench_stress),
]


def main(argv=None) -> int:
    """Run every config of :data:`RUNNERS` on the GPU; print ONE compact
    JSON line on stdout and write the full result to ``--out``.  Returns
    1 when any config raised (what finished is still written)."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(_HERE, "bench_result.json"),
                    help="full JSON result (default: %(default)s)")
    args = ap.parse_args(argv)

    import jax

    from g2o_tpu.utils.cache import enable_compile_cache
    from g2o_tpu.utils.device import card_info, device_summary, require_gpu

    # x64 is needed by the manhattan_exact f64 polish phase (the gn_var
    # fixed point needs an f64-quality solve); every other config passes
    # dtype=float32 explicitly so nothing else widens
    jax.config.update("jax_enable_x64", True)
    enable_compile_cache()
    dev = require_gpu()
    device = device_summary(dev)
    card = card_info()

    configs = {}
    errors = {}
    for name, fn in RUNNERS:
        try:
            configs[name] = fn(dev)
        except Exception as e:          # noqa: BLE001 — report, keep going
            import traceback

            errors[name] = f"{type(e).__name__}: {e}"
            traceback.print_exc(file=sys.stderr)
    for c in configs.values():
        if "mfu" in c:
            c["mfu"]["card"] = card

    head = configs.get("sphere2500", {})
    result = {
        "metric": "LM iterations/sec, sphere2500 (SE3+Huber, PCG) "
                  "[+configs in extra.configs]",
        "value": head.get("iters_per_sec", 0.0),
        "unit": "iter/s",
        "vs_baseline": head.get("vs_baseline", 0.0),
        "extra": {
            "device": device,
            "card": card,
            "configs": configs,
            **({"errors": errors} if errors else {}),
        },
    }
    with open(args.out, "w") as fh:
        fh.write(json.dumps(result) + "\n")
    # the stdout line stays COMPACT (headline + per-config essentials);
    # detail stays in the --out file
    compact_cfgs = {}
    for name, c in configs.items():
        cc = {"sec_per_iter": c.get("sec_per_iter"),
              "chi2_final": c.get("chi2_final"),
              "vs_baseline": c.get("vs_baseline")}
        for k in ("time_to_reference_chi2_exact_s", "build_cold_s"):
            if c.get(k) is not None:
                cc[k] = c[k]
        compact_cfgs[name] = cc
    compact = {
        "metric": result["metric"],
        "value": result["value"],
        "unit": "iter/s",
        "vs_baseline": result["vs_baseline"],
        "device": device,
        "card": card,
        "configs": compact_cfgs,
        **({"errors": errors} if errors else {}),
    }
    print(json.dumps(compact, separators=(",", ":")), flush=True)
    return 1 if errors else 0


if __name__ == "__main__":
    # the JSON line must be the ONLY thing on the real stdout: XLA and absl
    # can write to fd 1 directly at the C level, so fd 1 points at stderr
    # for the whole run and the JSON goes to a saved copy of it
    json_fd = os.dup(1)
    os.dup2(2, 1)
    sys.stdout = os.fdopen(json_fd, "w")
    sys.exit(main())
