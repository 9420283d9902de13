#!/usr/bin/env python3
"""End-to-end check that g2o_tpu runs on one NVIDIA GPU.

    python chip_smoke.py               # one card: phases 0-5
    python chip_smoke.py --four-gpus   # four cards: the sharded dry run only

Every phase prints one JSON line with its seconds and what it checked.
Every phase runs; any failed phase or gate makes the script exit non-zero
once the rest have run.  The last line of
stdout is ``{"ok": true, "device": {"platform", "kind", "count"}}`` and is
printed only when everything passed.

Phases (one card):

0. device — the first JAX device must be a GPU; nothing falls back to the
   CPU.  The card's name and power limit come from ``nvidia-smi`` first.
1. ``pytest -m gpu`` in a child process.  The ``nvidia-smi`` read and this
   child both end before this process makes its first JAX call, so no two
   JAX processes ever hold the card at once.
2. sphere2500 (Huber, fused LM, chunk PCG) through the quick-start API:
   load, compile, optimize_fused, save; then the CLI in-process.
3. manhattan3500 at the benchmark's settings: fused LM with the chunk2
   preconditioner, deep-CG GN polish, f64 GN with the host Cholesky.
4. venice BA (800 cameras, 900k observations), implicit Schur, 10
   iterations, with the bucketed one-hot layout and with the rows layout.
5. the plain XLA linear-algebra kernels that replaced the hand-written
   ones, against float64 references at real widths.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")

# gates: the reference g2o's own results (baseline_measured.json)
SPHERE_CHI2_50 = 29741.18                     # sphere2500 chi2 after 50 its
MANHATTAN_GN_CHI2 = 9116.756453               # manhattan gn_var converged
VENICE_CHI2_10 = 1343704.04                   # venice chi2 after 10 its


def gate(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


def emit(phase: str, t0: float, **fields):
    print(json.dumps({"phase": phase, "seconds": time.perf_counter() - t0,
                      **fields}), flush=True)


# ------------------------------------------------------------------ #
# phases 0-1: before this process touches JAX
# ------------------------------------------------------------------ #

def read_card() -> str:
    from g2o_tpu.utils.device import card_info

    card = card_info()
    # the card's name and power limit exactly as nvidia-smi gives them
    print(card, flush=True)
    return card


def phase_gpu_tests():
    """``pytest -m gpu`` in a child that owns the card while it runs."""
    t0 = time.perf_counter()
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "tests", "-m", "gpu", "-q",
         "-p", "no:cacheprovider", "-rs"],
        cwd=HERE, env=env, capture_output=True, text=True, timeout=900)
    tail = (proc.stdout + proc.stderr).strip().splitlines()[-15:]
    summary = tail[-1] if tail else ""
    emit("1_gpu_tests", t0, rc=proc.returncode, summary=summary)
    if proc.returncode != 0 or "skipped" in summary or \
            "passed" not in summary:
        print("\n".join(tail), file=sys.stderr)
        raise AssertionError(f"pytest -m gpu: rc={proc.returncode}: "
                             f"{summary}")


def phase_device():
    """The first JAX device must be a GPU."""
    from g2o_tpu.utils.device import device_summary, require_gpu

    t0 = time.perf_counter()
    dev = require_gpu()
    summary = device_summary(dev)
    emit("0_device", t0, **summary)
    return dev, summary


# ------------------------------------------------------------------ #
# phase 2: sphere2500 through the quick-start API and the CLI
# ------------------------------------------------------------------ #

def phase_sphere(path=os.path.join(DATA, "sphere2500.g2o"), n_iters=50,
                 chi2_gate=1.01 * SPHERE_CHI2_50):
    import jax.numpy as jnp

    import g2o_tpu.types  # noqa: F401  (register tags)
    from g2o_tpu.apps.cli import main as cli_main
    from g2o_tpu.core.lm_fused import optimize_fused
    from g2o_tpu.core.solvers import PCGSolver
    from g2o_tpu.io import g2o_format

    t0 = time.perf_counter()
    g = g2o_format.load(path)
    g.set_robust_kernel("Huber", 1.0)
    # bench.py's sphere2500 settings
    problem = g.compile(assembly_precision="default", dtype=jnp.float32)
    solver = PCGSolver(max_iter=50, tol=1e-1, precond="chunk", chunk_size=16)
    res = optimize_fused(problem, solver, n_iters)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "sphere_opt.g2o")
        g2o_format.save(g, out, estimates_by_vid=problem.estimates_by_vid())
        n_back = g2o_format.load(out).num_vertices
    emit("2_sphere2500", t0, iterations=res["iterations"],
         chi2_initial=res["chi2_per_iteration"][0],
         chi2_final=res["chi2_final"], chi2_gate=chi2_gate,
         sec_per_iter_incl_compile=res["wall_s"] / max(res["iterations"], 1))
    gate(res["chi2_final"] <= chi2_gate,
         f"sphere2500 chi2 {res['chi2_final']} > {chi2_gate}")
    gate(n_back == g.num_vertices, "sphere2500 saved file does not load back")

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cli_out.g2o")
        summ = os.path.join(tmp, "summary.json")
        rc = cli_main(["-i", "5", "-solver", "lm_pcg", "-robustKernel",
                       "Huber", path, "-o", out, "-summary", summ])
        with open(summ) as fh:
            summary = json.loads(fh.read().strip().splitlines()[-1])
        back = g2o_format.load(out)
    # the CLI fixes the gauge itself, so its start is the file's chi2
    chi2_start = float(res["chi2_per_iteration"][0])
    emit("2_cli", t0, rc=rc, chi2_start=chi2_start,
         chi2_final=summary["final_chi2"], vertices=back.num_vertices)
    gate(rc in (0, None), f"CLI exited {rc}")
    gate(summary["final_chi2"] < chi2_start, "CLI chi2 did not fall")
    gate(back.num_vertices == g.num_vertices, "CLI output does not load")


# ------------------------------------------------------------------ #
# phases 3-4: the benchmark's manhattan3500 and venice settings
# ------------------------------------------------------------------ #

def phase_manhattan(dev):
    import bench

    t0 = time.perf_counter()
    out = bench.bench_manhattan(dev)
    ex = out["exact"]
    limit = MANHATTAN_GN_CHI2 + 0.25
    emit("3_manhattan3500", t0, fast_sec_per_iter=out["sec_per_iter"],
         fast_iterations=out["iterations"],
         fast_cg_total=out["cg_iterations_total"],
         polish=out["polish"], exact_chi2=ex["chi2_final"],
         exact_sec_per_iter=ex["sec_per_iter"], chi2_gate=limit)
    gate(ex["chi2_final"] <= limit,
         f"manhattan3500 exact chi2 {ex['chi2_final']} > {limit}")


def phase_venice(dev):
    import bench

    limit = 1.01 * VENICE_CHI2_10
    for bucket in (True, False):
        t0 = time.perf_counter()
        out = bench._bench_bal(
            dev, 800, 150_000, 6, 10, "venice_ba", "synthetic-venice800",
            deflate=True, bucket=bucket, memory=bucket)
        layout = "bucketed" if bucket else "rows"
        emit(f"4_venice_{layout}", t0, sec_per_iter=out["sec_per_iter"],
             chi2_final=out["chi2_final"], chi2_gate=limit,
             cg_total=out["cg_iterations_total"],
             build_s=out["build_cold_s"],
             **({"memory_analysis": out["memory_analysis"]}
                if bucket else {}))
        gate(out["chi2_final"] <= limit,
             f"venice ({layout}) chi2@10 {out['chi2_final']} > {limit}")


# ------------------------------------------------------------------ #
# phase 5: the replaced kernels against float64 references
# ------------------------------------------------------------------ #

def _rel(a, b):
    import numpy as np

    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def check_supernodal(path=os.path.join(DATA, "sphere2500.g2o"),
                     tol_residual=1e-4):
    """Supernodal factor + solve of the damped sphere2500 system in f32
    (HIGHEST einsums, one refinement sweep) against a float64 SciPy sparse
    solve of the same system.  Gate: relative residual ``|Ax-b|/|b|`` in
    f64, a backward error that does not grow with the conditioning; an
    f32 factor reaches ~1e-6, the limit leaves a factor of 100."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import scipy.sparse
    import scipy.sparse.linalg

    import g2o_tpu.types  # noqa: F401
    from g2o_tpu.core.solvers.supernodal import SupernodalCholeskySolver
    from g2o_tpu.io import g2o_format

    t0 = time.perf_counter()
    g = g2o_format.load(path)
    g.set_fixed(min(g.vertices()), True)
    p32 = g.compile(dtype=jnp.float32)
    p64 = g.compile(dtype=jnp.float64)
    lin64 = p64.linearize_jit(p64.data, p64.estimates)
    H = np.asarray(jax.jit(p64.dense_hessian_fn)(p64.data, lin64))
    fixed = np.asarray(p64.data.fixed_flat)
    lam = 1e-5 * float(np.abs(np.diag(H)).max())
    A = scipy.sparse.csc_matrix(H + np.diag(lam * (1.0 - fixed)))
    b = np.asarray(lin64.b)
    x_ref = scipy.sparse.linalg.spsolve(A, b)

    solver = SupernodalCholeskySolver().setup(p32)
    lin32 = p32.linearize_jit(p32.data, p32.estimates)
    x = np.asarray(solver.solve(p32.data, lin32, jnp.asarray(lam, p32.dtype)),
                   dtype=np.float64)
    starts = np.asarray(solver.meta["starts"])
    max_sd = int(np.diff(starts).max()) * solver.meta["d"]
    resid = float(np.linalg.norm(A @ x - b) / np.linalg.norm(b))
    emit("5_supernodal_sphere2500", t0, n=int(A.shape[0]), max_panel=max_sd,
         precision="f32 HIGHEST, refine=1; reference f64 SciPy spsolve",
         rel_residual=resid, tol_rel_residual=tol_residual,
         rel_error_vs_f64=_rel(x, x_ref))
    gate(max_sd > 96, f"largest supernode panel {max_sd} <= 96")
    gate(resid <= tol_residual,
         f"supernodal relative residual {resid} > {tol_residual}")


def check_coarse(n_poses=3500):
    """The chunk2 preconditioner's coarse inverse at manhattan3500's size
    (f32 Cholesky + triangular solve, HIGHEST products) against the same
    coarse system inverted in float64 by NumPy.  Gate: relative error
    within ten times the f32 bound ``cond(Hc)·2^-24`` of an inverse."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import g2o_tpu.types  # noqa: F401
    from g2o_tpu.core.solvers import PCGSolver
    from g2o_tpu.sim.generators import create_manhattan

    t0 = time.perf_counter()
    p = create_manhattan(n_poses=n_poses, seed=0).compile(dtype=jnp.float32)
    solver = PCGSolver(precond="chunk2", chunk_size=16).setup(p)
    lin = p.linearize_jit(p.data, p.estimates)
    lam = jnp.asarray(1e-4, p.dtype)
    cmaps = solver.aux["chunk"]
    parts = solver._dbg_parts
    Hd = np.asarray(jax.jit(parts["coarse_assemble"])(p.data, lin, lam,
                                                      cmaps), np.float64)
    cinv = np.asarray(jax.jit(parts["coarse_full"])(p.data, lin, lam, cmaps),
                      np.float64)
    ref = np.linalg.inv(Hd)
    cond = float(np.linalg.cond(Hd))
    tol = 10.0 * cond * 2.0 ** -24
    err = _rel(cinv, ref)
    emit("5_chunk2_coarse_manhattan3500", t0, n=int(len(Hd)),
         precision="f32 (Cholesky + triangular solve, HIGHEST products); "
                   "reference f64 numpy.linalg.inv",
         cond=cond, rel_error_vs_f64=err, tol=tol)
    gate(err <= tol, f"coarse inverse relative error {err} > {tol}")


def check_schur(path=os.path.join(DATA, "bal_cache",
                                  "bal-C49-P7000-K5-N1-S0.txt.gz"),
                tol=1e-8):
    """Explicit SchurSolver (pair aggregation by ``segment_sum``) against
    DenseSolver on the ladybug-size scene, both in float64."""
    import gzip
    import io

    import jax.numpy as jnp
    import numpy as np

    from g2o_tpu.core.solvers import DenseSolver, SchurSolver
    from g2o_tpu.io.bal import load_bal_problem

    t0 = time.perf_counter()
    with gzip.open(path, "rt") as fh:
        text = fh.read()
    p = load_bal_problem(io.StringIO(text), fix_first_camera=True,
                         dtype=jnp.float64)
    lin = p.linearize_jit(p.data, p.estimates)
    lam = jnp.asarray(1e-3, p.dtype)
    dx_s = np.asarray(SchurSolver().setup(p).solve(p.data, lin, lam))
    dx_d = np.asarray(DenseSolver().setup(p).solve(p.data, lin, lam))
    err = _rel(dx_s, dx_d)
    emit("5_schur_vs_dense_ladybug", t0, n=int(dx_d.shape[0]),
         observations=p.num_edges, precision="f64 both",
         rel_diff=err, tol=tol)
    gate(err <= tol, f"SchurSolver vs DenseSolver {err} > {tol}")


# ------------------------------------------------------------------ #
# four cards: the sharded dry run
# ------------------------------------------------------------------ #

def phase_four_gpus():
    import jax

    from __graft_entry__ import dryrun_multichip

    t0 = time.perf_counter()
    gate(len(jax.devices()) >= 4,
         f"--four-gpus needs 4 devices, JAX sees {len(jax.devices())}")
    placed = dryrun_multichip(4)
    emit("four_gpus_dryrun", t0, devices_used=placed,
         checks="pose-graph PCG jacobi+chunk2, BA explicit + implicit "
                "Schur; sharded vs single-device at f64, tol 1e-8")
    gate(len(placed) == 4, f"shards landed on {placed}, not 4 devices")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the four-card sharded dry run")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(HERE, "g2o_tpu")):
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)

    read_card()
    if not args.four_gpus:
        phase_gpu_tests()

    # first JAX call of this process
    import jax

    from g2o_tpu.utils.cache import enable_compile_cache

    jax.config.update("jax_enable_x64", True)
    enable_compile_cache()
    dev, summary = phase_device()

    if args.four_gpus:
        phases = [phase_four_gpus]
    else:
        phases = [phase_sphere, lambda: phase_manhattan(dev),
                  lambda: phase_venice(dev), check_supernodal, check_coarse,
                  check_schur]
    # every phase runs, so one call reports all of them; any failure still
    # fails the script, after the rest have run
    failed = []
    for phase in phases:
        try:
            phase()
        except Exception as e:              # noqa: BLE001 — re-raised below
            traceback.print_exc(file=sys.stderr)
            failed.append(f"{type(e).__name__}: {e}")
            print(json.dumps({"failed": failed[-1]}), flush=True)
    if failed:
        print(f"{len(failed)} phase(s) failed: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
