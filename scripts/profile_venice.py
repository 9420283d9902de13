"""Phase-level profile of one Venice-scale LM iteration on the GPU.

Times each jitted phase separately (linearize / solver solve / apply+chi2)
with block_until_ready over many reps.  Isolated op timings include
dispatch overhead that the fused loop does not pay — fine at the
10-200 ms phase scale profiled here.

Usage: python scripts/profile_venice.py [N_CAMS] [N_PTS] [REPS]
"""

import io
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timeit(fn, *args, reps=10, **kw):
    import jax
    out = fn(*args, **kw)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args, **kw)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps, out


def main():
    import jax

    from g2o_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from g2o_tpu.core.solvers.schur_implicit import ImplicitSchurSolver
    from g2o_tpu.io.bal import load_bal_problem, synthetic_bal_cached

    n_cams = int(sys.argv[1]) if len(sys.argv) > 1 else 800
    n_pts = int(sys.argv[2]) if len(sys.argv) > 2 else 150_000
    reps = int(sys.argv[3]) if len(sys.argv) > 3 else 10

    t0 = time.perf_counter()
    text = synthetic_bal_cached(n_cameras=n_cams, n_points=n_pts,
                              n_obs_per_point=6, pixel_noise=1.0, seed=0)
    p = load_bal_problem(io.StringIO(text), huber=0.0, bucket_landmarks=True)
    print(f"build: {time.perf_counter() - t0:.1f}s, edges={p.num_edges}",
          flush=True)

    solver = ImplicitSchurSolver(max_iter=100, tol=1e-2, precond="jacobi")
    solver.setup(p)
    lam = jnp.asarray(1e-3, dtype=p.dtype)

    t, lin = timeit(p.linearize_jit, p.data, p.estimates, reps=reps)
    print(f"linearize:      {t*1e3:8.1f} ms", flush=True)

    t, (dx, carry, st) = timeit(solver._solve_state_jit, p.data, lin, lam,
                                solver.aux, solver.state0, reps=reps)
    print(f"solve (state0): {t*1e3:8.1f} ms  cg_iters={int(st['cg_iterations'])}",
          flush=True)

    t, _ = timeit(solver._solve_state_jit, p.data, lin, lam, solver.aux,
                  carry, reps=reps)
    print(f"solve (carry):  {t*1e3:8.1f} ms", flush=True)

    t, est2 = timeit(p.apply_jit, p.data, p.estimates, dx, reps=reps)
    print(f"apply:          {t*1e3:8.1f} ms", flush=True)

    t, _ = timeit(p.chi2_jit, p.data, est2, reps=reps)
    print(f"chi2:           {t*1e3:8.1f} ms", flush=True)

    # CG marginal cost: solve at two max_iter settings, same tol=0 to force
    # the full budget
    s10 = ImplicitSchurSolver(max_iter=10, tol=0.0, precond="jacobi").setup(p)
    s40 = ImplicitSchurSolver(max_iter=40, tol=0.0, precond="jacobi").setup(p)
    t10, _ = timeit(s10._solve_jit, p.data, lin, lam, s10.aux, reps=reps)
    t40, _ = timeit(s40._solve_jit, p.data, lin, lam, s40.aux, reps=reps)
    print(f"solve x10 iters: {t10*1e3:8.1f} ms; x40: {t40*1e3:8.1f} ms; "
          f"marginal CG iter: {(t40-t10)/30*1e3:6.2f} ms; "
          f"setup+fixed: {(t10 - (t40-t10)/3)*1e3:6.1f} ms", flush=True)


if __name__ == "__main__":
    main()
