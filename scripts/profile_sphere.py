"""Phase-level profile of one sphere2500 LM iteration (headline bench).

Usage: python scripts/profile_sphere.py [REPS]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timeit(fn, *args, reps=20, **kw):
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

    import g2o_tpu.types  # noqa: F401
    from g2o_tpu.core.solvers import PCGSolver
    from g2o_tpu.io import g2o_format

    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 20

    g = g2o_format.load(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "data", "sphere2500.g2o"))
    g.set_robust_kernel("Huber", 1.0)
    p = g.compile()
    print(f"edges={p.num_edges} T={p.total_dim}", flush=True)

    solver = PCGSolver(max_iter=50, tol=1e-1, precond="chunk", chunk_size=16)
    solver.setup(p)
    lam = jnp.asarray(1e-4, dtype=p.dtype)

    t, lin = timeit(p.linearize_jit, p.data, p.estimates, reps=reps)
    print(f"linearize:      {t*1e3:8.2f} ms", flush=True)

    if hasattr(solver, "_solve_state_jit"):
        t, out = timeit(solver._solve_state_jit, p.data, lin, lam,
                        solver.aux, solver.state0, reps=reps)
        dx = out[0]
    else:
        t, dx = timeit(solver._solve_jit, p.data, lin, lam, solver.aux,
                       reps=reps)
    print(f"solve:          {t*1e3:8.2f} ms", flush=True)

    t, est2 = timeit(p.apply_jit, p.data, p.estimates, dx, reps=reps)
    print(f"apply:          {t*1e3:8.2f} ms", flush=True)

    t, _ = timeit(p.chi2_jit, p.data, est2, reps=reps)
    print(f"chi2:           {t*1e3:8.2f} ms", flush=True)

    # CG marginal cost at fixed iteration budgets
    s10 = PCGSolver(max_iter=10, tol=0.0, precond="chunk",
                    chunk_size=16).setup(p)
    s40 = PCGSolver(max_iter=40, tol=0.0, precond="chunk",
                    chunk_size=16).setup(p)
    t10, _ = timeit(s10._solve_jit, p.data, lin, lam, s10.aux, reps=reps)
    t40, _ = timeit(s40._solve_jit, p.data, lin, lam, s40.aux, reps=reps)
    print(f"solve x10: {t10*1e3:8.2f} ms; x40: {t40*1e3:8.2f} ms; "
          f"marginal CG iter: {(t40-t10)/30*1e3:6.3f} ms; "
          f"setup+fixed: {(t10 - (t40-t10)/3)*1e3:6.2f} ms", flush=True)


if __name__ == "__main__":
    main()
