"""Round-4 precision semantics: wide-linearize mixed mode and the
f32-preconditioned f64 CG reach the same fixed points as full f64."""
import numpy as np
import jax
import jax.numpy as jnp

import g2o_tpu.types  # noqa: F401
from g2o_tpu.core.lm_fused import optimize_fused_gn
from g2o_tpu.core.solvers import DenseSolver, PCGSolver
from g2o_tpu.sim.generators import create_manhattan


def _gn_fixed_point(p, solver, iters=8):
    res = optimize_fused_gn(p, solver, iters)
    return float(res["chi2_final"])


def test_wide_linearize_reaches_f64_fixed_point():
    """Mixed (f32 solver dtype + f64 state) GN+dense must land on the
    same fixed point as full f64 — the wide H/b assembly with ONE
    terminal rounding preserves it (f32 assembly floors ~17 units high
    on manhattan-like graphs)."""
    g = create_manhattan(n_poses=250, seed=5)
    p64 = g.compile(dtype=jnp.float64)
    c64 = _gn_fixed_point(p64, DenseSolver())
    pmx = g.compile(dtype=jnp.float32, state_dtype=jnp.float64)
    cmx = _gn_fixed_point(pmx, DenseSolver())
    # mixed solves in f32 (rate-only): same optimum to f32-noise scale
    assert abs(cmx - c64) <= 1e-4 * max(c64, 1.0)


def test_precond_dtype_f32_matches_f64_precond():
    """PCGSolver(precond_dtype=f32) under an f64 problem solves the same
    system: both CG variants must agree with the DIRECT f64 solution in
    norm.  (A single solve's attainable accuracy under an f32-applied
    preconditioner floors around ~1e-7 relative — flexible-CG rounding —
    which is exactly the 'rate-only' contract: the GN fixed point, where
    b -> 0, is unaffected.)"""
    g = create_manhattan(n_poses=250, seed=5)
    p = g.compile(dtype=jnp.float64)
    lin = p.linearize_jit(p.data, p.estimates)
    lam = jnp.asarray(1e-3, p.dtype)
    ref_solver = DenseSolver()
    ref_solver.setup(p)
    ref = np.asarray(ref_solver.solve(p.data, lin, lam))
    nref = np.linalg.norm(ref)
    for pd in (None, jnp.float32):
        s = PCGSolver(max_iter=2048, tol=1e-10, precond="chunk2",
                      chunk_size=16, carry_factor=0.0, precond_dtype=pd)
        s.setup(p)
        x = np.asarray(s.solve(p.data, lin, lam))
        assert np.linalg.norm(x - ref) <= 1e-4 * nref, pd


def test_hvp_f64_broadcast_matches_einsum_form():
    """The f64 broadcast-lane hvp (elementwise instead of tiny f64 dots) must equal
    the f32-path einsum formulation up to dtype noise."""
    g = create_manhattan(n_poses=120, seed=2)
    p64 = g.compile(dtype=jnp.float64)
    p32 = g.compile(dtype=jnp.float32)
    lin64 = p64.linearize_jit(p64.data, p64.estimates)
    lin32 = p32.linearize_jit(p32.data, p32.estimates)
    rng = np.random.default_rng(0)
    v = rng.standard_normal(p64.total_dim)
    h64 = np.asarray(p64.hvp_fn(p64.data, lin64, jnp.asarray(v)))
    h32 = np.asarray(p32.hvp_fn(p32.data, lin32,
                                jnp.asarray(v, jnp.float32)))
    scale = np.abs(h64).max()
    assert np.abs(h64 - h32).max() <= 1e-4 * scale
