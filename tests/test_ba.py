"""Bundle-adjustment end-to-end: synthetic scene (reference ``ba_demo.cpp``
analogue), Schur-complement solver, marginalized landmarks."""

import numpy as np
import pytest

from g2o_tpu.core.optimizer import LevenbergMarquardt, SparseOptimizer
from g2o_tpu.core.solvers import DenseSolver, SchurSolver
from g2o_tpu.sim.generators import create_ba_scene


@pytest.fixture(scope="module")
def scene():
    g, true_points = create_ba_scene(
        n_cameras=8, n_points=60, pixel_noise=0.0, point_noise=0.3, seed=1
    )
    return g, true_points


def test_ba_schur_converges(scene):
    g, true_points = scene
    p = g.compile()
    opt = SparseOptimizer(p, algorithm=LevenbergMarquardt(),
                          solver=SchurSolver())
    chi0 = opt.chi2()
    opt.optimize(15)
    chi1 = opt.chi2()
    assert chi1 < 1e-8 * max(chi0, 1.0)
    # landmarks recovered (noise-free observations -> exact)
    for vid, truth in true_points.items():
        est = p.get_estimate(vid)
        np.testing.assert_allclose(est, truth, atol=1e-4)


def test_ba_schur_matches_dense(scene):
    """Schur elimination must produce the same step as solving the full
    system (it is algebraically exact)."""
    g, _ = scene
    p1 = g.compile()
    p2 = g.compile()
    lin1 = p1.linearize_jit(p1.data, p1.estimates)
    s_schur = SchurSolver().setup(p1)
    s_dense = DenseSolver().setup(p2)
    lam = 1e-4
    dx1 = np.asarray(s_schur.solve(p1.data, lin1, lam))
    dx2 = np.asarray(s_dense.solve(p2.data, lin1, lam))
    np.testing.assert_allclose(dx1, dx2, atol=1e-8)


def test_ba_with_outliers_huber():
    g, true_points = create_ba_scene(
        n_cameras=8, n_points=60, pixel_noise=0.5, point_noise=0.3,
        outlier_ratio=0.1, seed=2
    )
    g.set_robust_kernel("Huber", 2.0, etype="EDGE_PROJECT_XYZ2UV:EXPMAP")
    p = g.compile()
    opt = SparseOptimizer(p, algorithm=LevenbergMarquardt(),
                          solver=SchurSolver())
    opt.optimize(15)
    # robustified BA should still land near ground truth
    errs = []
    for vid, truth in true_points.items():
        est = p.get_estimate(vid)
        errs.append(np.linalg.norm(est - truth))
    # narrow-baseline geometry amplifies depth error; require clear
    # improvement over the 0.3-sigma initialisation noise
    assert np.median(errs) < 0.15


def test_schur_rejects_partial_marginalization():
    g, truth = create_ba_scene(n_cameras=3, n_points=5, seed=3)
    g.set_marginalized(next(iter(truth)), False)  # un-marginalize one point
    p = g.compile()
    with pytest.raises(NotImplementedError):
        SchurSolver().setup(p)


def test_implicit_schur_matches_explicit(scene):
    from g2o_tpu.core.solvers.schur_implicit import ImplicitSchurSolver

    g, _ = scene
    p = g.compile()
    lin = p.linearize_jit(p.data, p.estimates)
    lam = 1e-3
    dx_e = np.asarray(SchurSolver().setup(p).solve(p.data, lin, lam))
    dx_i = np.asarray(
        ImplicitSchurSolver(max_iter=500, tol=1e-12).setup(p)
        .solve(p.data, lin, lam))
    rel = np.linalg.norm(dx_i - dx_e) / np.linalg.norm(dx_e)
    assert rel < 1e-8


@pytest.mark.parametrize("layout", ["rows", "bucketed"])
@pytest.mark.parametrize("precond", ["jacobi", "schur_jacobi"])
def test_implicit_schur_variants_match_explicit(scene, layout, precond):
    """The bucketed observation layout (degree-bucketed reshape reductions +
    one-hot camera matmuls) and the Schur-Jacobi preconditioner must not
    change the solution — only the cost per CG iteration / the iteration
    count."""
    from g2o_tpu.core.solvers.schur_implicit import ImplicitSchurSolver

    g, _ = scene
    p = g.compile()
    lin = p.linearize_jit(p.data, p.estimates)
    lam = 1e-3
    dx_e = np.asarray(SchurSolver().setup(p).solve(p.data, lin, lam))
    s = ImplicitSchurSolver(max_iter=500, tol=1e-13, precond=precond,
                            layout=layout).setup(p)
    dx = np.asarray(s._solve_jit(p.data, lin, lam, s.aux))
    rel = np.linalg.norm(dx - dx_e) / np.linalg.norm(dx_e)
    assert rel < 1e-8


def test_implicit_schur_bucketed_padded_edges(scene):
    """Inactive padding rows (W == 0) must not perturb the bucketed
    reductions."""
    from g2o_tpu.core.solvers.schur_implicit import ImplicitSchurSolver

    g, _ = scene
    p = g.compile()
    pp = g.compile(pad_edges_to_multiple=64)
    lam = 1e-3
    lin = p.linearize_jit(p.data, p.estimates)
    linp = pp.linearize_jit(pp.data, pp.estimates)
    s0 = ImplicitSchurSolver(max_iter=300, tol=1e-13).setup(p)
    s1 = ImplicitSchurSolver(max_iter=300, tol=1e-13,
                             layout="bucketed").setup(pp)
    dx0 = np.asarray(s0._solve_jit(p.data, lin, lam, s0.aux))
    dx1 = np.asarray(s1._solve_jit(pp.data, linp, lam, s1.aux))
    np.testing.assert_allclose(dx0, dx1, rtol=1e-7, atol=1e-10)


def test_implicit_schur_full_lm(scene):
    from g2o_tpu.core.lm_fused import optimize_fused
    from g2o_tpu.core.solvers.schur_implicit import ImplicitSchurSolver

    g, _ = scene
    p = g.compile()
    res = optimize_fused(p, ImplicitSchurSolver(max_iter=200, tol=1e-8), 10)
    assert res["chi2_final"] < 1e-4 * res["chi2_per_iteration"][0]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_schur_segment_sum_matches_dense(dtype):
    """The explicit Schur solver's pair aggregation (``segment_sum`` into
    unique camera-block pairs) solves the damped system as well as the
    dense solver does, in f32 and f64.  Measured by the relative residual
    in the f64 system (backward error, independent of the system's
    conditioning, ~1e8 here): the dense solve reaches ~3e-7 (f32) and
    ~5e-16 (f64), the Schur reduction ~6e-5 and ~7e-14; the limits leave
    a factor of ten."""
    import jax.numpy as jnp

    g, _ = create_ba_scene(n_cameras=6, n_points=50, pixel_noise=0.5,
                           point_noise=0.2, seed=5)
    p64 = g.compile(dtype=jnp.float64)
    lin64 = p64.linearize_jit(p64.data, p64.estimates)
    lam = 1e-3
    H = np.asarray(p64.dense_hessian_fn(p64.data, lin64))
    A = H + lam * np.eye(len(H))
    b = np.asarray(lin64.b)

    p = g.compile(dtype=jnp.dtype(dtype))
    lin = p.linearize_jit(p.data, p.estimates)
    lam_t = jnp.asarray(lam, p.dtype)
    limit = 5e-4 if dtype == "float32" else 1e-12
    for solver in (SchurSolver(), DenseSolver()):
        dx = np.asarray(solver.setup(p).solve(p.data, lin, lam_t),
                        np.float64)
        resid = np.linalg.norm(A @ dx - b) / np.linalg.norm(b)
        assert resid <= limit, (solver.name, resid)
