"""Square-root CGLS solver + fused-LM equivalence tests."""

import jax.numpy as jnp
import numpy as np
import pytest

from g2o_tpu.core.lm_fused import FusedLevenbergMarquardt, optimize_fused
from g2o_tpu.core.optimizer import LevenbergMarquardt, SparseOptimizer
from g2o_tpu.core.solvers import DenseSolver, PCGSolver
from g2o_tpu.core.solvers.cgls import CGLSSolver
from g2o_tpu.sim.generators import create_ba_scene, create_sphere


@pytest.fixture(scope="module")
def sphere_problem():
    return create_sphere(nodes_per_level=10, laps=4, radius=10.0, seed=7)


def test_cgls_matches_dense_step(sphere_problem):
    p = sphere_problem.compile()
    lin = p.linearize_jit(p.data, p.estimates)
    lam = 1e-3
    dx_d = np.asarray(DenseSolver().setup(p).solve(p.data, lin, lam))
    dx_c = np.asarray(
        CGLSSolver(max_iter=2000, eta=1e-18).setup(p).solve(p.data, lin, lam))
    rel = np.linalg.norm(dx_c - dx_d) / np.linalg.norm(dx_d)
    assert rel < 1e-6


def test_cgls_ba_step():
    g, _ = create_ba_scene(n_cameras=6, n_points=40, pixel_noise=0.3,
                           point_noise=0.2, seed=9)
    p = g.compile()
    lin = p.linearize_jit(p.data, p.estimates)
    dx_d = np.asarray(DenseSolver().setup(p).solve(p.data, lin, 1e-2))
    dx_c = np.asarray(
        CGLSSolver(max_iter=1000, eta=1e-16).setup(p).solve(p.data, lin, 1e-2))
    rel = np.linalg.norm(dx_c - dx_d) / np.linalg.norm(dx_d)
    assert rel < 1e-4


def test_cgls_full_lm(sphere_problem):
    p = sphere_problem.compile()
    opt = SparseOptimizer(p, algorithm=LevenbergMarquardt(),
                          solver=CGLSSolver(max_iter=200, eta=1e-8))
    chi0 = opt.chi2()
    opt.optimize(10)
    assert opt.chi2() < 0.1 * chi0


def test_fused_lm_matches_host_lm(sphere_problem):
    p1 = sphere_problem.compile()
    p2 = sphere_problem.compile()
    s1 = PCGSolver(max_iter=100, tol=1e-10)
    s2 = PCGSolver(max_iter=100, tol=1e-10)
    o1 = SparseOptimizer(p1, algorithm=LevenbergMarquardt(), solver=s1)
    o2 = SparseOptimizer(p2, algorithm=FusedLevenbergMarquardt(), solver=s2)
    o1.optimize(6)
    o2.optimize(6)
    assert o1.current_chi2 == pytest.approx(o2.current_chi2, rel=1e-6)
    # lambda schedules must also agree (identical formulas)
    assert o1.algorithm._lambda == pytest.approx(o2.algorithm._lambda,
                                                 rel=1e-6)


def test_optimize_fused_whole_run(sphere_problem):
    p = sphere_problem.compile()
    res = optimize_fused(p, PCGSolver(max_iter=100, tol=1e-10), 10)
    # the run may stop one iteration early when LM converges to machine
    # precision and every trial is rejected (valid termination; hit or
    # missed within ~1 ulp of matvec summation-order differences)
    assert res["iterations"] >= 9
    assert res["chi2_final"] < 0.1 * res["chi2_per_iteration"][0]
    # chi2 history is monotone non-increasing for accepted LM steps
    chis = res["chi2_per_iteration"]
    assert all(b <= a * (1 + 1e-12) for a, b in zip(chis, chis[1:]))


def test_optimize_fused_gain_termination(sphere_problem):
    p = sphere_problem.compile()
    res = optimize_fused(p, PCGSolver(max_iter=100, tol=1e-10), 50,
                         gain_threshold=1e-6)
    assert res["iterations"] < 50


def test_fused_gn(sphere_problem):
    from g2o_tpu.core.lm_fused import optimize_fused_gn

    p = sphere_problem.compile()
    res = optimize_fused_gn(p, DenseSolver(), 8)
    assert res["iterations"] == 8
    assert res["chi2_final"] < 0.1 * res["chi2_per_iteration"][0]


def test_lots_of_xy_edges():
    import jax.numpy as jnp

    from g2o_tpu.core.graph import Graph
    from g2o_tpu.core.optimizer import SparseOptimizer
    from g2o_tpu.ops import lie
    from g2o_tpu.types.slam2d import (
        VertexPointXY, VertexSE2, make_edge_se2_lots_of_xy,
    )

    rng = np.random.default_rng(7)
    et3 = make_edge_se2_lots_of_xy(3)
    assert make_edge_se2_lots_of_xy(3) is et3  # cached specialization
    g = Graph()
    pose = np.array([0.4, -0.2, 0.5])
    pts = rng.normal(size=(3, 2)) * 2
    g.add_vertex(0, VertexSE2, pose, fixed=True)
    for i, pt in enumerate(pts):
        g.add_vertex(1 + i, VertexPointXY, pt + rng.normal(scale=0.2, size=2))
    inv = lie.se2_inverse(jnp.asarray(pose))
    meas = np.concatenate(
        [np.asarray(lie.se2_act(inv, jnp.asarray(p))) for p in pts])
    g.add_edge(et3, [0, 1, 2, 3], meas, np.eye(6) * 10)
    p = g.compile()
    opt = SparseOptimizer(p, solver=DenseSolver())
    opt.optimize(20)
    assert opt.chi2() < 1e-12


def test_pcg_chunk_preconditioner(sphere_problem):
    """Chunked tridiagonal preconditioning reaches the dense answer in
    fewer iterations than it would diverge -- and matches jacobi's fixed
    point."""
    p = sphere_problem.compile()
    lin = p.linearize_jit(p.data, p.estimates)
    lam = 1e-3
    dx_ref = np.asarray(DenseSolver().setup(p).solve(p.data, lin, lam))
    s = PCGSolver(max_iter=400, tol=1e-12, precond="chunk",
                  chunk_size=10).setup(p)
    dx = np.asarray(s.solve(p.data, lin, lam))
    rel = np.linalg.norm(dx - dx_ref) / np.linalg.norm(dx_ref)
    assert rel < 1e-6
    # multi-type problems silently fall back to jacobi
    from g2o_tpu.sim.generators import create_ba_scene

    g, _ = create_ba_scene(n_cameras=4, n_points=20, seed=3)
    pb = g.compile()
    sb = PCGSolver(max_iter=300, tol=1e-10, precond="chunk").setup(pb)
    linb = pb.linearize_jit(pb.data, pb.estimates)
    dxb = np.asarray(sb.solve(pb.data, linb, 1e-2))
    dxb_ref = np.asarray(DenseSolver().setup(pb).solve(pb.data, linb, 1e-2))
    assert np.linalg.norm(dxb - dxb_ref) / np.linalg.norm(dxb_ref) < 1e-4


def test_mixed_type_chunk2_beats_jacobi_at_scale():
    """On a 10k+-vertex mixed SE2+XY landmark
    graph the (padded-block, global-id) chunk2 two-level Schwarz
    preconditioner needs fewer CG iterations than plain block-Jacobi at
    equal tolerance."""
    import jax
    import numpy as np
    import pytest

    from g2o_tpu.core.solvers import PCGSolver
    from g2o_tpu.sim.generators import create_simulator2d

    g = create_simulator2d(n_poses=9000, n_landmarks=2500, world_size=120.0,
                           sensors=("odometry", "pointxy"),
                           noise_scale=1.0, seed=4)
    p = g.compile()
    assert sum(p.counts.values()) > 10_000
    lin = p.linearize_jit(p.data, p.estimates)
    counts = {}
    for prec in ("jacobi", "chunk2"):
        s = PCGSolver(max_iter=2000, tol=1e-6, precond=prec, chunk_size=64,
                      absolute_tolerance=True).setup(p)
        _, _, st = s._solve_state_jit(p.data, lin, 1e-6, s.aux, s.state0)
        counts[prec] = int(st["cg_iterations"])
    assert counts["chunk2"] < counts["jacobi"], counts


def test_pcg_every_k_precond_matches_per_solve():
    """every_k refresh (lax.cond-gated rebuild inside the fused loop) must
    track the per-solve trajectory; K=1 means rebuild at every solve."""
    import numpy as np
    import jax.numpy as jnp

    from g2o_tpu.core.lm_fused import optimize_fused
    from g2o_tpu.core.solvers import PCGSolver
    from g2o_tpu.sim.generators import create_manhattan

    g = create_manhattan(n_poses=200, seed=4)
    p = g.compile(dtype=jnp.float32)
    est0 = {t: np.array(v) for t, v in p.estimates.items()}

    def reset():
        p.set_estimates({t: jnp.asarray(v, dtype=jnp.float32)
                         for t, v in est0.items()})

    rA = optimize_fused(p, PCGSolver(max_iter=32, tol=1e-2,
                                     precond="chunk2", chunk_size=16), 15)
    reset()
    s1 = PCGSolver(max_iter=32, tol=1e-2, precond="chunk2", chunk_size=16,
                   precond_mode="every_k", precond_refresh_every=1)
    r1 = optimize_fused(p, s1, 15)
    reset()
    s8 = PCGSolver(max_iter=32, tol=1e-2, precond="chunk2", chunk_size=16,
                   precond_mode="every_k", precond_refresh_every=8)
    r8 = optimize_fused(p, s8, 15)
    # K=1 rebuilds every solve == per-solve semantics
    assert abs(r1["chi2_final"] - rA["chi2_final"]) <= 1e-3 * rA["chi2_final"]
    # a K-stale preconditioner shifts CG counts only; chi2 stays close
    assert abs(r8["chi2_final"] - rA["chi2_final"]) <= 0.05 * rA["chi2_final"]


def test_fused_runner_cache_not_keyed_on_reused_id():
    """Regression: the fused-runner cache was keyed on id(solver); CPython
    reuses a collected solver's id, silently replaying the PREVIOUS
    solver's compiled program (every8 vs every16 came out
    bit-identical).  Sequentially-created solvers with different configs
    must produce different runners."""
    import numpy as np
    import jax.numpy as jnp

    from g2o_tpu.core.lm_fused import optimize_fused
    from g2o_tpu.core.solvers import PCGSolver
    from g2o_tpu.sim.generators import create_manhattan

    g = create_manhattan(n_poses=150, seed=9)
    p = g.compile(dtype=jnp.float32)
    est0 = {t: np.array(v) for t, v in p.estimates.items()}

    def reset():
        p.set_estimates({t: jnp.asarray(v, dtype=jnp.float32)
                         for t, v in est0.items()})

    chis = []
    for max_iter in (2, 40):        # deliberately different solver configs
        r = optimize_fused(p, PCGSolver(max_iter=max_iter, tol=1e-10,
                                        precond="jacobi"), 8)
        chis.append(r["chi2_final"])
        reset()
        # solver object dropped here — its id may be reused by the next
    assert chis[0] != chis[1], "runner cache replayed a stale program"


def test_cgls_non_diagonal_information():
    """Regression: Jt applied L^T instead of L, so CGLS converged to the
    wrong step whenever the information matrix had off-diagonal entries
    (<Jmat v, u> != <v, Jt u>); diagonal-info tests couldn't see it."""
    import numpy as np
    import jax.numpy as jnp

    from g2o_tpu.core.graph import Graph
    from g2o_tpu.core.solvers import DenseSolver
    from g2o_tpu.core.solvers.cgls import CGLSSolver
    from g2o_tpu.ops import lie
    from g2o_tpu.types.slam2d import EdgeSE2, VertexSE2

    rng = np.random.default_rng(21)
    g = Graph()
    poses = [np.array([0.3 * i, 0.05 * i, 0.1 * i]) for i in range(12)]
    for i, x in enumerate(poses):
        g.add_vertex(i, VertexSE2, x + rng.normal(scale=0.05, size=3),
                     fixed=(i == 0))
    for i in range(11):
        meas = np.asarray(lie.se2_compose(
            lie.se2_inverse(jnp.asarray(poses[i])),
            jnp.asarray(poses[i + 1])))
        # CORRELATED information: random SPD with strong off-diagonals
        A = rng.normal(size=(3, 3))
        info = A @ A.T + 3.0 * np.eye(3)
        g.add_edge(EdgeSE2, [i, i + 1], meas, info)
    p = g.compile()
    lin = p.linearize_jit(p.data, p.estimates)
    lam = 1e-3
    dx_d = np.asarray(DenseSolver().setup(p).solve(p.data, lin, lam))
    dx_c = np.asarray(
        CGLSSolver(max_iter=4000, eta=1e-14).setup(p).solve(
            p.data, lin, lam))
    rel = np.linalg.norm(dx_c - dx_d) / np.linalg.norm(dx_d)
    assert rel < 1e-5, rel


def test_chunk2_coarse_inverse_any_size():
    """The chunk2 coarse system is factored at its own size, with no panel
    padding: at a size that is not a multiple of 96 its inverse equals the
    f64 inverse of the assembled coarse matrix."""
    import jax
    import jax.numpy as jnp

    from g2o_tpu.core.solvers import PCGSolver
    from g2o_tpu.sim.generators import create_manhattan

    p = create_manhattan(n_poses=200, seed=2).compile()
    solver = PCGSolver(precond="chunk2", chunk_size=8).setup(p)
    lin = p.linearize_jit(p.data, p.estimates)
    lam = jnp.asarray(1e-4, p.dtype)
    cmaps = solver.aux["chunk"]
    parts = solver._dbg_parts
    Hd = np.asarray(jax.jit(parts["coarse_assemble"])(p.data, lin, lam,
                                                      cmaps))
    assert Hd.shape == (75, 75) and Hd.shape[0] % 96       # 25 chunks x 3
    cinv = np.asarray(jax.jit(parts["coarse_full"])(p.data, lin, lam, cmaps))
    np.testing.assert_allclose(cinv, np.linalg.inv(Hd), rtol=1e-7,
                               atol=1e-9 * np.abs(cinv).max())
