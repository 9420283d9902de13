"""General marginalization through the implicit Schur solver: n-ary
observation edges (inverse-depth PSI2UV) and per-vertex partial
marginalization, both exact against the dense solver.  Reference:
``block_solver.hpp:224-253`` (per-vertex Schur pattern),
``base_multi_edge.h:51,115`` (n-ary quadratic form)."""

import jax.numpy as jnp
import numpy as np
import pytest

from g2o_tpu.core.graph import Graph
from g2o_tpu.core.lm_fused import optimize_fused
from g2o_tpu.core.solvers import DenseSolver, PCGSolver
from g2o_tpu.core.solvers.schur_implicit import ImplicitSchurSolver
from g2o_tpu.ops import lie
from g2o_tpu.sim.generators import create_ba_scene
from g2o_tpu.types.sba import (CAM_PARAM_ID, EdgeProjectPSI2UV,
                               VertexPointXYZ, VertexSE3Expmap)


def make_inverse_depth_scene(n_cams=6, n_points=40, seed=0):
    """Small anchored inverse-depth BA graph (3-ary PSI2UV edges, points
    marginalized) — the shape of examples/ba_anchored_inverse_depth.py."""
    rng = np.random.default_rng(seed)
    focal, cx, cy = 1000.0, 320.0, 240.0
    true_points = np.stack([rng.uniform(-3, 3, n_points),
                            rng.uniform(-0.5, 0.5, n_points),
                            rng.uniform(4, 8, n_points)], axis=1)
    g = Graph()
    g.add_parameter(CAM_PARAM_ID, np.array([focal, cx, cy, 0.0]))
    cams = []
    for i in range(n_cams):
        trans = np.array([i * 0.04 - 1.0, 0.0, 0.0])
        Tcw = np.concatenate([-trans, [0, 0, 0, 1.0]])
        cams.append(Tcw)
        g.add_vertex(i, VertexSE3Expmap, Tcw, fixed=(i < 2))

    def project(Tcw, pw):
        pc = pw + Tcw[:3]
        return np.array([focal * pc[0] / pc[2] + cx,
                         focal * pc[1] / pc[2] + cy]), pc[2]

    vid = n_cams
    for k in range(n_points):
        vis = [(i, project(cams[i], true_points[k])[0])
               for i in range(n_cams)]
        anchor = vis[0][0]
        noisy = true_points[k] + rng.normal(scale=0.5, size=3)
        pa = np.asarray(lie.se3_act(jnp.asarray(cams[anchor]),
                                    jnp.asarray(noisy)))
        psi = np.array([pa[0] / pa[2], pa[1] / pa[2], 1.0 / pa[2]])
        g.add_vertex(vid, VertexPointXYZ, psi, marginalized=True)
        for i, uv in vis:
            obs = uv + rng.normal(scale=1.0, size=2)
            g.add_edge(EdgeProjectPSI2UV, [vid, i, anchor], obs,
                       np.eye(2), param_id=CAM_PARAM_ID)
        vid += 1
    return g


@pytest.mark.parametrize("precond", ["jacobi", "schur_jacobi"])
def test_psi2uv_nary_schur_matches_dense(precond):
    g = make_inverse_depth_scene()
    p = g.compile()
    lin = p.linearize_jit(p.data, p.estimates)
    lam = 1e-3
    dx_d = np.asarray(DenseSolver().setup(p).solve(p.data, lin, lam))
    s = ImplicitSchurSolver(max_iter=3000, tol=1e-13,
                            precond=precond).setup(p)
    dx_i = np.asarray(s.solve(p.data, lin, lam))
    rel = np.linalg.norm(dx_i - dx_d) / np.linalg.norm(dx_d)
    assert rel < 1e-7


@pytest.mark.parametrize("precond", ["jacobi", "schur_jacobi"])
def test_partial_marginalization_matches_dense(precond):
    g, truth = create_ba_scene(n_cameras=6, n_points=60, seed=5)
    # un-marginalize a strict subset: every third point rides the reduced
    # CG system alongside the cameras
    for j, vid in enumerate(truth):
        if j % 3 == 0:
            g.set_marginalized(vid, False)
    p = g.compile()
    lin = p.linearize_jit(p.data, p.estimates)
    lam = 1e-3
    dx_d = np.asarray(DenseSolver().setup(p).solve(p.data, lin, lam))
    s = ImplicitSchurSolver(max_iter=3000, tol=1e-13,
                            precond=precond).setup(p)
    dx_i = np.asarray(s.solve(p.data, lin, lam))
    rel = np.linalg.norm(dx_i - dx_d) / np.linalg.norm(dx_d)
    assert rel < 1e-7


def test_psi2uv_lm_trajectory_matches_pcg():
    """Full fused-LM runs: the Schur path must reproduce the plain-PCG
    trajectory on the inverse-depth problem (same optimum, same chi2)."""
    g = make_inverse_depth_scene(n_cams=8, n_points=60, seed=2)
    p1 = g.compile()
    r1 = optimize_fused(p1, PCGSolver(max_iter=500, tol=1e-10), 8)
    p2 = g.compile()
    r2 = optimize_fused(
        p2, ImplicitSchurSolver(max_iter=500, tol=1e-10), 8)
    assert abs(r2["chi2_final"] - r1["chi2_final"]) <= \
        1e-6 * max(r1["chi2_final"], 1.0)


def test_partial_lm_full_run():
    g, truth = create_ba_scene(n_cameras=5, n_points=40, seed=7)
    vids = list(truth)
    for vid in vids[: len(vids) // 2]:
        g.set_marginalized(vid, False)
    p1 = g.compile()
    r1 = optimize_fused(p1, PCGSolver(max_iter=500, tol=1e-10), 10)
    p2 = g.compile()
    r2 = optimize_fused(
        p2, ImplicitSchurSolver(max_iter=500, tol=1e-10), 10)
    assert abs(r2["chi2_final"] - r1["chi2_final"]) <= \
        1e-6 * max(r1["chi2_final"], 1.0)


def test_deflation_rejected_on_general_path():
    """deflate_basis must fail loudly (not silently no-op) when the
    problem routes to the general n-ary/partial marginalization path."""
    import pytest

    from g2o_tpu.core.solvers.schur_implicit import ImplicitSchurSolver

    g = make_inverse_depth_scene(seed=3)
    p = g.compile()
    cam_t = next(t for t in p.vertex_types
                 if not np.asarray(p.marginalized[t]).any())
    d = p.vertex_types[cam_t].tangent_dim
    basis = {cam_t: np.zeros((p.counts[cam_t], d, 1))}
    with pytest.raises(NotImplementedError):
        ImplicitSchurSolver(deflate_basis=basis).setup(p)
