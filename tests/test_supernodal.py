"""Supernodal block-sparse Cholesky: partition closure, exactness, full LM."""

import numpy as np
import pytest

from g2o_tpu.core.solvers import DenseSolver
from g2o_tpu.core.solvers.sparse_chol import symbolic_factorization
from g2o_tpu.core.solvers.supernodal import (
    SupernodalCholeskySolver,
    build_supernodal_schedule,
    propagate_rowsets,
    supernode_partition,
)
from g2o_tpu.sim.generators import create_manhattan, create_sphere


def _pairs_from_problem(p):
    pair_set = set()
    for name, et in p.edge_types.items():
        if et.num_slots != 2:
            continue
        for a, b in np.asarray(p.data.edges[name].vidx):
            if a != b:
                pair_set.add((min(int(a), int(b)), max(int(a), int(b))))
    return np.asarray(sorted(pair_set), dtype=np.int64)


def test_partition_covers_columns_and_closure():
    g = create_sphere(nodes_per_level=10, laps=4, radius=10, seed=2)
    p = g.compile()
    pairs = _pairs_from_problem(p)
    n = p.counts[next(iter(p.counts))]
    sym = symbolic_factorization(n, pairs)
    starts, rowsets = supernode_partition(sym, smax=16, zeta=0.3)
    assert starts[0] == 0 and starts[-1] == n
    assert np.all(np.diff(starts) >= 1)
    rowsets, parent_sn = propagate_rowsets(starts, rowsets)
    # closure: every row of R(S) is inside an ancestor supernode's columns
    # or rowset, walking the quotient etree
    sn_of_col = np.empty(n, dtype=int)
    for k in range(len(rowsets)):
        sn_of_col[starts[k]:starts[k + 1]] = k
    for k, R in enumerate(rowsets):
        if len(R) == 0:
            continue
        p_sn = int(sn_of_col[int(R[0])])
        inside = (R >= starts[p_sn]) & (R < starts[p_sn + 1])
        passed_up = set(int(x) for x in R[~inside])
        assert passed_up <= set(int(x) for x in rowsets[p_sn])

    # amalgamation actually coarsens: far fewer supernodes than columns
    assert len(rowsets) < 0.6 * n


def test_schedule_is_shallower_than_column_levels():
    g = create_sphere(nodes_per_level=10, laps=6, radius=10, seed=2)
    p = g.compile()
    pairs = _pairs_from_problem(p)
    n = p.counts[next(iter(p.counts))]
    sym = symbolic_factorization(n, pairs)
    levels, _, meta = build_supernodal_schedule(sym, d=6, smax=24)
    assert meta["n_levels"] < len(sym["levels"])


@pytest.mark.parametrize("maker", [
    lambda: create_manhattan(n_poses=120, seed=3),
    lambda: create_sphere(nodes_per_level=10, laps=4, radius=10, seed=2),
])
def test_matches_dense(maker):
    g = maker()
    p = g.compile()
    lin = p.linearize_jit(p.data, p.estimates)
    lam = 1e-3
    dx_d = np.asarray(DenseSolver().setup(p).solve(p.data, lin, lam))
    dx_s = np.asarray(
        SupernodalCholeskySolver().setup(p).solve(p.data, lin, lam))
    rel = np.linalg.norm(dx_s - dx_d) / np.linalg.norm(dx_d)
    assert rel < 1e-8


def test_matches_dense_tiny_supernodes():
    """smax=1 degenerates to the per-column algorithm — still exact."""
    g = create_manhattan(n_poses=80, seed=4)
    p = g.compile()
    lin = p.linearize_jit(p.data, p.estimates)
    dx_d = np.asarray(DenseSolver().setup(p).solve(p.data, lin, 1e-2))
    dx_s = np.asarray(
        SupernodalCholeskySolver(smax=1).setup(p).solve(p.data, lin, 1e-2))
    assert np.linalg.norm(dx_s - dx_d) / np.linalg.norm(dx_d) < 1e-8


def test_full_lm():
    from g2o_tpu.core.lm_fused import optimize_fused

    g = create_manhattan(n_poses=150, seed=5)
    p = g.compile()
    res = optimize_fused(p, SupernodalCholeskySolver(), 10)
    assert res["chi2_final"] < 0.5 * res["chi2_per_iteration"][0]


def test_mixed_types_matches_dense():
    """Mixed vertex types (SE3Expmap cameras + XYZ points) factor through
    the global-block-id + padding scheme (reference analogue: CHOLMOD's
    variable block sizes, linear_solver_cholmod.h:76)."""
    from g2o_tpu.core.solvers import DenseSolver
    from g2o_tpu.sim.generators import create_ba_scene

    g, _ = create_ba_scene(n_cameras=3, n_points=10, seed=1)
    p = g.compile()
    lin = p.linearize_jit(p.data, p.estimates)
    lam = 1e-2
    dx_d = np.asarray(DenseSolver().setup(p).solve(p.data, lin, lam))
    dx_s = np.asarray(
        SupernodalCholeskySolver(refine=2).setup(p).solve(p.data, lin, lam))
    rel = np.linalg.norm(dx_s - dx_d) / np.linalg.norm(dx_d)
    assert rel < 1e-8


def test_ternary_calib_matches_dense():
    """Hyper-edges: every slot pair contributes an H block
    (block_solver.hpp:142-214)."""
    import jax.numpy as jnp

    from g2o_tpu.core.graph import Graph
    from g2o_tpu.core.solvers import DenseSolver
    from g2o_tpu.ops import lie
    from g2o_tpu.types.sclam2d import EdgeSE2SensorCalib
    from g2o_tpu.types.slam2d import EdgeSE2, VertexSE2

    rng = np.random.default_rng(4)
    offset_gt = np.array([0.3, 0.1, 0.2])
    poses = [np.array([0.0, 0, 0])]
    for i in range(12):
        poses.append(poses[-1] + np.array([1.0, 0.1 * rng.normal(), 0.15]))
    g = Graph()
    for i, x in enumerate(poses):
        g.add_vertex(i, VertexSE2, x + rng.normal(scale=0.03, size=3),
                     fixed=(i == 0))
    g.add_vertex(100, VertexSE2, [0.0, 0.0, 0.0])
    info = np.eye(3) * 100
    for i in range(len(poses) - 1):
        a = lie.se2_compose(jnp.asarray(poses[i]), jnp.asarray(offset_gt))
        b = lie.se2_compose(jnp.asarray(poses[i + 1]),
                            jnp.asarray(offset_gt))
        meas = np.asarray(lie.se2_compose(lie.se2_inverse(a), b))
        g.add_edge(EdgeSE2SensorCalib, [i, i + 1, 100], meas, info)
        g.add_edge(EdgeSE2, [i, i + 1], meas, info * 0.1)
    p = g.compile()
    lin = p.linearize_jit(p.data, p.estimates)
    lam = 1e-3
    dx_d = np.asarray(DenseSolver().setup(p).solve(p.data, lin, lam))
    dx_s = np.asarray(
        SupernodalCholeskySolver(refine=2).setup(p).solve(p.data, lin, lam))
    rel = np.linalg.norm(dx_s - dx_d) / np.linalg.norm(dx_d)
    assert rel < 1e-8


def test_supernodal_amalgamation_invariant():
    """Different amalgamation widths reshape the frontal schedule but must
    produce the same solve (multifrontal extend-add exactness)."""
    import jax.numpy as jnp

    import g2o_tpu.types  # noqa: F401

    g = create_manhattan(n_poses=300, seed=3)
    p = g.compile()
    lin = p.linearize_jit(p.data, p.estimates)
    lam = jnp.asarray(1e-3, p.dtype)
    xs = []
    for smax in (24, 6):
        s = SupernodalCholeskySolver(smax=smax)
        s.setup(p)
        xs.append(np.asarray(s.solve(p.data, lin, lam)))
    np.testing.assert_allclose(xs[0], xs[1], rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("sd", [48, 144, 288])
def test_batched_kernels_match_lapack(sd):
    """The numeric phase's batched Cholesky and triangular solves in f32,
    at panel widths below and above 96 columns, against LAPACK in f64.
    Tolerance: a few f32 ulps of the largest entry (the matrices are
    well conditioned, sd on the diagonal)."""
    import jax.numpy as jnp

    from g2o_tpu.core.solvers.supernodal import (_chol_batched,
                                                 _solve_lower_batched,
                                                 _solve_upper_batched)

    rng = np.random.default_rng(sd)
    S, m = 5, 7
    A = rng.standard_normal((S, sd, sd))
    D = A @ A.transpose(0, 2, 1) / sd + np.eye(sd)
    B = rng.standard_normal((S, sd, m))
    L = _chol_batched(jnp.asarray(D, jnp.float32))
    Lref = np.linalg.cholesky(D)
    tol = 2e-5
    assert np.abs(np.asarray(L, np.float64) - Lref).max() \
        <= tol * np.abs(Lref).max()
    Y = _solve_lower_batched(L, jnp.asarray(B, jnp.float32))
    Yref = np.linalg.solve(Lref, B)
    assert np.abs(np.asarray(Y, np.float64) - Yref).max() \
        <= tol * np.abs(Yref).max()
    X = _solve_upper_batched(L, Y)
    Xref = np.linalg.solve(Lref.transpose(0, 2, 1), Yref)
    assert np.abs(np.asarray(X, np.float64) - Xref).max() \
        <= tol * np.abs(Xref).max()
