"""Degree-bucketed segment layout (``g2o_tpu/ops/bucketed.py``): the
gather/scatter-free reduction plan used by the implicit Schur solver's
bucketed layout."""

import jax.numpy as jnp
import numpy as np
import pytest

from g2o_tpu.ops.bucketed import (bucket_broadcast, bucket_by_segment,
                                  bucket_reduce)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bucket_reduce_matches_scatter(seed):
    rng = np.random.default_rng(seed)
    S = int(rng.integers(3, 60))
    E = int(rng.integers(0, 400))
    seg = rng.integers(0, S, size=E)
    plan = bucket_by_segment(seg, S)
    # seg_perm_full is a true permutation of all segments
    assert sorted(plan.seg_perm_full.tolist()) == list(range(S))
    rows = rng.normal(size=(E, 3))
    padded = jnp.concatenate(
        [jnp.asarray(rows), jnp.zeros((1, 3))])[plan.perm_src]
    red = np.asarray(bucket_reduce(plan, padded))
    ref = np.zeros((S, 3))
    np.add.at(ref, seg, rows)
    np.testing.assert_allclose(red, ref[plan.seg_perm], atol=1e-12)


def test_bucket_broadcast_assigns_segment_values():
    rng = np.random.default_rng(7)
    seg = rng.integers(0, 20, size=150)
    plan = bucket_by_segment(seg, 20)
    sv = rng.normal(size=(len(plan.seg_perm), 2))
    bc = np.asarray(bucket_broadcast(plan, jnp.asarray(sv)))
    off, k = 0, 0
    for n, d in zip(plan.counts, plan.degrees):
        # degree-major slabs: (d, n) with the segment axis minormost
        blk = bc[off:off + n * d].reshape(d, n, 2)
        np.testing.assert_allclose(blk, np.broadcast_to(
            sv[k:k + n][None, :, :], (d, n, 2)))
        off += n * d
        k += n


def test_bucket_merging_bounds_kernel_count():
    rng = np.random.default_rng(3)
    # degrees spread over two decades -> many ladder levels pre-merge
    deg = rng.integers(1, 200, size=500)
    seg = np.repeat(np.arange(500), deg)
    plan = bucket_by_segment(seg, 500, max_buckets=4)
    assert len(plan.degrees) <= 4
    # padding stays bounded even after merging
    assert plan.pad_ratio < 2.0


def _flat_by_vid(p, flat):
    """Flat tangent vector -> {vid: np block} (bucketed problems may lay
    landmark vertices out in bucket order rather than id order)."""
    blocks = {t: np.asarray(b) for t, b in
              p.split_tangent(jnp.asarray(flat)).items()}
    return {vid: blocks[t][i] for vid, (t, i) in p.vid_index.items()}


def _assert_flat_match(pa, fa, pb, fb, tol=1e-8):
    da, db = _flat_by_vid(pa, fa), _flat_by_vid(pb, fb)
    num = sum(float(np.sum((da[v] - db[v]) ** 2)) for v in da)
    den = sum(float(np.sum(db[v] ** 2)) for v in db)
    assert num / max(den, 1e-300) < tol * tol, (num, den)


def test_compile_time_bucketing_equivalence():
    """``compile(bucket_landmarks=True)`` must be invisible to the math:
    identical chi2, b, diagonal Hessian blocks, and solver steps — only the
    edge-row layout (and thus the assembly kernels) change."""
    from g2o_tpu.core.solvers import SchurSolver
    from g2o_tpu.core.solvers.schur_implicit import ImplicitSchurSolver
    from g2o_tpu.sim.generators import create_ba_scene

    g, _ = create_ba_scene(n_cameras=8, n_points=120, pixel_noise=0.5,
                           point_noise=0.2, seed=5)
    p0 = g.compile()
    pb = g.compile(bucket_landmarks=True)
    assert pb.bucket_specs, "BA scene should produce bucketed specs"
    lin0 = p0.linearize_jit(p0.data, p0.estimates)
    linb = pb.linearize_jit(pb.data, pb.estimates)
    # the bucketed problem reorders landmark vertices into bucket order
    # (seg_identity) — compare per-VID, not element-wise
    _assert_flat_match(p0, lin0.b, pb, linb.b, tol=1e-8)
    d0 = {vid: np.asarray(lin0.diag[t])[i]
          for vid, (t, i) in p0.vid_index.items()}
    db = {vid: np.asarray(linb.diag[t])[i]
          for vid, (t, i) in pb.vid_index.items()}
    for vid in d0:
        np.testing.assert_allclose(d0[vid], db[vid], rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(float(lin0.chi2_robust),
                               float(linb.chi2_robust), rtol=1e-12)

    lam = 1e-3
    dx_e = np.asarray(SchurSolver().setup(p0).solve(p0.data, lin0, lam))
    s = ImplicitSchurSolver(max_iter=500, tol=1e-13).setup(pb)
    dx = np.asarray(s._solve_jit(pb.data, linb, lam, s.aux))
    _assert_flat_match(pb, dx, p0, dx_e)


def test_compile_time_bucketing_full_lm():
    from g2o_tpu.core.lm_fused import optimize_fused
    from g2o_tpu.core.solvers.schur_implicit import ImplicitSchurSolver
    from g2o_tpu.sim.generators import create_ba_scene

    g, _ = create_ba_scene(n_cameras=6, n_points=80, pixel_noise=0.0,
                           point_noise=0.3, seed=9)
    pb = g.compile(bucket_landmarks=True, pad_edges_to_multiple=32)
    res = optimize_fused(pb, ImplicitSchurSolver(max_iter=200, tol=1e-10),
                         12)
    assert res["chi2_final"] < 1e-6 * max(res["chi2_per_iteration"][0], 1.0)


def test_compile_time_bucketing_cgls():
    """The square-root CGLS path must produce the same step on a bucketed
    problem (slab J·v / Jᵀ·r reductions replace the row gathers/scatters)."""
    from g2o_tpu.core.solvers.cgls import CGLSSolver
    from g2o_tpu.sim.generators import create_ba_scene

    g, _ = create_ba_scene(n_cameras=8, n_points=120, pixel_noise=0.5,
                           point_noise=0.2, seed=5)
    p0 = g.compile()
    pb = g.compile(bucket_landmarks=True, pad_edges_to_multiple=64)
    lin0 = p0.linearize_jit(p0.data, p0.estimates)
    linb = pb.linearize_jit(pb.data, pb.estimates)
    lam = 1e-3
    s0 = CGLSSolver(max_iter=2000, eta=1e-20).setup(p0)
    sb = CGLSSolver(max_iter=2000, eta=1e-20).setup(pb)
    dx0 = np.asarray(s0._solve_jit(p0.data, lin0, lam, s0.aux))
    dxb = np.asarray(sb._solve_jit(pb.data, linb, lam, sb.aux))
    _assert_flat_match(pb, dxb, p0, dx0)


def test_bucket_empty_segments():
    seg = np.array([5, 5, 5, 9])
    plan = bucket_by_segment(seg, 12)
    assert set(plan.seg_perm.tolist()) == {5, 9}
    assert sorted(plan.seg_perm_full.tolist()) == list(range(12))
    rows = np.arange(8, dtype=np.float64).reshape(4, 2)
    padded = jnp.concatenate(
        [jnp.asarray(rows), jnp.zeros((1, 2))])[plan.perm_src]
    red = np.asarray(bucket_reduce(plan, padded))
    ref = np.zeros((12, 2))
    np.add.at(ref, seg, rows)
    np.testing.assert_allclose(red, ref[plan.seg_perm])


def test_dm_path_schur_jacobi_and_fixed_landmarks():
    """The fully dims-major implicit-Schur path (linearize-shared extras)
    must match the rows layout under the schur_jacobi preconditioner, and
    fixed landmarks must stay pinned (dx == 0) via the all-zero-block
    detection that replaces the data.fixed gather."""
    from g2o_tpu.core.solvers.schur_implicit import ImplicitSchurSolver
    from g2o_tpu.sim.generators import create_ba_scene

    g, _ = create_ba_scene(n_cameras=7, n_points=90, pixel_noise=0.4,
                           point_noise=0.25, seed=3)
    # fix a couple of landmarks (their Jacobian slots are masked at
    # linearize, so their extras Hll blocks are exactly zero)
    lm_vids = [vid for vid, rec in g.vertices().items()
               if rec.marginalized][:3]
    for vid in lm_vids:
        g.set_fixed(vid, True)

    pb = g.compile(bucket_landmarks=True)
    p0 = g.compile()
    linb = pb.linearize_jit(pb.data, pb.estimates)
    lin0 = p0.linearize_jit(p0.data, p0.estimates)
    assert linb.extras, "bucketed compile must emit linearize extras"
    (name,) = [n for n in linb.extras]
    for key in ("Bt", "Hll_bucket", "bl_bucket"):
        assert key in linb.extras[name]

    lam = 5e-3
    sb = ImplicitSchurSolver(max_iter=500, tol=1e-13,
                             precond="schur_jacobi").setup(pb)
    s0 = ImplicitSchurSolver(max_iter=500, tol=1e-13, layout="rows",
                             precond="schur_jacobi").setup(p0)
    dxb = np.asarray(sb._solve_jit(pb.data, linb, lam, sb.aux))
    dx0 = np.asarray(s0._solve_jit(p0.data, lin0, lam, s0.aux))
    _assert_flat_match(pb, dxb, p0, dx0)

    # fixed landmark tangent slots must be exactly zero
    blocks = pb.split_tangent(jnp.asarray(dxb))
    for vid in lm_vids:
        t, i = pb.vid_index[vid]
        assert float(np.abs(np.asarray(blocks[t])[i]).max()) == 0.0


def test_static_kernel_dispatch_matches_dynamic():
    """Uniform-kernel batches dispatch statically (one branch); a
    mixed-kernel batch must keep the dynamic vmap(switch) dispatch and
    both must agree with the reference formulas."""
    import g2o_tpu.types  # noqa: F401
    from g2o_tpu.core.graph import Graph
    from g2o_tpu.types.slam2d import EdgeSE2, VertexSE2

    rng = np.random.default_rng(0)

    def build(kernels):
        g = Graph()
        for i in range(6):
            g.add_vertex(i, VertexSE2, rng.standard_normal(3))
        g.set_fixed(0, True)
        for i, kern in enumerate(kernels):
            g.add_edge(EdgeSE2, (i, i + 1), rng.standard_normal(3),
                       np.eye(3), kernel=kern, delta=0.8)
        return g

    g_uni = build(["Huber"] * 5)
    g_mix = build(["Huber", "Cauchy", "Huber", "None", "DCS"])
    p_uni = g_uni.compile()
    p_mix = g_mix.compile()
    p_dyn = g_uni.compile(static_kernels=False)
    assert list(p_uni.uniform_kernel.values()) == [1]      # HUBER id
    assert list(p_mix.uniform_kernel.values()) == [None]
    assert p_dyn.uniform_kernel == {}

    # static vs dynamic dispatch: identical chi2 and gradient
    lin_s = p_uni.linearize_jit(p_uni.data, p_uni.estimates)
    lin_d = p_dyn.linearize_jit(p_dyn.data, p_dyn.estimates)
    np.testing.assert_allclose(np.asarray(lin_s.b), np.asarray(lin_d.b),
                               rtol=1e-12)
    np.testing.assert_allclose(float(lin_s.chi2_robust),
                               float(lin_d.chi2_robust), rtol=1e-12)

    # mixed batch: per-edge kernels match scalar robustify
    from g2o_tpu.ops import robust as robust_mod
    lin_m = p_mix.linearize_jit(p_mix.data, p_mix.estimates)
    batch = p_mix.data.edges["EDGE_SE2"]
    _, e = p_mix._edge_residuals(p_mix.edge_types["EDGE_SE2"], batch,
                                 p_mix.estimates)
    e2 = np.einsum("er,ers,es->e", np.asarray(e), np.asarray(batch.info),
                   np.asarray(e))
    expected = sum(
        float(robust_mod.robustify(int(k), jnp.asarray(z),
                                   jnp.asarray(0.8))[0])
        for k, z in zip(np.asarray(batch.kernel), e2))
    np.testing.assert_allclose(float(lin_m.chi2_robust), expected,
                               rtol=1e-10)


def test_fixed_landmark_with_bucket_reorder():
    """fixed_flat must be built AFTER the bucket reorder pass: a fixed
    landmark of a reordered type previously lost its unit diagonal
    (singular H) while an unrelated free landmark got spurious damping.
    Point degrees are deliberately INTERLEAVED so the degree-bucketing
    produces a non-identity permutation (equal-degree scenes keep the
    original order and mask the bug)."""
    import numpy as np
    import jax.numpy as jnp

    from g2o_tpu.core.graph import Graph
    from g2o_tpu.core.solvers import DenseSolver
    from g2o_tpu.sim.generators import create_ba_scene
    from g2o_tpu.types.sba import (CAM_PARAM_ID, EdgeProjectXYZ2UV,
                                   VertexPointXYZ, VertexSE3Expmap)

    base, _ = create_ba_scene(n_cameras=5, n_points=1, seed=6)
    g = Graph()
    g.add_parameter(CAM_PARAM_ID, np.array([1000.0, 320.0, 240.0, 0.0]))
    rng = np.random.default_rng(3)
    for vid, rec in base.vertices().items():
        if rec.vtype is VertexSE3Expmap:
            g.add_vertex(vid, rec.vtype, rec.estimate, fixed=rec.fixed)
    pt_vids = []
    for k in range(24):
        vid = 1000 + k
        pw = np.array([rng.uniform(-2, 2), rng.uniform(-0.5, 0.5),
                       rng.uniform(4, 7)])
        g.add_vertex(vid, VertexPointXYZ, pw + rng.normal(scale=0.05,
                                                          size=3),
                     fixed=(k in (0, 7)), marginalized=True)
        pt_vids.append(vid)
        deg = 2 + (k % 3)                       # interleaved degrees 2/3/4
        for c in range(deg):
            uv = np.array([320.0, 240.0]) + rng.normal(scale=40.0, size=2)
            g.add_edge(EdgeProjectXYZ2UV, [vid, c], uv, np.eye(2),
                       param_id=CAM_PARAM_ID)
    p_plain = g.compile(bucket_landmarks=False)
    p_buck = g.compile(bucket_landmarks=True)
    t_pt = VertexPointXYZ.name
    perm_nontrivial = any(
        p_plain.vid_index[v][1] != p_buck.vid_index[v][1] for v in pt_vids)
    assert perm_nontrivial, "test needs a non-identity bucket permutation"
    lin_p = p_plain.linearize_jit(p_plain.data, p_plain.estimates)
    lin_b = p_buck.linearize_jit(p_buck.data, p_buck.estimates)
    lam = 1e-2
    dxp = DenseSolver().setup(p_plain).solve(p_plain.data, lin_p, lam)
    dxb = DenseSolver().setup(p_buck).solve(p_buck.data, lin_b, lam)
    assert np.isfinite(np.asarray(dxp)).all()
    assert np.isfinite(np.asarray(dxb)).all()
    # compare per-vid updates through the external-id mapping
    ep = p_plain.split_tangent(dxp)
    eb = p_buck.split_tangent(dxb)
    for vid in pt_vids:
        tp, ip = p_plain.vid_index[vid]
        tb, ib = p_buck.vid_index[vid]
        a = np.asarray(ep[tp][ip])
        b = np.asarray(eb[tb][ib])
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9)
    # fixed landmarks must not move
    for vid in (pt_vids[0], pt_vids[7]):
        tb, ib = p_buck.vid_index[vid]
        assert np.abs(np.asarray(eb[tb][ib])).max() < 1e-12
