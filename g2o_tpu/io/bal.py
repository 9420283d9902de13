"""BAL dataset reader/writer (http://grail.cs.washington.edu/projects/bal/).

Format (as parsed by the reference ``bal_example.cpp:300-360``):

    num_cameras num_points num_observations
    <cam_idx point_idx u v>            x num_observations
    <9 camera params, one per line>    x num_cameras
    <3 point coords, one per line>     x num_points

Cameras get vertex ids [0, C); points [C, C+P) and are marked marginalized
for the Schur path (as the reference marks them, ``bal_example.cpp:420``).
"""

from __future__ import annotations

import numpy as np

from g2o_tpu.core.graph import Graph
from g2o_tpu.utils.cache import CACHE_ROOT

# second place a generated BAL text is kept when data/bal_cache is not
# writable
_SPARE_CACHE = f"{CACHE_ROOT}/bal"


def load_bal(path_or_file, *, fix_first_camera: bool = False,
             huber: float = 0.0) -> Graph:
    """``fix_first_camera`` defaults to False — the reference
    ``bal_example`` fixes NO camera (λ damping absorbs the 7-dof gauge);
    fixing camera 0 optimizes a DIFFERENT problem (+4 chi2 at the
    ladybug floor, harder late CG)."""
    from g2o_tpu.types.bal import EdgeObservationBAL, VertexCameraBAL
    from g2o_tpu.types.slam3d import VertexPointXYZ

    if hasattr(path_or_file, "read"):
        tokens = path_or_file.read().split()
    else:
        with open(path_or_file) as fh:
            tokens = fh.read().split()
    it = iter(tokens)

    def nxt():
        return next(it)

    C = int(nxt())
    P = int(nxt())
    O = int(nxt())
    obs = np.empty((O, 4))
    for i in range(O):
        obs[i] = (float(nxt()), float(nxt()), float(nxt()), float(nxt()))
    cams = np.empty((C, 9))
    for i in range(C):
        cams[i] = [float(nxt()) for _ in range(9)]
    pts = np.empty((P, 3))
    for i in range(P):
        pts[i] = [float(nxt()) for _ in range(3)]

    g = Graph()
    for i in range(C):
        g.add_vertex(i, VertexCameraBAL, cams[i],
                     fixed=(fix_first_camera and i == 0))
    for j in range(P):
        g.add_vertex(C + j, VertexPointXYZ, pts[j], marginalized=True)
    info = np.eye(2)
    kernel = "Huber" if huber > 0 else None
    for i in range(O):
        ci, pi = int(obs[i, 0]), int(obs[i, 1])
        g.add_edge(EdgeObservationBAL, [ci, C + pi], obs[i, 2:4], info,
                   kernel=kernel, delta=huber if huber > 0 else 1.0)
    return g


def load_bal_problem(path_or_file, *, fix_first_camera: bool = False,
                     huber: float = 0.0, dtype=None,
                     pad_edges_to_multiple: int = 1,
                     bucket_landmarks: bool = False):
    """Array-direct BAL loading: tokens -> numpy blocks ->
    :func:`~g2o_tpu.core.problem.build_problem`, bypassing per-record Python
    objects (the object path costs minutes at Venice scale)."""
    from g2o_tpu.core.problem import build_problem
    from g2o_tpu.ops import robust as robust_mod
    from g2o_tpu.types.bal import EdgeObservationBAL, VertexCameraBAL
    from g2o_tpu.types.slam3d import VertexPointXYZ

    if hasattr(path_or_file, "read"):
        text = path_or_file.read()
    else:
        with open(path_or_file) as fh:
            text = fh.read()
    # np.fromstring's C scanner is ~2.2x faster than split()+np.array on the
    # 37 MB Venice text (0.8 s vs 2.1 s); deprecated but validated against
    # the split path (falls back on any disagreement in token count)
    import warnings
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            tokens = np.fromstring(text, dtype=np.float64, sep=" ")
        need = 3
        if len(tokens) >= 3:
            need = (3 + 4 * int(tokens[2]) + 9 * int(tokens[0])
                    + 3 * int(tokens[1]))
        if len(tokens) < need:
            tokens = np.array(text.split(), dtype=np.float64)
    except (AttributeError, TypeError, DeprecationWarning):
        # np.fromstring removed/errored on a future numpy: slow path
        tokens = np.array(text.split(), dtype=np.float64)
    C, P, O = int(tokens[0]), int(tokens[1]), int(tokens[2])
    pos = 3
    obs = tokens[pos:pos + 4 * O].reshape(O, 4)
    pos += 4 * O
    cams = tokens[pos:pos + 9 * C].reshape(C, 9)
    pos += 9 * C
    pts = tokens[pos:pos + 3 * P].reshape(P, 3)

    cam_ids = np.arange(C, dtype=np.int64)
    pt_ids = C + np.arange(P, dtype=np.int64)
    cam_fixed = np.zeros(C, dtype=bool)
    if fix_first_camera:
        cam_fixed[0] = True
    vertex_blocks = {
        VertexCameraBAL: (cam_ids, cams, cam_fixed,
                          np.zeros(C, dtype=bool)),
        VertexPointXYZ: (pt_ids, pts, np.zeros(P, dtype=bool),
                         np.ones(P, dtype=bool)),
    }
    vids = np.stack([obs[:, 0].astype(np.int64),
                     C + obs[:, 1].astype(np.int64)], axis=1)
    kid = robust_mod.HUBER if huber > 0 else robust_mod.NONE
    edge_blocks = {
        EdgeObservationBAL: (
            vids, obs[:, 2:4],
            np.tile(np.eye(2), (O, 1, 1)),
            np.full(O, kid, dtype=np.int32),
            np.full(O, huber if huber > 0 else 1.0),
            np.ones(O, dtype=bool),
            np.zeros((O, 0)),
        )
    }
    return build_problem(vertex_blocks, edge_blocks, dtype=dtype,
                         pad_edges_to_multiple=pad_edges_to_multiple,
                         bucket_landmarks=bucket_landmarks)


def save_bal(g: Graph, path, estimates_by_vid=None):
    """Write the graph back in BAL format (cameras/points recovered by
    type)."""
    from g2o_tpu.types.bal import VertexCameraBAL

    est = estimates_by_vid or {vid: r.estimate
                               for vid, r in g.vertices().items()}
    cams = sorted(vid for vid, r in g.vertices().items()
                  if r.vtype is VertexCameraBAL)
    pts = sorted(vid for vid, r in g.vertices().items()
                 if r.vtype is not VertexCameraBAL)
    cam_index = {vid: i for i, vid in enumerate(cams)}
    pt_index = {vid: i for i, vid in enumerate(pts)}
    lines = [f"{len(cams)} {len(pts)} {len(g.edges())}"]
    for e in g.edges():
        ci, pi = e.vids
        lines.append(f"{cam_index[ci]} {pt_index[pi]} "
                     f"{e.measurement[0]:.12g} {e.measurement[1]:.12g}")
    for vid in cams:
        lines.extend(f"{v:.16g}" for v in np.asarray(est[vid]))
    for vid in pts:
        lines.extend(f"{v:.16g}" for v in np.asarray(est[vid]))
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def synthetic_bal_cached(n_cameras=49, n_points=7000, n_obs_per_point=6,
                         pixel_noise=1.0, seed=0, cache_dir=None):
    """Text of :func:`make_synthetic_bal`, disk-cached (gzip).

    Generation costs ~22 s at Venice scale (the 120M-key camera-selection
    argsort dominates); the reference pays none of it — ``bal_example``
    loads BAL files from disk (``examples/bal/bal_example.cpp:300``) — so
    the benchmark datasets are generated once and committed under
    ``data/bal_cache/``.  Falls back to the checkout's run-time cache, then
    to fresh generation."""
    import gzip
    import os

    fname = (f"bal-C{n_cameras}-P{n_points}-K{n_obs_per_point}"
             f"-N{pixel_noise:g}-S{seed}.txt.gz")
    repo_dir = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "data", "bal_cache")
    for d in ([cache_dir] if cache_dir else []) + [repo_dir, _SPARE_CACHE]:
        path = os.path.join(d, fname)
        if os.path.exists(path):
            with gzip.open(path, "rt") as fh:
                return fh.read()
    text = make_synthetic_bal(n_cameras=n_cameras, n_points=n_points,
                              n_obs_per_point=n_obs_per_point,
                              pixel_noise=pixel_noise, seed=seed)
    for d in ([cache_dir] if cache_dir else []) + [repo_dir, _SPARE_CACHE]:
        try:
            os.makedirs(d, exist_ok=True)
            with gzip.open(os.path.join(d, fname), "wt") as fh:
                fh.write(text)
            break
        except OSError:
            continue
    return text


def make_stress_bal(n_cameras=120, n_points=30_000, mean_obs_per_point=6,
                    depth_sigma=0.8, hub_fraction=0.1, hub_boost=10.0,
                    outlier_fraction=0.07, pixel_noise=1.0,
                    estimate_noise=True, seed=0):
    """Ill-conditioned synthetic BAL problem.

    The well-conditioned arc scenes of :func:`make_synthetic_bal` understate
    preconditioner and robust-kernel differences; real BAL captures are
    unreachable offline (BASELINE.md).  This generator injects the
    pathologies of real captures:

    - **log-normal point depths** (``exp(N(ln 8, depth_sigma))``, ~1.5-60
      units): near points carry huge reprojection Jacobians, far points
      tiny ones — a wide Schur-complement spectrum.
    - **degree skew / hub cameras**: ``hub_fraction`` of cameras get
      ``hub_boost``x selection weight (Gumbel top-k weighted sampling
      without replacement), so a few cameras dominate the observation
      graph like loop-closure frames do.
    - **variable per-point track length**: 2 + Poisson(mean-2).
    - **outliers**: ``outlier_fraction`` of observations replaced with
      uniform garbage pixels — exercises the Huber kernel
      (``robust_kernel_impl.h``) on both sides of the comparison.
    - **noisy intrinsics** (f +-5%, k1/k2 jittered) and **perturbed
      initial estimates** (points sigma = 2% of depth; rotations 0.005 rad,
      translations 0.05): the stored estimates are away from the optimum,
      as in the real captures, so the optimizer does real work.

    Observations come from the TRUE geometry + noise; the stored
    camera/point values are the perturbed ones — both the reference
    ``bal_example`` and our loader read the identical file 1:1.
    """
    rng = np.random.default_rng(seed)
    C, P = n_cameras, n_points

    # ground-truth cameras on two stacked arcs ~10 units from the cloud
    cams = np.zeros((C, 9))
    ang = 0.8 * (np.arange(C) / max(C - 1, 1) - 0.5)
    cams[:, 1] = -ang                                   # yaw about y
    cams[:, 0] = 0.05 * rng.standard_normal(C)          # slight tilt
    cams[:, 3] = 2.0 * np.sin(ang)
    cams[:, 4] = 0.4 * rng.standard_normal(C)
    cams[:, 5] = -10.0 + np.cos(ang)
    cams[:, 6] = 800.0 * (1.0 + 0.05 * rng.standard_normal(C))
    cams[:, 7] = -1e-7 * (1.0 + 0.3 * rng.standard_normal(C))
    cams[:, 8] = 1e-13 * (1.0 + 0.3 * rng.standard_normal(C))

    # log-normal depths; lateral position within a ~30deg cone so every
    # camera sees every point (bounded |proj|)
    depth = np.exp(rng.normal(np.log(8.0), depth_sigma, P))
    depth = np.clip(depth, 1.5, 60.0)
    ux = rng.uniform(-0.45, 0.45, P)
    uy = rng.uniform(-0.35, 0.35, P)
    pts = np.stack([ux * depth, uy * depth, 10.0 - depth], axis=1)

    # weighted track sampling: hub cameras get hub_boost x weight
    w = np.ones(C)
    w[rng.random(C) < hub_fraction] = hub_boost
    k_per_pt = 2 + rng.poisson(max(mean_obs_per_point - 2, 0), P)
    k_per_pt = np.minimum(k_per_pt, C)
    kmax = int(k_per_pt.max())
    gumbel = rng.gumbel(size=(P, C))
    keys = np.log(w)[None, :] + gumbel
    sel = np.argsort(-keys, axis=1)[:, :kmax]           # (P, kmax)
    row_mask = np.arange(kmax)[None, :] < k_per_pt[:, None]
    pt_idx = np.repeat(np.arange(P), kmax)[row_mask.ravel()]
    cam_idx = sel.ravel()[row_mask.ravel()]

    from g2o_tpu.types.bal import bal_project
    import jax.numpy as jnp

    uv = np.asarray(bal_project(jnp.asarray(cams[cam_idx]),
                                jnp.asarray(pts[pt_idx])))
    uv = uv + rng.normal(scale=pixel_noise, size=uv.shape)
    out_mask = rng.random(len(uv)) < outlier_fraction
    uv[out_mask] = rng.uniform(-500.0, 500.0, (int(out_mask.sum()), 2))

    # perturbed stored estimates (the file's initial values)
    cams_store = cams.copy()
    pts_store = pts.copy()
    if estimate_noise:
        cams_store[:, :3] += 0.005 * rng.standard_normal((C, 3))
        cams_store[:, 3:6] += 0.05 * rng.standard_normal((C, 3))
        pts_store += (0.02 * depth)[:, None] * rng.standard_normal((P, 3))

    lines = [f"{C} {P} {len(uv)}"]
    lines += [f"{c} {j} {u:.6f} {v:.6f}"
              for c, j, (u, v) in zip(cam_idx.tolist(), pt_idx.tolist(), uv)]
    for i in range(C):
        lines += [f"{v:.16g}" for v in cams_store[i]]
    for j in range(P):
        lines += [f"{v:.16g}" for v in pts_store[j]]
    return "\n".join(lines) + "\n"


def stress_bal_cached(cache_dir=None, **kw):
    """Disk-cached :func:`make_stress_bal` text (see
    :func:`synthetic_bal_cached` for the caching rationale)."""
    import gzip
    import os

    defaults = dict(n_cameras=120, n_points=30_000, mean_obs_per_point=6,
                    depth_sigma=0.8, hub_fraction=0.1, hub_boost=10.0,
                    outlier_fraction=0.07, pixel_noise=1.0,
                    estimate_noise=True, seed=0)
    defaults.update(kw)
    key = "-".join(f"{k}{v:g}" if isinstance(v, (int, float)) else f"{k}{v}"
                   for k, v in sorted(defaults.items()))
    fname = f"balstress-{key}.txt.gz"
    repo_dir = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "data", "bal_cache")
    for d in ([cache_dir] if cache_dir else []) + [repo_dir, _SPARE_CACHE]:
        path = os.path.join(d, fname)
        if os.path.exists(path):
            with gzip.open(path, "rt") as fh:
                return fh.read()
    text = make_stress_bal(**defaults)
    for d in ([cache_dir] if cache_dir else []) + [repo_dir, _SPARE_CACHE]:
        try:
            os.makedirs(d, exist_ok=True)
            with gzip.open(os.path.join(d, fname), "wt") as fh:
                fh.write(text)
            break
        except OSError:
            continue
    return text


def make_synthetic_bal(n_cameras=49, n_points=7000, n_obs_per_point=6,
                       pixel_noise=1.0, seed=0):
    """Ladybug-like synthetic BAL problem (no dataset download in this
    environment): cameras on an arc looking inward at a point cloud."""
    from g2o_tpu.types.bal import bal_project
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    cams = np.zeros((n_cameras, 9))
    for i in range(n_cameras):
        ang = 0.6 * (i / max(n_cameras - 1, 1) - 0.5)
        # camera at radius 10 on an arc in the x-z plane, looking at origin:
        # rotation about y by -ang maps world to camera (approximately)
        cams[i, :3] = [0.0, -ang, 0.0]
        cams[i, 3:6] = [10 * np.sin(ang) * 0.2, 0.0, -10.0 + np.cos(ang)]
        cams[i, 6] = 800.0 + rng.normal() * 5
        cams[i, 7] = -1e-7
        cams[i, 8] = 1e-13
    pts = np.stack([
        rng.uniform(-4, 4, n_points),
        rng.uniform(-3, 3, n_points),
        rng.uniform(-2, 2, n_points),
    ], axis=1)

    # vectorized observation generation: k distinct cameras per point via
    # random-key argsort, then one batched projection
    k = min(n_obs_per_point, n_cameras)
    keys = rng.random((n_points, n_cameras))
    sel = np.argsort(keys, axis=1)[:, :k]                      # (P, k)
    cams_sel = cams[sel.reshape(-1)]                           # (P*k, 9)
    pts_rep = np.repeat(pts, k, axis=0)                        # (P*k, 3)
    uv = np.asarray(bal_project(jnp.asarray(cams_sel),
                                jnp.asarray(pts_rep)))
    uv = uv + rng.normal(scale=pixel_noise, size=uv.shape)
    pt_idx = np.repeat(np.arange(n_points), k)
    obs = list(zip(sel.reshape(-1).tolist(), pt_idx.tolist(),
                   uv[:, 0].tolist(), uv[:, 1].tolist()))

    lines = [f"{n_cameras} {n_points} {len(obs)}"]
    lines += [f"{c} {j} {u:.6f} {v:.6f}" for c, j, u, v in obs]
    for i in range(n_cameras):
        lines += [f"{v:.16g}" for v in cams[i]]
    for j in range(n_points):
        lines += [f"{v:.16g}" for v in pts[j]]
    return "\n".join(lines) + "\n"
