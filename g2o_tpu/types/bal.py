"""BAL (Bundle Adjustment in the Large) types — analogue of the reference
``g2o/examples/bal/bal_example.cpp:65-285``.

Camera is the 9-dof BAL parameterisation [rodrigues(3), t(3), f, k1, k2]
with an *additive* update (``VertexCameraBAL::oplusImpl``); the projection
negates after perspective division and applies radial distortion
(``bal_example.cpp:191-244``).  Where the reference needs vendored Ceres
``jet.h`` autodiff headers (``EXTERNAL/ceres``), forward-mode ``jacfwd``
through this pure function is the native replacement (SURVEY.md §2.6).
"""

from __future__ import annotations

import jax.numpy as jnp

from g2o_tpu.core.types import EdgeType, VertexType, register_edge, register_vertex
from g2o_tpu.types.slam3d import VertexPointXYZ


def _additive(x, d):
    return x + d


VertexCameraBAL = register_vertex(VertexType(
    name="VERTEX_CAMERA_BAL",
    rep_dim=9,
    tangent_dim=9,
    oplus=_additive,
    tags=("VERTEX_CAMERA_BAL",),
))


def rodrigues_rotate(omega, p):
    """Rotate p by the axis-angle vector omega (derivative-safe at 0)."""
    theta2 = jnp.sum(omega * omega, axis=-1, keepdims=True)
    small = theta2 < 1e-14
    theta = jnp.sqrt(jnp.where(small, 1.0, theta2))
    v = omega / theta
    cth = jnp.cos(theta)
    sth = jnp.sin(theta)
    vxp = jnp.cross(v, p)
    vdotp = jnp.sum(v * p, axis=-1, keepdims=True)
    rotated = p * cth + vxp * sth + v * vdotp * (1.0 - cth)
    # Taylor branch: p + omega x p
    return jnp.where(small, p + jnp.cross(omega, p), rotated)


def bal_project(camera, point):
    """BAL projection: world point -> pixel prediction (2,)."""
    p = rodrigues_rotate(camera[..., :3], point) + camera[..., 3:6]
    proj = -p[..., :2] / p[..., 2:3]
    r2 = jnp.sum(proj * proj, axis=-1, keepdims=True)
    f = camera[..., 6:7]
    k1 = camera[..., 7:8]
    k2 = camera[..., 8:9]
    rp = 1.0 + k1 * r2 + k2 * r2 * r2
    return f * rp * proj


def _edge_bal_residual(states, meas, param):
    camera, point = states
    return bal_project(camera, point) - meas


EdgeObservationBAL = register_edge(EdgeType(
    name="EDGE_OBSERVATION_BAL",
    vertex_types=(VertexCameraBAL, VertexPointXYZ),
    residual_dim=2,
    residual=_edge_bal_residual,
    meas_dim=2,
    tags=("EDGE_OBSERVATION_BAL",),
))


def _skew(v):
    import numpy as np

    return np.array([[0.0, -v[2], v[1]],
                     [v[2], 0.0, -v[0]],
                     [-v[1], v[0], 0.0]])


def bal_gauge_directions(cams, pts=None):
    """The 7 analytic gauge directions of a FREE-GAUGE BAL problem.

    ``bal_example`` fixes no camera — a global similarity of the world
    (rotation R_g, translation d, scale 1+s) composed with the
    compensating camera motion leaves every reprojection invariant, so the
    Hessian has an (at λ=0) exactly-null 7-dim subspace whose orbit
    tangents are:

    * rotation k (X → exp([e_k]×) X): ``δω_i = −J_r(ω_i)^{-1} e_k``
      (right-perturbation of the additive Rodrigues parameterisation),
      ``δX = e_k × X``;
    * translation k (X → X + e_k): ``δt_i = −R(ω_i) e_k``, ``δX = e_k``;
    * scale (X → (1+s) X): ``δt_i = t_i``, ``δX = X`` (the perspective
      division −x/z and the radial term are scale-invariant).

    Returns ``(Gcam (N, 9, 7), Gpt (M, 3, 7) or None)`` as numpy float64.
    ``J·[Gcam; Gpt] = 0`` exactly (orbit tangents); the camera block alone
    is the null space of the REDUCED Schur system — the deflation basis
    for :class:`ImplicitSchurSolver` (late free-gauge λ→0 solves are
    near-singular along it, costing 15-130 CG iterations at Venice scale).
    """
    import numpy as np

    cams = np.asarray(cams, dtype=np.float64)
    N = cams.shape[0]
    # fully host-side + vectorized: the previous per-camera loop dispatched
    # an eager jnp rodrigues call per camera — N device round-trips at
    # setup
    w = cams[:, :3]
    t = cams[:, 3:6]
    th2 = np.einsum("ni,ni->n", w, w)
    th = np.sqrt(np.maximum(th2, 1e-300))
    W = np.zeros((N, 3, 3))
    W[:, 0, 1], W[:, 0, 2] = -w[:, 2], w[:, 1]
    W[:, 1, 0], W[:, 1, 2] = w[:, 2], -w[:, 0]
    W[:, 2, 0], W[:, 2, 1] = -w[:, 1], w[:, 0]
    WW = np.einsum("nij,njk->nik", W, W)
    eye = np.eye(3)[None]
    small = th2 < 1e-12
    # R = I + sinθ/θ W + (1-cosθ)/θ² W²  (Rodrigues)
    A = np.where(small, 1.0, np.sin(th) / th)[:, None, None]
    B = np.where(small, 0.5, (1.0 - np.cos(th)) / np.maximum(th2, 1e-300))
    R = eye + A * W + B[:, None, None] * WW
    # J_r(w)^{-1} = I + W/2 + c(θ) W², c → 1/12 as θ → 0
    c = np.where(small, 1.0 / 12.0,
                 1.0 / np.maximum(th2, 1e-300)
                 - (1.0 + np.cos(th))
                 / np.maximum(2.0 * th * np.sin(th), 1e-300))
    Jr_inv = eye + 0.5 * W + c[:, None, None] * WW
    Gcam = np.zeros((N, 9, 7))
    Gcam[:, :3, 0:3] = -Jr_inv        # rotation gauge
    Gcam[:, 3:6, 3:6] = -R            # translation gauge
    Gcam[:, 3:6, 6] = t               # scale gauge
    if pts is None:
        return Gcam, None
    pts = np.asarray(pts, dtype=np.float64)
    M = pts.shape[0]
    Gpt = np.zeros((M, 3, 7))
    for k in range(3):
        e = np.zeros(3)
        e[k] = 1.0
        Gpt[:, :, k] = np.cross(np.broadcast_to(e, pts.shape), pts)
        Gpt[:, k, 3 + k] = 1.0
    Gpt[:, :, 6] = pts
    return Gcam, Gpt


def bal_gauge_basis(problem, cam_type="VERTEX_CAMERA_BAL"):
    """Orthonormal camera-space deflation basis ``{cam_type: (N, 9, 7)}``
    from the problem's CURRENT estimates, ready for
    ``ImplicitSchurSolver(deflate_basis=...)``."""
    import numpy as np

    cams = np.asarray(problem.estimates[cam_type])
    Gcam, _ = bal_gauge_directions(cams)
    N = Gcam.shape[0]
    Q, _ = np.linalg.qr(Gcam.reshape(N * 9, 7))
    return {cam_type: Q.reshape(N, 9, 7)}
