"""Bundle-adjustment types — JAX analogue of the reference
``g2o/types/sba`` library (expmap variants).

Conventions (matching ``g2o/types/sba/types_six_dof_expmap.h``):

* ``VERTEX_SE3:EXPMAP``: the estimate is the world-to-camera transform
  ``Tcw`` stored as (t, q); the update is a *left* multiplication
  ``X <- SE3Quat::exp(update) * X`` with update = [omega, upsilon]
  (``types_six_dof_expmap.h:98-101``).
* ``EDGE_PROJECT_XYZ2UV:EXPMAP``: slot 0 = point, slot 1 = camera; error =
  ``obs - cam_map(Tcw * p)`` with shared ``CameraParameters``
  (focal_length, cx, cy, baseline) resolved by param id
  (``types_six_dof_expmap.h:140-152``, ``:46-65``).
* ``EDGE_PROJECT_XYZ2UVU:EXPMAP``: stereo (u_left, v_left, u_right) with
  ``u_right = u_left - focal*baseline/z`` (``stereocam_uvu_map``).
* ``EDGE_SE3:EXPMAP``: camera-camera edge, error =
  ``(X2^-1 * Z * X1).log()`` in [omega, upsilon] order
  (``types_six_dof_expmap.h:117-124``).
"""

from __future__ import annotations

import jax.numpy as jnp

from g2o_tpu.core.types import EdgeType, VertexType, register_edge, register_vertex
from g2o_tpu.ops import lie
from g2o_tpu.types.slam3d import VertexPointXYZ  # VERTEX_XYZ shares semantics

# conventional parameter id for the shared camera (ba_demo uses 0)
CAM_PARAM_ID = 0


def _expmap_oplus(x, delta):
    """X <- exp([omega, upsilon]) * X."""
    return lie.se3_normalize(lie.se3_compose(lie.se3quat_exp(delta), x))


VertexSE3Expmap = register_vertex(VertexType(
    name="VERTEX_SE3:EXPMAP",
    rep_dim=7,
    tangent_dim=6,
    oplus=_expmap_oplus,
    tags=("VERTEX_SE3:EXPMAP",),
))


def cam_map(pc, param):
    """Pinhole projection with CameraParameters (focal, cx, cy, baseline)."""
    focal, cx, cy = param[0], param[1], param[2]
    invz = 1.0 / pc[..., 2]
    return jnp.stack(
        [focal * pc[..., 0] * invz + cx, focal * pc[..., 1] * invz + cy],
        axis=-1,
    )


def _edge_project_xyz2uv_residual(states, meas, param):
    point, camera = states
    pc = lie.se3_act(camera, point)
    return meas - cam_map(pc, param)


EdgeProjectXYZ2UV = register_edge(EdgeType(
    name="EDGE_PROJECT_XYZ2UV:EXPMAP",
    vertex_types=(VertexPointXYZ, VertexSE3Expmap),
    residual_dim=2,
    residual=_edge_project_xyz2uv_residual,
    meas_dim=2,
    param_dim=4,
    tags=("EDGE_PROJECT_XYZ2UV:EXPMAP", "EDGE_PROJECT_XYZ2UV"),
))


def _edge_project_xyz2uvu_residual(states, meas, param):
    point, camera = states
    focal, cx, cy, baseline = param[0], param[1], param[2], param[3]
    pc = lie.se3_act(camera, point)
    invz = 1.0 / pc[..., 2]
    u = focal * pc[..., 0] * invz + cx
    v = focal * pc[..., 1] * invz + cy
    ur = u - focal * baseline * invz
    return meas - jnp.stack([u, v, ur], axis=-1)


EdgeProjectXYZ2UVU = register_edge(EdgeType(
    name="EDGE_PROJECT_XYZ2UVU:EXPMAP",
    vertex_types=(VertexPointXYZ, VertexSE3Expmap),
    residual_dim=3,
    residual=_edge_project_xyz2uvu_residual,
    meas_dim=3,
    param_dim=4,
    tags=("EDGE_PROJECT_XYZ2UVU:EXPMAP",),
))


# --- classic SBA types (reference ``types_sba.h``, ``sbacam.h``) --------- #
# VertexCam state = [t(3), q(4 xyzw), fx, fy, cx, cy, baseline] (rep 12).
# SBACam::update (``sbacam.h:95-111``): global-additive translation, small
# compact-quaternion POST-multiplication on the rotation; intrinsics fixed.


def _vertex_cam_oplus(x, delta):
    t = x[..., :3] + delta[..., :3]
    dq = lie.quat_from_compact(delta[..., 3:6])
    q = lie.quat_normalize(lie.quat_mul(x[..., 3:7], dq))
    return jnp.concatenate([t, q, x[..., 7:]], axis=-1)


VertexCam = register_vertex(VertexType(
    name="VERTEX_CAM",
    rep_dim=12,
    tangent_dim=6,
    oplus=_vertex_cam_oplus,
    tags=("VERTEX_CAM",),
))

def _intrinsics_oplus(x, d):
    # reference BaseVertex<4, Vector5> (``types_sba.h``): only fx/fy/cx/cy
    # are optimized dofs; the baseline stays a constant payload.  A 5th
    # tangent slot would carry an all-zero Jacobian column (no edge reads
    # intr[4]) -> singular H row for any direct solve.
    return jnp.concatenate([x[..., :4] + d, x[..., 4:5]], axis=-1)


VertexIntrinsics = register_vertex(VertexType(
    name="VERTEX_INTRINSICS",
    rep_dim=5,
    tangent_dim=4,
    oplus=_intrinsics_oplus,
    tags=("VERTEX_INTRINSICS",),
))


def _cam_w2n_apply(cam, pw):
    """world -> node frame: R^T (p - t) (``sbacam.h`` transformW2F)."""
    t, q = cam[..., :3], cam[..., 3:7]
    return lie.quat_rotate(lie.quat_conj(q), pw - t)


def _edge_p2mc_residual(states, meas, param):
    """Mono projection (``types_sba.h:168-189``): p = K w2n pt;
    error = p.xy/p.z - z."""
    point, cam = states
    pn = _cam_w2n_apply(cam, point)
    fx, fy, cx, cy = cam[..., 7], cam[..., 8], cam[..., 9], cam[..., 10]
    u = fx * pn[..., 0] + cx * pn[..., 2]
    v = fy * pn[..., 1] + cy * pn[..., 2]
    perr = jnp.stack([u / pn[..., 2], v / pn[..., 2]], axis=-1)
    return perr - meas


EdgeProjectP2MC = register_edge(EdgeType(
    name="EDGE_PROJECT_P2MC",
    vertex_types=(VertexPointXYZ, VertexCam),
    residual_dim=2,
    residual=_edge_p2mc_residual,
    meas_dim=2,
    tags=("EDGE_PROJECT_P2MC",),
))


def _edge_p2sc_residual(states, meas, param):
    """Stereo projection (``types_sba.h:207-236``): [u, v, u_right]."""
    point, cam = states
    pn = _cam_w2n_apply(cam, point)
    fx, fy, cx, cy = cam[..., 7], cam[..., 8], cam[..., 9], cam[..., 10]
    baseline = cam[..., 11]
    u = (fx * pn[..., 0] + cx * pn[..., 2]) / pn[..., 2]
    v = (fy * pn[..., 1] + cy * pn[..., 2]) / pn[..., 2]
    # right camera: shift node frame by baseline along x
    xr = pn[..., 0] - baseline
    ur = (fx * xr + cx * pn[..., 2]) / pn[..., 2]
    return jnp.stack([u, v, ur], axis=-1) - meas


EdgeProjectP2SC = register_edge(EdgeType(
    name="EDGE_PROJECT_P2SC",
    vertex_types=(VertexPointXYZ, VertexCam),
    residual_dim=3,
    residual=_edge_p2sc_residual,
    meas_dim=3,
    tags=("EDGE_PROJECT_P2SC",),
))


def _edge_sba_cam_residual(states, meas, param):
    """Camera-camera constraint (``types_sba.h:292-303``): error =
    [t, q.vec] of Z^-1 (X1^-1 X2) on the pose part."""
    c1, c2 = states
    x1, x2 = c1[..., :7], c2[..., :7]
    delta = lie.se3_compose(lie.se3_inverse(x1), x2)
    err = lie.se3_compose(lie.se3_inverse(meas), delta)
    # the reference's SE3Quat::operator* normalizeRotation() flips the
    # composed quaternion to w >= 0 before the vec part is read — without
    # the flip the rotation error changes sign past 180 deg and chi2
    # stops being bit-comparable under full information matrices
    wsign = jnp.where(err[..., 6:7] < 0, -1.0, 1.0)
    return jnp.concatenate([err[..., :3], wsign * err[..., 3:6]], axis=-1)


EdgeSBACam = register_edge(EdgeType(
    name="EDGE_CAM",
    vertex_types=(VertexCam, VertexCam),
    residual_dim=6,
    residual=_edge_sba_cam_residual,
    meas_dim=7,
    tags=("EDGE_CAM",),
))


def _edge_sba_scale_residual(states, meas, param):
    """Distance constraint between camera centres (``types_sba.h:345-351``)."""
    c1, c2 = states
    dt = c2[..., :3] - c1[..., :3]
    # double-where norm guard (CLAUDE.md): reverse mode is the default
    # here (residual_dim 1 < 12 tangent dims) and d|dt|/d dt at 0 is NaN
    d2 = jnp.sum(dt * dt, axis=-1, keepdims=True)
    sel = d2 > 0
    dist = jnp.where(sel, jnp.sqrt(jnp.where(sel, d2, 1.0)), 0.0)
    return meas - dist


EdgeSBAScale = register_edge(EdgeType(
    name="EDGE_SCALE",
    vertex_types=(VertexCam, VertexCam),
    residual_dim=1,
    residual=_edge_sba_scale_residual,
    meas_dim=1,
    tags=("EDGE_SCALE",),
))


def _edge_p2mc_intrinsics_residual(states, meas, param):
    """Mono projection with a shared optimizable intrinsics vertex
    (reference ``EdgeProjectP2MC_Intrinsics``, ``types_sba.h:254-279`` —
    there the error uses the camera's cached K while the Jacobian differentiates
    the intrinsics vertex; here the intrinsics vertex IS the projection's K,
    which is the evident intent)."""
    point, cam, intr = states
    pn = _cam_w2n_apply(cam, point)
    fx, fy, cx, cy = intr[..., 0], intr[..., 1], intr[..., 2], intr[..., 3]
    u = (fx * pn[..., 0] + cx * pn[..., 2]) / pn[..., 2]
    v = (fy * pn[..., 1] + cy * pn[..., 2]) / pn[..., 2]
    return jnp.stack([u, v], axis=-1) - meas


EdgeProjectP2MCIntrinsics = register_edge(EdgeType(
    name="EDGE_PROJECT_P2MC_INTRINSICS",
    vertex_types=(VertexPointXYZ, VertexCam, VertexIntrinsics),
    residual_dim=2,
    residual=_edge_p2mc_intrinsics_residual,
    meas_dim=2,
    tags=("EDGE_PROJECT_P2MC_INTRINSICS",),
))


# --- ORB-SLAM-style projection edges (per-edge intrinsics as params) ----- #
# Reference classes store fx/fy/cx/cy (and bf for stereo) as public edge
# members set programmatically (``types_six_dof_expmap.h:200-290``,
# ``types_six_dof_expmap.cpp:278-695``); here they are a parameter block.


def _cam_project2(pc, k):
    fx, fy, cx, cy = k[..., 0], k[..., 1], k[..., 2], k[..., 3]
    invz = 1.0 / pc[..., 2]
    return jnp.stack([fx * pc[..., 0] * invz + cx,
                      fy * pc[..., 1] * invz + cy], axis=-1)


def _edge_se3_project_xyz_residual(states, meas, param):
    point, camera = states
    pc = lie.se3_act(camera, point)
    return meas - _cam_project2(pc, param)


EdgeSE3ProjectXYZ = register_edge(EdgeType(
    name="EDGE_SE3_PROJECT_XYZ:EXPMAP",
    vertex_types=(VertexPointXYZ, VertexSE3Expmap),
    residual_dim=2,
    residual=_edge_se3_project_xyz_residual,
    meas_dim=2,
    param_dim=4,
    tags=("EDGE_SE3_PROJECT_XYZ:EXPMAP",),
))


def _edge_stereo_se3_project_xyz_residual(states, meas, param):
    point, camera = states
    pc = lie.se3_act(camera, point)
    uv = _cam_project2(pc, param[..., :4])
    bf = param[..., 4]
    ur = uv[..., 0] - bf / pc[..., 2]
    return meas - jnp.concatenate([uv, ur[..., None]], axis=-1)


EdgeStereoSE3ProjectXYZ = register_edge(EdgeType(
    name="EDGE_STEREO_SE3_PROJECT_XYZ:EXPMAP",
    vertex_types=(VertexPointXYZ, VertexSE3Expmap),
    residual_dim=3,
    residual=_edge_stereo_se3_project_xyz_residual,
    meas_dim=3,
    param_dim=5,
    tags=("EDGE_STEREO_SE3_PROJECT_XYZ:EXPMAP",),
))


def _edge_se3_project_xyz_onlypose_residual(states, meas, param):
    """Unary pose-only variant: the world point rides in the measurement
    tail (reference stores it as the ``Xw`` member)."""
    (camera,) = states
    obs, Xw = meas[..., :2], meas[..., 2:5]
    pc = lie.se3_act(camera, Xw)
    return obs - _cam_project2(pc, param)


EdgeSE3ProjectXYZOnlyPose = register_edge(EdgeType(
    name="EDGE_SE3_PROJECT_XYZONLYPOSE:EXPMAP",
    vertex_types=(VertexSE3Expmap,),
    residual_dim=2,
    residual=_edge_se3_project_xyz_onlypose_residual,
    meas_dim=5,
    param_dim=4,
    tags=("EDGE_SE3_PROJECT_XYZONLYPOSE:EXPMAP",),
))


def _edge_stereo_se3_project_xyz_onlypose_residual(states, meas, param):
    (camera,) = states
    obs, Xw = meas[..., :3], meas[..., 3:6]
    pc = lie.se3_act(camera, Xw)
    uv = _cam_project2(pc, param[..., :4])
    bf = param[..., 4]
    ur = uv[..., 0] - bf / pc[..., 2]
    return obs - jnp.concatenate([uv, ur[..., None]], axis=-1)


EdgeStereoSE3ProjectXYZOnlyPose = register_edge(EdgeType(
    name="EDGE_STEREO_SE3_PROJECT_XYZONLYPOSE:EXPMAP",
    vertex_types=(VertexSE3Expmap,),
    residual_dim=3,
    residual=_edge_stereo_se3_project_xyz_onlypose_residual,
    meas_dim=6,
    param_dim=5,
    tags=("EDGE_STEREO_SE3_PROJECT_XYZONLYPOSE:EXPMAP",),
))


def _edge_project_psi2uv_residual(states, meas, param):
    """Inverse-depth 3-ary edge (reference ``EdgeProjectPSI2UV``,
    ``types_six_dof_expmap.h:155-170``, impl ``types_six_dof_expmap.cpp``):
    point parameterised as psi = (u, v, rho) in the anchor frame T_anchor;
    error = obs - cam_map(T_cur * T_anchor^-1 * invert_depth(psi))."""
    psi, T_cur, T_anchor = states
    # invert_depth: (x, y, 1)/rho
    pw = jnp.stack([psi[..., 0], psi[..., 1], jnp.ones_like(psi[..., 0])],
                   axis=-1) / psi[..., 2:3]
    rel = lie.se3_compose(T_cur, lie.se3_inverse(T_anchor))
    pc = lie.se3_act(rel, pw)
    return meas - cam_map(pc, param)


EdgeProjectPSI2UV = register_edge(EdgeType(
    name="EDGE_PROJECT_PSI2UV:EXPMAP",
    vertex_types=(VertexPointXYZ, VertexSE3Expmap, VertexSE3Expmap),
    residual_dim=2,
    residual=_edge_project_psi2uv_residual,
    meas_dim=2,
    param_dim=4,
    tags=("EDGE_PROJECT_PSI2UV:EXPMAP",),
))


def _edge_se3_expmap_residual(states, meas, param):
    x1, x2 = states
    err = lie.se3_compose(lie.se3_inverse(x2),
                          lie.se3_compose(meas, x1))
    return lie.se3quat_log(err)


EdgeSE3Expmap = register_edge(EdgeType(
    name="EDGE_SE3:EXPMAP",
    vertex_types=(VertexSE3Expmap, VertexSE3Expmap),
    residual_dim=6,
    residual=_edge_se3_expmap_residual,
    meas_dim=7,
    tags=("EDGE_SE3:EXPMAP",),
))
