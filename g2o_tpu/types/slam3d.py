"""3D SLAM vertex/edge types — JAX analogue of the reference
``g2o/types/slam3d`` library.

State conventions (matching the reference so errors/chi2 agree):

* ``VERTEX_SE3:QUAT``: state (tx, ty, tz, qx, qy, qz, qw); update is a right
  multiplication by ``fromVectorMQT(delta)``
  (``g2o/types/slam3d/vertex_se3.h:105-114``).
* ``EDGE_SE3:QUAT``: error = ``toVectorMQT(Z^-1 Xi^-1 Xj)``
  (``g2o/types/slam3d/edge_se3.cpp:77-82``).
* ``EDGE_SE3_TRACKXYZ``: landmark observation through an SE3 sensor offset
  parameter (``g2o/types/slam3d/edge_se3_pointxyz.cpp``): error =
  ``(X * O)^-1 * l - z`` with offset O resolved from ``PARAMS_SE3OFFSET``.
* ``EDGE_SE3_PRIOR``: pose prior through an offset
  (``g2o/types/slam3d/edge_se3_prior.cpp``): error =
  ``toVectorMQT(Z^-1 * (X * O))``... see the residual below.
"""

from __future__ import annotations

import jax.numpy as jnp

from g2o_tpu.core.types import EdgeType, VertexType, register_edge, register_vertex
from g2o_tpu.ops import lie


def _point_oplus(x, d):
    return x + d


VertexSE3 = register_vertex(VertexType(
    name="VERTEX_SE3:QUAT",
    rep_dim=7,
    tangent_dim=6,
    oplus=lie.se3_oplus,
    tags=("VERTEX_SE3:QUAT",),
))

VertexPointXYZ = register_vertex(VertexType(
    name="VERTEX_TRACKXYZ",
    rep_dim=3,
    tangent_dim=3,
    oplus=_point_oplus,
    tags=("VERTEX_TRACKXYZ", "VERTEX_POINT_XYZ", "VERTEX_XYZ"),
))


def _edge_se3_residual(states, meas, param):
    xi, xj = states
    delta = lie.se3_compose(lie.se3_inverse(xi), xj)
    err = lie.se3_compose(lie.se3_inverse(meas), delta)
    return lie.se3_to_mqt(err)


EdgeSE3 = register_edge(EdgeType(
    name="EDGE_SE3:QUAT",
    vertex_types=(VertexSE3, VertexSE3),
    residual_dim=6,
    residual=_edge_se3_residual,
    meas_dim=7,
    tags=("EDGE_SE3:QUAT",),
))


def _edge_se3_trackxyz_residual(states, meas, param):
    x, l = states
    offset = param  # (7,) SE3 sensor offset
    sensor = lie.se3_compose(x, offset)
    return lie.se3_act(lie.se3_inverse(sensor), l) - meas


EdgeSE3PointXYZ = register_edge(EdgeType(
    name="EDGE_SE3_TRACKXYZ",
    vertex_types=(VertexSE3, VertexPointXYZ),
    residual_dim=3,
    residual=_edge_se3_trackxyz_residual,
    meas_dim=3,
    param_dim=7,
    tags=("EDGE_SE3_TRACKXYZ",),
))


def _edge_se3_prior_residual(states, meas, param):
    """Reference ``EdgeSE3Prior::computeError``: the error of the
    offset-transformed pose wrt the measured pose, in MQT coords."""
    (x,) = states
    offset = param
    n = lie.se3_compose(x, offset)
    err = lie.se3_compose(lie.se3_inverse(meas), n)
    return lie.se3_to_mqt(err)


EdgeSE3Prior = register_edge(EdgeType(
    name="EDGE_SE3_PRIOR",
    vertex_types=(VertexSE3,),
    residual_dim=6,
    residual=_edge_se3_prior_residual,
    meas_dim=7,
    param_dim=7,
    tags=("EDGE_SE3_PRIOR",),
))


def _edge_pointxyz_residual(states, meas, param):
    p1, p2 = states
    return (p2 - p1) - meas


EdgePointXYZ = register_edge(EdgeType(
    name="EDGE_POINTXYZ",
    vertex_types=(VertexPointXYZ, VertexPointXYZ),
    residual_dim=3,
    residual=_edge_pointxyz_residual,
    meas_dim=3,
    tags=("EDGE_POINTXYZ",),
))


def _edge_xyz_prior_residual(states, meas, param):
    (p,) = states
    return p - meas


EdgeXYZPrior = register_edge(EdgeType(
    name="EDGE_POINTXYZ_PRIOR",
    vertex_types=(VertexPointXYZ,),
    residual_dim=3,
    residual=_edge_xyz_prior_residual,
    meas_dim=3,
    tags=("EDGE_POINTXYZ_PRIOR",),
))


_LOTS_OF_XYZ_CACHE: dict = {}


def make_edge_se3_lots_of_xyz(k: int) -> EdgeType:
    """Variable-arity 3D landmark edge (reference ``EdgeSE3LotsOfXYZ``,
    ``edge_se3_lotsofxyz.h``) — one cached static-arity specialization per
    observed-point count (see the 2D counterpart for rationale)."""
    et = _LOTS_OF_XYZ_CACHE.get(k)
    if et is not None:
        return et

    def residual(states, meas, param):
        x = states[0]
        inv = lie.se3_inverse(x)
        preds = [lie.se3_act(inv, p) for p in states[1:]]
        return jnp.concatenate(preds, axis=-1) - meas

    et = register_edge(EdgeType(
        name=f"EDGE_SE3_LOTSOF_XYZ_{k}",
        vertex_types=(VertexSE3,) + (VertexPointXYZ,) * k,
        residual_dim=3 * k,
        residual=residual,
        meas_dim=3 * k,
        tags=(f"EDGE_SE3_LOTSOF_XYZ_{k}",),
        dynamic_tag="EDGE_SE3_LOTSOF_XYZ",
    ))
    _LOTS_OF_XYZ_CACHE[k] = et
    return et


# variable-arity text lines (reference tag registration
# ``types_slam3d.cpp:56``)
from g2o_tpu.core.types import REGISTRY as _REG  # noqa: E402

_REG.register_dynamic_edge("EDGE_SE3_LOTSOF_XYZ", make_edge_se3_lots_of_xyz)


def _edge_se3_offset_residual(states, meas, param):
    """Reference ``EdgeSE3Offset::computeError``
    (``g2o/types/slam3d/edge_se3_offset.cpp:102-105``): two poses observed
    through per-end sensor offsets; params = [offset_from(7), offset_to(7)].
    error = toVectorMQT(Z^-1 * (Xi Oi)^-1 * (Xj Oj))."""
    xi, xj = states
    oi, oj = param[..., :7], param[..., 7:14]
    ni = lie.se3_compose(xi, oi)
    nj = lie.se3_compose(xj, oj)
    delta = lie.se3_compose(lie.se3_inverse(ni), nj)
    return lie.se3_to_mqt(lie.se3_compose(lie.se3_inverse(meas), delta))


EdgeSE3Offset = register_edge(EdgeType(
    name="EDGE_SE3_OFFSET",
    vertex_types=(VertexSE3, VertexSE3),
    residual_dim=6,
    residual=_edge_se3_offset_residual,
    meas_dim=7,
    param_dim=14,
    num_params=2,
    tags=("EDGE_SE3_OFFSET",),
))


def _w2i(x, param):
    """World-to-image map from a ParameterCamera value
    [offset(7), fx, fy, cx, cy] (``g2o/types/slam3d/parameter_camera.cpp:63-84``,
    cache ``:96``): p_img = K * (X * O)^-1 * p_world."""
    offset, k = param[..., :7], param[..., 7:11]
    sensor = lie.se3_compose(x, offset)
    pc = lambda pw: lie.se3_act(lie.se3_inverse(sensor), pw)  # noqa: E731
    fx, fy, cx, cy = k[..., 0], k[..., 1], k[..., 2], k[..., 3]

    def apply(pw):
        p = pc(pw)
        return jnp.stack(
            [fx * p[..., 0] + cx * p[..., 2],
             fy * p[..., 1] + cy * p[..., 2],
             p[..., 2]],
            axis=-1,
        )

    return apply


def _edge_project_depth_residual(states, meas, param):
    """Reference ``EdgeSE3PointXYZDepth::computeError``
    (``edge_se3_pointxyz_depth.cpp:91-104``): error = [u/w, v/w, w] - z."""
    x, l = states
    p = _w2i(x, param)(l)
    perr = jnp.stack([p[..., 0] / p[..., 2], p[..., 1] / p[..., 2],
                      p[..., 2]], axis=-1)
    return perr - meas


EdgeSE3PointXYZDepth = register_edge(EdgeType(
    name="EDGE_PROJECT_DEPTH",
    vertex_types=(VertexSE3, VertexPointXYZ),
    residual_dim=3,
    residual=_edge_project_depth_residual,
    meas_dim=3,
    param_dim=11,
    tags=("EDGE_PROJECT_DEPTH",),
))


def _edge_project_disparity_residual(states, meas, param):
    """Reference ``EdgeSE3PointXYZDisparity::computeError``
    (``edge_se3_pointxyz_disparity.cpp:97-122``): error = [u/w, v/w, 1/w] - z."""
    x, l = states
    p = _w2i(x, param)(l)
    perr = jnp.stack([p[..., 0] / p[..., 2], p[..., 1] / p[..., 2],
                      1.0 / p[..., 2]], axis=-1)
    return perr - meas


EdgeSE3PointXYZDisparity = register_edge(EdgeType(
    name="EDGE_PROJECT_DISPARITY",
    vertex_types=(VertexSE3, VertexPointXYZ),
    residual_dim=3,
    residual=_edge_project_disparity_residual,
    meas_dim=3,
    param_dim=11,
    tags=("EDGE_PROJECT_DISPARITY",),
))


# ---- deprecated tag spellings (types/deprecated/slam3d) ----
# The reference ships a deprecated slam3d library whose DEPRECATED_* tag
# registrations are compiled out to avoid symbol clashes
# (``types/deprecated/slam3d/types_slam3d.cpp:36-52``); datasets written
# with it still carry the prefixed tags, so accept them as aliases.
from g2o_tpu.core.types import REGISTRY as _REGISTRY  # noqa: E402

for _dep, _cur in (
    ("DEPRECATED_VERTEX_SE3:QUAT", "VERTEX_SE3:QUAT"),
    ("DEPRECATED_EDGE_SE3:QUAT", "EDGE_SE3:QUAT"),
    ("DEPRECATED_VERTEX_TRACKXYZ", "VERTEX_TRACKXYZ"),
    ("DEPRECATED_EDGE_SE3_TRACKXYZ", "EDGE_SE3_TRACKXYZ"),
    ("DEPRECATED_EDGE_SE3_PRIOR", "EDGE_SE3_PRIOR"),
    ("DEPRECATED_EDGE_SE3_OFFSET", "EDGE_SE3_OFFSET"),
    ("DEPRECATED_EDGE_PROJECT_DISPARITY", "EDGE_PROJECT_DISPARITY"),
    ("DEPRECATED_EDGE_PROJECT_DEPTH", "EDGE_PROJECT_DEPTH"),
):
    _REGISTRY.alias_tag(_dep, _cur)
