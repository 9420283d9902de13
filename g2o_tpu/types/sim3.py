"""Sim3 types — JAX analogue of the reference ``g2o/types/sim3``
library (scale-drift-aware monocular loop closing).

Conventions (matching ``g2o/types/sim3/types_seven_dof_expmap.h``):

* ``VERTEX_SIM3:EXPMAP``: the estimate is a Sim3 (t, q, s); the update is a
  *left* multiplication ``S <- Sim3(update) * S`` with update =
  [omega(3), upsilon(3), sigma] (``:73-82``).  The reference stores two sets
  of pinhole intrinsics on the vertex (``_focal_length1/2``,
  ``_principle_point1/2``, ``:84-99``) used by the projection edges; here
  they are carried in the state vector tail (rep dims 8..15 =
  f1x f1y c1x c1y f2x f2y c2x c2y) and never touched by oplus.
* The reference's per-vertex ``_fix_scale`` flag (``:77-78``) is a separate
  registered vertex type ``VERTEX_SIM3:EXPMAP:FIXSCALE`` whose oplus zeroes
  the scale component.
* ``EDGE_SIM3:EXPMAP``: error = ``(Z * S1 * S2^-1).log()``
  (``:117-125``), 7-vector [omega, upsilon, sigma].
* ``.g2o`` serialisation stores ``Sim3.log()`` of the *inverse* estimate
  (cam2world) plus the first intrinsics set
  (``types_seven_dof_expmap.cpp:66-102``); edges store the log of the
  inverse measurement (``:104-136``).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from g2o_tpu.core.types import EdgeType, VertexType, register_edge, register_vertex
from g2o_tpu.ops import lie
from g2o_tpu.types.slam3d import VertexPointXYZ

REP_DIM = 16  # [t(3), q(4), s(1), f1(2), c1(2), f2(2), c2(2)]


def _sim3_part(x):
    return x[..., :8]


def _sim3_oplus(x, delta):
    s_new = lie.sim3_compose(lie.sim3_exp(delta), _sim3_part(x))
    q = lie.quat_normalize(s_new[..., 3:7])
    s_new = jnp.concatenate([s_new[..., :3], q, s_new[..., 7:8]], axis=-1)
    return jnp.concatenate([s_new, x[..., 8:]], axis=-1)


def _sim3_oplus_fix_scale(x, delta):
    delta = delta.at[..., 6].set(0.0)
    return _sim3_oplus(x, delta)


def _sim3_io_from_vector(v):
    """11 numbers: log7 of cam2world + f1(2) + c1(2) -> 16-dim state."""
    v = np.asarray(v)
    import numpy as _np

    cam2world = np.asarray(lie.sim3_exp(jnp.asarray(v[:7])))
    est = np.asarray(lie.sim3_inverse(jnp.asarray(cam2world)))
    f1, c1 = v[7:9], v[9:11]
    return _np.concatenate([est, f1, c1, f1, c1])


def _sim3_io_to_vector(x):
    x = np.asarray(x)
    cam2world = np.asarray(lie.sim3_inverse(jnp.asarray(x[:8])))
    lv = np.asarray(lie.sim3_log(jnp.asarray(cam2world)))
    return np.concatenate([lv, x[8:10], x[10:12]])


VertexSim3Expmap = register_vertex(VertexType(
    name="VERTEX_SIM3:EXPMAP",
    rep_dim=REP_DIM,
    tangent_dim=7,
    oplus=_sim3_oplus,
    to_vector=_sim3_io_to_vector,
    from_vector=_sim3_io_from_vector,
    tags=("VERTEX_SIM3:EXPMAP",),
    io_dim=11,
))

VertexSim3ExpmapFixScale = register_vertex(VertexType(
    name="VERTEX_SIM3:EXPMAP:FIXSCALE",
    rep_dim=REP_DIM,
    tangent_dim=7,
    oplus=_sim3_oplus_fix_scale,
    to_vector=_sim3_io_to_vector,
    from_vector=_sim3_io_from_vector,
    tags=("VERTEX_SIM3:EXPMAP:FIXSCALE",),
    io_dim=11,
))


def _edge_sim3_residual(states, meas, param):
    s1, s2 = states
    err = lie.sim3_compose(meas[..., :8],
                           lie.sim3_compose(_sim3_part(s1),
                                            lie.sim3_inverse(_sim3_part(s2))))
    return lie.sim3_log(err)


def _edge_sim3_meas_from_vector(v):
    cam2world = np.asarray(lie.sim3_exp(jnp.asarray(np.asarray(v)[:7])))
    return np.asarray(lie.sim3_inverse(jnp.asarray(cam2world)))


def _edge_sim3_meas_to_vector(m):
    cam2world = np.asarray(lie.sim3_inverse(jnp.asarray(np.asarray(m)[:8])))
    return np.asarray(lie.sim3_log(jnp.asarray(cam2world)))


EdgeSim3 = register_edge(EdgeType(
    name="EDGE_SIM3:EXPMAP",
    vertex_types=(VertexSim3Expmap, VertexSim3Expmap),
    residual_dim=7,
    residual=_edge_sim3_residual,
    meas_dim=8,
    meas_to_vector=_edge_sim3_meas_to_vector,
    meas_from_vector=_edge_sim3_meas_from_vector,
    tags=("EDGE_SIM3:EXPMAP",),
    meas_io_dim=7,
))


def _project2(p):
    return p[..., :2] / p[..., 2:3]


def _edge_sim3_project_residual(states, meas, param):
    """obs - cam_map1(project(S * p)) (``types_seven_dof_expmap.h:149-156``)."""
    point, s = states
    pc = lie.sim3_act(_sim3_part(s), point)
    uv = _project2(pc)
    f1, c1 = s[..., 8:10], s[..., 10:12]
    return meas - (uv * f1 + c1)


EdgeSim3ProjectXYZ = register_edge(EdgeType(
    name="EDGE_PROJECT_SIM3_XYZ:EXPMAP",
    vertex_types=(VertexPointXYZ, VertexSim3Expmap),
    residual_dim=2,
    residual=_edge_sim3_project_residual,
    meas_dim=2,
    tags=("EDGE_PROJECT_SIM3_XYZ:EXPMAP",),
))


def _edge_inverse_sim3_project_residual(states, meas, param):
    """obs - cam_map2(project(S^-1 * p)) (``:170-176``)."""
    point, s = states
    pc = lie.sim3_act(lie.sim3_inverse(_sim3_part(s)), point)
    uv = _project2(pc)
    f2, c2 = s[..., 12:14], s[..., 14:16]
    return meas - (uv * f2 + c2)


EdgeInverseSim3ProjectXYZ = register_edge(EdgeType(
    name="EDGE_PROJECT_INVERSE_SIM3_XYZ:EXPMAP",
    vertex_types=(VertexPointXYZ, VertexSim3Expmap),
    residual_dim=2,
    residual=_edge_inverse_sim3_project_residual,
    meas_dim=2,
    tags=("EDGE_PROJECT_INVERSE_SIM3_XYZ:EXPMAP",),
))
