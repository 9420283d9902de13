"""Lie-group primitives for the graph optimizer.

Pure jnp functions operating on the *last* axis of arrays so every op can be
``jax.vmap``-ed over batches of poses.  Conventions match the reference
framework so that error vectors (and therefore chi2) are bit-comparable:

* SE2 state is the vector ``(x, y, theta)``; composition follows the usual
  planar rigid-body rule (cf. reference ``g2o/types/slam2d/se2.h``).
* SE3 state is ``(tx, ty, tz, qx, qy, qz, qw)`` — translation followed by a
  unit quaternion in Eigen coefficient order (x, y, z, w).
* The 6-dof SE3 error/update vector is the "MQT" parameterisation used by the
  reference (``g2o/types/slam3d/isometry3d_mappings.cpp:95-123``):
  ``[t, q.vec]`` where ``q`` is normalized with ``w > 0``.
* The SE3 vertex update is a *right* multiplication
  ``X <- X * fromVectorMQT(delta)`` (reference
  ``g2o/types/slam3d/vertex_se3.h:105-114``).

No code is copied from the reference; only the mathematical conventions are
reproduced (they are textbook formulas).
"""

from __future__ import annotations

import jax.numpy as jnp

_PI = jnp.pi


# --------------------------------------------------------------------------- #
# scalars / SO(2)
# --------------------------------------------------------------------------- #

def normalize_angle(theta):
    """Wrap angle(s) to [-pi, pi)."""
    return theta - 2.0 * _PI * jnp.floor((theta + _PI) / (2.0 * _PI))


# --------------------------------------------------------------------------- #
# SE(2) — state vector (x, y, theta)
# --------------------------------------------------------------------------- #

def se2_compose(a, b):
    """a * b for SE2 vectors (..., 3)."""
    xa, ya, ta = a[..., 0], a[..., 1], a[..., 2]
    xb, yb, tb = b[..., 0], b[..., 1], b[..., 2]
    c, s = jnp.cos(ta), jnp.sin(ta)
    return jnp.stack(
        [
            xa + c * xb - s * yb,
            ya + s * xb + c * yb,
            normalize_angle(ta + tb),
        ],
        axis=-1,
    )


def se2_inverse(a):
    x, y, t = a[..., 0], a[..., 1], a[..., 2]
    c, s = jnp.cos(t), jnp.sin(t)
    return jnp.stack(
        [-(c * x + s * y), -(-s * x + c * y), normalize_angle(-t)], axis=-1
    )


def se2_act(a, p):
    """Apply SE2 transform a (..., 3) to 2D point p (..., 2)."""
    x, y, t = a[..., 0], a[..., 1], a[..., 2]
    c, s = jnp.cos(t), jnp.sin(t)
    px, py = p[..., 0], p[..., 1]
    return jnp.stack([x + c * px - s * py, y + s * px + c * py], axis=-1)


def se2_oplus(x, delta):
    """Reference VertexSE2 update: additive with angle renormalisation
    (``g2o/types/slam2d/vertex_se2.h:51-58``)."""
    return jnp.stack(
        [
            x[..., 0] + delta[..., 0],
            x[..., 1] + delta[..., 1],
            normalize_angle(x[..., 2] + delta[..., 2]),
        ],
        axis=-1,
    )


# --------------------------------------------------------------------------- #
# quaternions — coefficient order (x, y, z, w)
# --------------------------------------------------------------------------- #

def quat_identity(shape=(), dtype=jnp.float64):
    q = jnp.zeros(shape + (4,), dtype=dtype)
    return q.at[..., 3].set(1.0)


def quat_mul(q1, q2):
    x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    x2, y2, z2, w2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return jnp.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        axis=-1,
    )


def quat_conj(q):
    return jnp.concatenate([-q[..., :3], q[..., 3:4]], axis=-1)


def quat_normalize(q):
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def quat_positive(q):
    """Flip sign so the scalar part is >= 0 (reference ``internal::normalized``)."""
    sign = jnp.where(q[..., 3:4] < 0.0, -1.0, 1.0)
    return q * sign


def quat_rotate(q, v):
    """Rotate vector(s) v (..., 3) by quaternion(s) q (..., 4)."""
    qv = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * jnp.cross(qv, v)
    return v + w * t + jnp.cross(qv, t)


def quat_to_matrix(q):
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = jnp.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def quat_from_matrix(R):
    """Rotation matrix -> quaternion (x, y, z, w), w >= 0.

    Branchless Shepperd-style construction (safe under jit)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    cond_w = tr > 0.0
    cond_x = (m00 >= m11) & (m00 >= m22)
    cond_y = m11 >= m22
    # selection masks per branch — the sqrt ARGUMENTS of unselected
    # branches are where-guarded to 1.0: sqrt's VJP at 0 is inf, and VJPs
    # SUM cotangents, so 0·inf = NaN poisons reverse-mode Jacobians even
    # though the forward select discards the value (double-where trick)
    sel_w = cond_w
    sel_x = ~cond_w & cond_x
    sel_y = ~cond_w & ~cond_x & cond_y
    sel_z = ~cond_w & ~cond_x & ~cond_y

    def _sel_sqrt(x, sel):
        return jnp.sqrt(jnp.where(sel, jnp.maximum(x, 1e-24), 1.0))

    # four candidate constructions; pick the numerically best one
    qw_w = _sel_sqrt(1.0 + tr, sel_w) / 2.0
    q_w = jnp.stack(
        [m21 - m12, m02 - m20, m10 - m01, 4.0 * qw_w * qw_w], axis=-1
    ) / jnp.maximum(4.0 * qw_w, 1e-12)[..., None]

    qx_x = _sel_sqrt(1.0 + m00 - m11 - m22, sel_x) / 2.0
    q_x = jnp.stack(
        [4.0 * qx_x * qx_x, m01 + m10, m02 + m20, m21 - m12], axis=-1
    ) / jnp.maximum(4.0 * qx_x, 1e-12)[..., None]

    qy_y = _sel_sqrt(1.0 - m00 + m11 - m22, sel_y) / 2.0
    q_y = jnp.stack(
        [m01 + m10, 4.0 * qy_y * qy_y, m12 + m21, m02 - m20], axis=-1
    ) / jnp.maximum(4.0 * qy_y, 1e-12)[..., None]

    qz_z = _sel_sqrt(1.0 - m00 - m11 + m22, sel_z) / 2.0
    q_z = jnp.stack(
        [m02 + m20, m12 + m21, 4.0 * qz_z * qz_z, m10 - m01], axis=-1
    ) / jnp.maximum(4.0 * qz_z, 1e-12)[..., None]
    q = jnp.where(
        cond_w[..., None],
        q_w,
        jnp.where(cond_x[..., None], q_x, jnp.where(cond_y[..., None], q_y, q_z)),
    )
    return quat_positive(quat_normalize(q))


def quat_to_compact(q):
    """(x,y,z,w) -> (x,y,z) of the w>0-normalized quaternion
    (reference ``toCompactQuaternion``)."""
    return quat_positive(quat_normalize(q))[..., :3]


def quat_from_compact(v):
    """(x,y,z) -> full quaternion with w = sqrt(1 - |v|^2); identity when
    |v|^2 > 1 (reference ``fromCompactQuaternion``)."""
    n2 = jnp.sum(v * v, axis=-1, keepdims=True)
    bad = n2 > 1.0
    # reverse-mode-safe sqrt argument (see quat_from_matrix)
    w = jnp.sqrt(jnp.where(bad, 1.0, jnp.maximum(1.0 - n2, 1e-24)))
    q = jnp.concatenate([v, w], axis=-1)
    ident = jnp.zeros_like(q).at[..., 3].set(1.0)
    return jnp.where(bad, ident, q)


def so3_exp(omega):
    """Axis-angle (..., 3) -> quaternion (x, y, z, w).

    Taylor-safe at 0 *including derivatives*: sqrt(theta2) has an infinite
    tangent at theta2 = 0, so the argument of every transcendental is the
    where-guarded theta (autodiff of the framework's linearization evaluates
    exactly at zero perturbation)."""
    theta2 = jnp.sum(omega * omega, axis=-1, keepdims=True)
    small = theta2 < 1e-12
    theta = jnp.sqrt(jnp.where(small, 1.0, theta2))
    half = 0.5 * theta
    # sin(t/2)/t with series fallback
    k = jnp.where(small, 0.5 - theta2 / 48.0, jnp.sin(half) / theta)
    w = jnp.where(small, 1.0 - theta2 / 8.0, jnp.cos(half))
    return jnp.concatenate([omega * k, w], axis=-1)


def so3_log(q):
    """Quaternion -> axis-angle (..., 3). Taylor-safe at identity
    *including reverse-mode derivatives*: the VJP of ``norm`` at 0 is
    0/0 even under a zero cotangent (0·NaN), so the sqrt argument is
    where-guarded (double-where trick; forward mode alone survives a
    single where because JVPs select tangents, VJPs sum them)."""
    q = quat_positive(quat_normalize(q))
    vec = q[..., :3]
    w = q[..., 3:4]
    n2 = jnp.sum(vec * vec, axis=-1, keepdims=True)
    small = n2 < 1e-18
    n = jnp.sqrt(jnp.where(small, 1.0, n2))
    angle = 2.0 * jnp.arctan2(jnp.where(small, 0.0, n), w)
    k = jnp.where(small, 2.0 / jnp.maximum(w, 1e-12), angle / n)
    return vec * k


def so3_hat(omega):
    """(..., 3) -> skew-symmetric (..., 3, 3)."""
    o = jnp.zeros(omega.shape[:-1] + (3, 3), dtype=omega.dtype)
    x, y, z = omega[..., 0], omega[..., 1], omega[..., 2]
    o = o.at[..., 0, 1].set(-z).at[..., 0, 2].set(y)
    o = o.at[..., 1, 0].set(z).at[..., 1, 2].set(-x)
    o = o.at[..., 2, 0].set(-y).at[..., 2, 1].set(x)
    return o


# --------------------------------------------------------------------------- #
# SE(3) — state vector (tx, ty, tz, qx, qy, qz, qw)
# --------------------------------------------------------------------------- #

def se3_identity(shape=(), dtype=jnp.float64):
    x = jnp.zeros(shape + (7,), dtype=dtype)
    return x.at[..., 6].set(1.0)


def se3_t(x):
    return x[..., :3]


def se3_q(x):
    return x[..., 3:7]


def se3_make(t, q):
    return jnp.concatenate([t, q], axis=-1)


def se3_compose(a, b):
    """a * b."""
    return se3_make(
        se3_t(a) + quat_rotate(se3_q(a), se3_t(b)),
        quat_mul(se3_q(a), se3_q(b)),
    )


def se3_inverse(a):
    qi = quat_conj(se3_q(a))
    return se3_make(-quat_rotate(qi, se3_t(a)), qi)


def se3_act(a, p):
    return se3_t(a) + quat_rotate(se3_q(a), p)


def se3_normalize(x):
    return se3_make(se3_t(x), quat_normalize(se3_q(x)))


def se3_to_mqt(x):
    """SE3 -> 6-vector [t, compact-quat] (reference ``toVectorMQT``)."""
    return jnp.concatenate([se3_t(x), quat_to_compact(se3_q(x))], axis=-1)


def se3_from_mqt(v):
    """6-vector [t, compact-quat] -> SE3 (reference ``fromVectorMQT``)."""
    return se3_make(v[..., :3], quat_from_compact(v[..., 3:6]))


def se3_oplus(x, delta):
    """Reference VertexSE3 update: X <- X * fromVectorMQT(delta)
    (``g2o/types/slam3d/vertex_se3.h:105-114``), with quaternion
    renormalisation standing in for the periodic re-orthogonalisation."""
    return se3_normalize(se3_compose(x, se3_from_mqt(delta)))


# --- SE3Quat exp/log (used by the *Expmap vertex types, sba) --------------- #

def _so3_left_jacobian(omega):
    """V matrix of the SE3 exponential: V = I + B*hat + C*hat^2."""
    theta2 = jnp.sum(omega * omega, axis=-1)
    small = theta2 < 1e-10
    # reverse-mode-safe: sqrt's VJP at 0 is inf; guard its ARGUMENT so the
    # discarded branch stays finite (0-cotangent × inf = NaN otherwise)
    safe = jnp.sqrt(jnp.where(small, 1.0, theta2))
    B = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(safe)) / (safe * safe))
    C = jnp.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (safe - jnp.sin(safe)) / (safe ** 3)
    )
    O = so3_hat(omega)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=omega.dtype), O.shape)
    return eye + B[..., None, None] * O + C[..., None, None] * (O @ O)


def _so3_left_jacobian_inv(omega):
    theta2 = jnp.sum(omega * omega, axis=-1)
    small = theta2 < 1e-10
    safe = jnp.sqrt(jnp.where(small, 1.0, theta2))   # reverse-mode-safe
    half = 0.5 * safe
    cot = half * jnp.cos(half) / jnp.sin(jnp.where(small, 1.0, half))
    A = jnp.where(small, 1.0 / 12.0 + theta2 / 720.0, (1.0 - cot) / (safe * safe))
    O = so3_hat(omega)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=omega.dtype), O.shape)
    return eye - 0.5 * O + A[..., None, None] * (O @ O)


def se3quat_exp(xi):
    """SE3Quat::exp — xi = [omega(3), upsilon(3)] -> SE3 state vector.

    Matches the reference ordering (rotation first) in
    ``g2o/types/slam3d/se3quat.h`` (exp/log at :173,:218)."""
    omega, upsilon = xi[..., :3], xi[..., 3:6]
    q = so3_exp(omega)
    V = _so3_left_jacobian(omega)
    t = jnp.einsum("...ij,...j->...i", V, upsilon)
    return se3_make(t, q)


def se3quat_log(x):
    """Inverse of :func:`se3quat_exp` -> [omega, upsilon]."""
    omega = so3_log(se3_q(x))
    Vinv = _so3_left_jacobian_inv(omega)
    upsilon = jnp.einsum("...ij,...j->...i", Vinv, se3_t(x))
    return jnp.concatenate([omega, upsilon], axis=-1)


# --------------------------------------------------------------------------- #
# Sim(3) — state vector (tx, ty, tz, qx, qy, qz, qw, s)
# --------------------------------------------------------------------------- #

def sim3_identity(shape=(), dtype=jnp.float64):
    x = jnp.zeros(shape + (8,), dtype=dtype)
    return x.at[..., 6].set(1.0).at[..., 7].set(1.0)


def sim3_t(x):
    return x[..., :3]


def sim3_q(x):
    return x[..., 3:7]


def sim3_s(x):
    return x[..., 7]


def sim3_make(t, q, s):
    return jnp.concatenate([t, q, s[..., None]], axis=-1)


def sim3_compose(a, b):
    """a * b: (R_a s_a, t_a) ∘ (R_b s_b, t_b)."""
    s = sim3_s(a) * sim3_s(b)
    q = quat_mul(sim3_q(a), sim3_q(b))
    t = sim3_s(a)[..., None] * quat_rotate(sim3_q(a), sim3_t(b)) + sim3_t(a)
    return sim3_make(t, q, s)


def sim3_inverse(a):
    qi = quat_conj(sim3_q(a))
    si = 1.0 / sim3_s(a)
    t = -si[..., None] * quat_rotate(qi, sim3_t(a))
    return sim3_make(t, qi, si)


def sim3_act(a, p):
    return sim3_s(a)[..., None] * quat_rotate(sim3_q(a), p) + sim3_t(a)


def _sim3_W(omega, sigma, s, dtype):
    """W = integral_0^1 e^{u sigma} R(u theta) du  (the Sim3 translation
    mixing matrix, reference ``g2o/types/sim3/sim3.h:75-160``), as
    A*I + B*hat + C*hat^2 with hat = hat(omega) UNNORMALIZED.  Exact:

        A = (e^s - 1)/s
        B = (e^s(s sin t - t cos t) + t) / (t (s^2 + t^2))
        C = (A - (e^s(s cos t + t sin t) - s)/(s^2 + t^2)) / t^2

    with limits B -> (e^s(s-1)+1)/s^2, C -> (e^s(s^2/2-s+1)-1)/s^3 as
    theta -> 0 and B -> 1/2, C -> 1/6 as both -> 0.  (An earlier version
    scaled the theta->0 limits by 0.5 and 2/3 and zeroed the both-small
    limits — verified wrong against numerical integration AND the
    reference closed form; the bug halved/zeroed the rotation-translation
    Jacobian coupling of sim3 edges near convergence.)  All small-value
    guards are double-where (VJP-safe)."""
    theta2 = jnp.sum(omega * omega, axis=-1)
    O = so3_hat(omega)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=dtype), O.shape)

    eps = 1e-7
    sigma_small = jnp.abs(sigma) < eps
    theta_small = theta2 < eps * eps
    safe_sigma = jnp.where(sigma_small, 1.0, sigma)
    # reverse-mode-safe sqrt (see _so3_left_jacobian)
    safe_theta = jnp.sqrt(jnp.where(theta_small, 1.0, theta2))

    # case 1: sigma ~ 0, theta ~ 0 — Taylor limits of the integral.  The
    # sigma-LINEAR terms are kept so the in-branch derivative d/dsigma is
    # exact to first order (A = 1 + s/2, B = 1/2 + s/3, C = 1/6 + s/8):
    # a constant-only branch zeroes dt/dsigma — the scale-translation
    # Jacobian coupling — precisely near convergence.  (theta-quadratic
    # terms are omitted: their omega-derivatives carry a factor omega and
    # vanish in-branch.)
    A1 = 1.0 + 0.5 * sigma
    B1 = 0.5 + sigma / 3.0
    C1 = 1.0 / 6.0 + sigma / 8.0
    # case 2: sigma ~ 0, theta != 0  (reduces to the SE3 V-matrix at
    # sigma = 0; sigma-linear terms for the same derivative reason)
    st_, ct_ = jnp.sin(safe_theta), jnp.cos(safe_theta)
    A2 = 1.0 + 0.5 * sigma
    B2 = (1.0 - ct_) / (safe_theta * safe_theta) \
        + sigma * (st_ - safe_theta * ct_) / (safe_theta ** 3)
    C2 = (safe_theta - st_) / (safe_theta ** 3) \
        + sigma * (0.5 - (safe_theta * st_ + ct_ - 1.0)
                   / (safe_theta * safe_theta)) / (safe_theta * safe_theta)
    # case 3: sigma != 0, theta ~ 0
    A3 = (s - 1.0) / safe_sigma
    B3 = (s * (safe_sigma - 1.0) + 1.0) / (safe_sigma * safe_sigma)
    C3 = (s * (0.5 * safe_sigma * safe_sigma - safe_sigma + 1.0)
          - 1.0) / (safe_sigma ** 3)
    # case 4: general
    a_ = s * jnp.sin(safe_theta)
    b_ = s * jnp.cos(safe_theta)
    c_ = safe_theta * safe_theta + safe_sigma * safe_sigma
    A4 = (s - 1.0) / safe_sigma
    B4 = (a_ * safe_sigma + (1.0 - b_) * safe_theta) / (safe_theta * c_)
    C4 = (A4 - ((b_ - 1.0) * safe_sigma + a_ * safe_theta) / c_) / (
        safe_theta * safe_theta
    )

    def pick(x1, x2, x3, x4):
        return jnp.where(
            sigma_small,
            jnp.where(theta_small, x1, x2),
            jnp.where(theta_small, x3, x4),
        )

    A = pick(A1, A2, A3, A4)
    B = pick(B1, B2, B3, B4)
    C = pick(C1, C2, C3, C4)
    return (A[..., None, None] * eye + B[..., None, None] * O
            + C[..., None, None] * (O @ O))


def _inv3(M):
    """Closed-form general 3x3 inverse (adjugate/determinant) — no LU:
    runs inside vmapped+autodiffed edge residuals where XLA's batched
    LuDecomposition is a compile hazard on accelerators."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A_ = e * i - f * h
    B_ = -(d * i - f * g)
    C_ = d * h - e * g
    det = a * A_ + b * B_ + c * C_
    adj = jnp.stack([
        jnp.stack([A_, -(b * i - c * h), b * f - c * e], axis=-1),
        jnp.stack([B_, a * i - c * g, -(a * f - c * d)], axis=-1),
        jnp.stack([C_, -(a * h - b * g), a * e - b * d], axis=-1),
    ], axis=-2)
    return adj / det[..., None, None]


def sim3_exp(xi):
    """Sim3 exponential, xi = [omega(3), upsilon(3), sigma] -> state vector.

    Matches the reference constructor ``Sim3(const Vector7&)`` ordering
    (``g2o/types/sim3/sim3.h:75-160``: rotation, translation, log-scale)."""
    omega, upsilon, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = jnp.exp(sigma)
    q = so3_exp(omega)
    W = _sim3_W(omega, sigma, s, xi.dtype)
    t = jnp.einsum("...ij,...j->...i", W, upsilon)
    return sim3_make(t, q, s)


def sim3_log(x):
    """Inverse of :func:`sim3_exp` (same W, closed-form 3x3 inverse)."""
    omega = so3_log(sim3_q(x))
    sigma = jnp.log(sim3_s(x))
    s = sim3_s(x)
    W = _sim3_W(omega, sigma, s, x.dtype)
    upsilon = jnp.einsum("...ij,...j->...i", _inv3(W), sim3_t(x))
    return jnp.concatenate([omega, upsilon, sigma[..., None]], axis=-1)
