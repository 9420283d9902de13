"""Closed-form batched operations on tiny SPD blocks.

XLA's `cholesky` on (N, r, r) batches lowers through the general blocked
algorithm, which compiles (and on some backends runs) poorly for r <= 3 —
the dominant case here (1-3 dof residuals/landmarks).  These closed forms
are straight-line VPU code."""

from __future__ import annotations

import jax.numpy as jnp


def chol_small(A):
    """Lower Cholesky factor of SPD blocks (..., r, r), closed-form for
    r in {1, 2, 3}, general fallback otherwise."""
    r = A.shape[-1]
    if r == 1:
        return jnp.sqrt(A)
    if r == 2:
        a = jnp.sqrt(A[..., 0, 0])
        b = A[..., 1, 0] / a
        c = jnp.sqrt(A[..., 1, 1] - b * b)
        z = jnp.zeros_like(a)
        return jnp.stack([
            jnp.stack([a, z], axis=-1),
            jnp.stack([b, c], axis=-1),
        ], axis=-2)
    if r == 3:
        l11 = jnp.sqrt(A[..., 0, 0])
        l21 = A[..., 1, 0] / l11
        l31 = A[..., 2, 0] / l11
        l22 = jnp.sqrt(A[..., 1, 1] - l21 * l21)
        l32 = (A[..., 2, 1] - l31 * l21) / l22
        l33 = jnp.sqrt(A[..., 2, 2] - l31 * l31 - l32 * l32)
        z = jnp.zeros_like(l11)
        return jnp.stack([
            jnp.stack([l11, z, z], axis=-1),
            jnp.stack([l21, l22, z], axis=-1),
            jnp.stack([l31, l32, l33], axis=-1),
        ], axis=-2)
    return jnp.linalg.cholesky(A)


def inv_small(A):
    """Inverse of SPD blocks (..., r, r), closed-form for r in {1, 2, 3},
    Cholesky-based for larger r (callers pass damped Hessian diagonals —
    always SPD, so Cholesky is the right factorization and avoids a
    batched LU)."""
    r = A.shape[-1]
    if r == 1:
        return 1.0 / A
    if r == 2:
        a, b = A[..., 0, 0], A[..., 0, 1]
        c, d = A[..., 1, 0], A[..., 1, 1]
        det = a * d - b * c
        inv_det = 1.0 / det
        return jnp.stack([
            jnp.stack([d, -b], axis=-1),
            jnp.stack([-c, a], axis=-1),
        ], axis=-2) * inv_det[..., None, None]
    if r == 3:
        a = A
        c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
        c01 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
        c02 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
        det = (a[..., 0, 0] * c00 + a[..., 0, 1] * c01 + a[..., 0, 2] * c02)
        inv_det = 1.0 / det
        c10 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
        c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
        c12 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]
        c20 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
        c21 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
        c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
        M = jnp.stack([
            jnp.stack([c00, c10, c20], axis=-1),
            jnp.stack([c01, c11, c21], axis=-1),
            jnp.stack([c02, c12, c22], axis=-1),
        ], axis=-2)
        return M * inv_det[..., None, None]
    import jax.scipy.linalg as jsl

    L = jnp.linalg.cholesky(A)
    eye = jnp.broadcast_to(jnp.eye(A.shape[-1], dtype=A.dtype), A.shape)
    return jsl.cho_solve((L, True), eye)


def inv_small_t(At):
    """DIMS-MAJOR twin of :func:`inv_small`: blocks ``(r, r, ...)`` with
    the batch axes LAST (edge/segment axis on vector lanes) — consumers
    that keep dims-major layouts avoid the ``(N, r, r) <-> (r, r, N)``
    relayout copies entirely.  Bit-identical to ``inv_small`` on
    symmetric blocks (the adjugate formulas commute)."""
    r = At.shape[0]
    if r == 1:
        return 1.0 / At
    if r == 2:
        a, b = At[0, 0], At[0, 1]
        c, d = At[1, 0], At[1, 1]
        inv_det = 1.0 / (a * d - b * c)
        return jnp.stack([
            jnp.stack([d, -b]),
            jnp.stack([-c, a]),
        ]) * inv_det
    if r == 3:
        a = At
        c00 = a[1, 1] * a[2, 2] - a[1, 2] * a[2, 1]
        c01 = a[1, 2] * a[2, 0] - a[1, 0] * a[2, 2]
        c02 = a[1, 0] * a[2, 1] - a[1, 1] * a[2, 0]
        det = a[0, 0] * c00 + a[0, 1] * c01 + a[0, 2] * c02
        inv_det = 1.0 / det
        c10 = a[0, 2] * a[2, 1] - a[0, 1] * a[2, 2]
        c11 = a[0, 0] * a[2, 2] - a[0, 2] * a[2, 0]
        c12 = a[0, 1] * a[2, 0] - a[0, 0] * a[2, 1]
        c20 = a[0, 1] * a[1, 2] - a[0, 2] * a[1, 1]
        c21 = a[0, 2] * a[1, 0] - a[0, 0] * a[1, 2]
        c22 = a[0, 0] * a[1, 1] - a[0, 1] * a[1, 0]
        M = jnp.stack([
            jnp.stack([c00, c10, c20]),
            jnp.stack([c01, c11, c21]),
            jnp.stack([c02, c12, c22]),
        ])
        return M * inv_det
    return jnp.moveaxis(
        inv_small(jnp.moveaxis(At, (0, 1), (-2, -1))),
        (-2, -1), (0, 1))
