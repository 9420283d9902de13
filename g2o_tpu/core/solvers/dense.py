"""Dense Cholesky linear solver — analogue of the reference
``LinearSolverDense`` (``g2o/solvers/dense/linear_solver_dense.h:46``).

Scatter-assembles the tangent-space Hessian to a dense (T, T) matrix and
factorizes with XLA's Cholesky (cuSOLVER on the GPU); this is the
preferred backend whenever the reduced system fits in device memory (e.g.
pose graphs up to a few thousand poses, and the reduced camera system
after Schur complement)."""

from __future__ import annotations

import jax
import jax.numpy as jnp


class DenseSolver:
    name = "dense"

    def __init__(self):
        self._solve_jit = None
        self.aux = ()  # no solver-owned arrays

    def setup(self, problem):
        def solve(data, lin, lam, aux=()):
            H = problem.dense_hessian_fn(data, lin)
            T = H.shape[0]
            # LM damping: H + lambda I on the diagonal (reference
            # ``BlockSolver::setLambda``, ``g2o/core/block_solver.hpp:525``)
            Hl = H + lam * jnp.eye(T, dtype=H.dtype)
            L, lower = jax.scipy.linalg.cho_factor(Hl, lower=True)
            dx = jax.scipy.linalg.cho_solve((L, lower), lin.b)
            return dx

        self._solve_fn = solve          # unjitted, for fusion into one step
        self._solve_jit = jax.jit(solve)
        return self

    def solve(self, data, lin, lam=0.0):
        return self._solve_jit(data, lin, lam, self.aux)
