"""Square-root CGLS solver — the fork's flagship capability.

Array-program reformulation of the fork's ``JacobiSolver`` +
``LinearSolverPCGEigen`` pair (``g2o/core/jacobi_solver.hpp:480-697``,
``g2o/solvers/eigen/linear_solver_pcg_eigen.h:33-502``): instead of
assembling the Hessian, iterate directly on the damped least-squares system

    min_x || [sqrt(W) J; sqrt(lambda) I] x  -  [sqrt(W) e; 0] ||^2

with W = rho' * Omega.  Where the fork materialises sqrt(W)J as an Eigen
triplet matrix with cached lambda-row pointers (``jacobi_solver.hpp:601-687``),
here the whitened Jacobian exists only as the cached per-edge blocks: J p and
J^T r are batched einsums + segment-sum scatters (matmul and elementwise work), and the
damping rows are the closed-form terms sqrt(lambda) p / -lambda x.

The fork's per-camera/per-point thin-QR preconditioners Rc^-1 / Rp^-1
(``linear_solver_pcg_eigen.h:371,462-502``) are algebraically the Cholesky
factors of the damped diagonal blocks H_ii + lambda I; we apply the same
block preconditioner M^-1 = (H_ii + lambda I)^-1 via one vmapped inverse per
vertex type.  Termination is the fork's eta-forcing bound
``|s|^2 <= eta * |s_0|^2`` (``linear_solver_pcg_eigen.h:184-188``) plus an
iteration cap.  The square-root form avoids squaring the condition number in
the recurrences — the reason the fork built it for large BA.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from g2o_tpu.ops.smallblocks import chol_small, inv_small


class CGLSSolver:
    name = "cgls"

    def __init__(self, max_iter: int = 200, eta: float = 1e-4,
                 onehot_max_segments: int = 8192,
                 matvec_precision: str = "default"):
        self.max_iter = int(max_iter)
        # fork bound |s|^2 <= eta*|s_0|^2 (linear_solver_pcg_eigen.h:184);
        # the previous implementation applied eta^2 — default moved from
        # 1e-2 to 1e-4 so existing solve depth is preserved while eta now
        # means what the fork's eta means
        self.eta = float(eta)
        if matvec_precision not in ("default", "highest"):
            raise ValueError(f"unknown matvec_precision {matvec_precision!r}")
        # "highest" = exact-f32 J/J^T/whitening einsums — TF32 matvec
        # noise stalls CG at the cap once LM converges
        self.matvec_precision = matvec_precision
        self.onehot_max_segments = int(onehot_max_segments)
        self._solve_fn = None
        self._solve_jit = None
        self.aux = ()  # no solver-owned arrays

    def setup(self, problem):
        max_iter, eta = self.max_iter, self.eta
        p = problem
        onehot_max = self.onehot_max_segments

        def slab_iter(spec, *arrays):
            """Yield per-bucket (d, n) reshaped views of slab-ordered
            arrays (compile-time bucketed batches, DEGREE-MAJOR slabs —
            see ``Problem.bucket_specs`` / ``ops.bucketed.BucketPlan``)."""
            off = 0
            for n, d in zip(spec.counts, spec.degrees):
                yield n, d, tuple(
                    a[off:off + n * d].reshape((d, n) + a.shape[1:])
                    for a in arrays)
                off += n * d

        prec = (jax.lax.Precision.HIGHEST
                if self.matvec_precision == "highest" else None)

        def whiten(lin):
            """Per-edge-type lower-Cholesky of W (sqrt of the robustified
            information); W may be rank-deficient for inactive edges OR
            for individual disabled residual components (info rows of
            zeros are legal .g2o) -> jitter each zero DIAGONAL ENTRY, not
            only fully-zero rows, so chol_small never hits sqrt(<0)."""
            Ls = {}
            for name in p.edge_types:
                W = p.edge_weights(lin, name)
                r = W.shape[-1]
                eye = jnp.eye(r, dtype=p.dtype)
                dg = jnp.abs(jnp.diagonal(W, axis1=-2, axis2=-1))  # (E, r)
                jitter = jnp.where(dg < 1e-30,
                                   jnp.asarray(1e-30, p.dtype), 0.0)
                Wsafe = W + eye * jitter[:, :, None]
                Ls[name] = chol_small(Wsafe)
            return Ls

        def Jmat(data, lin, Ls, vb):
            """u = sqrt(W) J v (block-layout v), per edge type -> (E, r).

            Edge types stored in the compile-time bucketed layout
            (``p.bucket_specs``) avoid the row-serialized landmark gather:
            the per-landmark value broadcasts over the slab's degree axis
            inside a dense einsum; the camera gather becomes an exact
            one-hot matmul."""
            out = {}
            for name, et in p.edge_types.items():
                batch = data.edges[name]
                Js = p.edge_jacs(lin, name)
                spec = p.bucket_specs.get(name)
                y = None
                for s, vt in enumerate(et.vertex_types):
                    t = vt.name
                    if spec is not None and s == spec.lm_slot:
                        if spec.seg_identity:
                            v_used = vb[t][:sum(spec.counts)]
                        else:
                            v_used = vb[t][data.plans[name]["segp"]]
                        chunks, k = [], 0
                        for n, d, (Jb,) in slab_iter(spec, Js[s]):
                            chunks.append(jnp.einsum(
                                "dnri,ni->dnr", Jb, v_used[k:k + n],
                                precision=prec).reshape(n * d, -1))
                            k += n
                        ys = jnp.concatenate(chunks, axis=0)
                        E = Js[s].shape[0]
                        if E > spec.n_rows:   # pad-to-multiple tail: J == 0
                            ys = jnp.concatenate(
                                [ys, jnp.zeros((E - spec.n_rows,)
                                               + ys.shape[1:], ys.dtype)])
                    elif (spec is not None
                          and p.counts[t] <= onehot_max):
                        from g2o_tpu.ops.onehot import onehot_gather

                        rows = onehot_gather(batch.vidx[:, s], vb[t])
                        ys = jnp.einsum("erd,ed->er", Js[s], rows,
                                        precision=prec)
                    else:
                        rows = vb[t][batch.vidx[:, s]]      # row gather
                        ys = jnp.einsum("erd,ed->er", Js[s], rows,
                                        precision=prec)
                    y = ys if y is None else y + ys
                out[name] = jnp.einsum("esr,es->er", Ls[name], y,
                                       precision=prec)       # L^T y
            return out

        def Jt(data, lin, Ls, u):
            """v = J^T sqrt(W)^T u -> block layout (bucketed edge types use
            dense slab reductions / one-hot scatters, see Jmat)."""
            out = {t: jnp.zeros((p.counts[t], vt.tangent_dim), dtype=p.dtype)
                   for t, vt in p.vertex_types.items()}
            for name, et in p.edge_types.items():
                batch = data.edges[name]
                Js = p.edge_jacs(lin, name)
                spec = p.bucket_specs.get(name)
                # adjoint of Jmat's u = L^T(Jv): z = L u (the previous
                # "ers,er->es" applied L^T again — wrong step for any
                # NON-DIAGONAL information matrix; <Jmat v, u> == <v, Jt u>
                # restored, regression-tested with correlated info)
                z = jnp.einsum("esr,er->es", Ls[name], u[name],
                               precision=prec)
                for s, vt in enumerate(et.vertex_types):
                    t = vt.name
                    if spec is not None and s == spec.lm_slot:
                        nb = spec.n_rows
                        chunks = []
                        for n, d, (Jb, zb) in slab_iter(spec, Js[s][:nb],
                                                        z[:nb]):
                            chunks.append(jnp.einsum("dnri,dnr->ni", Jb,
                                                     zb, precision=prec))
                        part = jnp.concatenate(chunks, axis=0)
                        if spec.seg_identity:
                            out[t] = out[t].at[:part.shape[0]].add(part)
                        else:
                            out[t] = out[t].at[
                                data.plans[name]["segp"]].add(
                                part, unique_indices=True)
                    elif (spec is not None
                          and p.counts[t] <= onehot_max):
                        from g2o_tpu.ops.onehot import onehot_scatter_add

                        out[t] = out[t] + onehot_scatter_add(
                            batch.vidx[:, s],
                            jnp.einsum("erd,er->ed", Js[s], z,
                                       precision=prec),
                            p.counts[t])
                    else:
                        out[t] = out[t].at[batch.vidx[:, s]].add(
                            jnp.einsum("erd,er->ed", Js[s], z,
                                       precision=prec))
            return out

        def build_precond(data, lin, lam):
            minv = {}
            for t, vt in p.vertex_types.items():
                d = vt.tangent_dim
                eye = jnp.eye(d, dtype=p.dtype)
                blocks = lin.diag[t] + lam * eye
                fx = data.fixed[t].astype(p.dtype)[:, None, None]
                blocks = blocks * (1.0 - fx) + eye * fx
                minv[t] = inv_small(blocks)
            return minv

        def apply_precond(data, minv, rb):
            return {t: jnp.einsum("nij,nj->ni", minv[t], rb[t])
                    for t in p.vertex_types}

        def dot_edges(a, b):
            # multiply+sum: exact f32 (a DEFAULT-precision dot may run in
            # TF32 on the GPU)
            return sum(jnp.sum(a[k] * b[k]) for k in a)

        tdot = p.tree_dot
        tmap = jax.tree_util.tree_map

        def solve(data, lin, lam, aux=()):
            Ls = whiten(lin)
            minv = build_precond(data, lin, lam)

            # b = J^T W e is exactly lin.b; whitened data residual:
            # r0 = sqrt(W) e with the sign of the descent direction
            # s0 = J^T sqrt(W)^T (sqrt(W) e) = lin.b
            s = p.split_tangent(lin.b)
            x = tmap(jnp.zeros_like, s)
            z = apply_precond(data, minv, s)
            gamma0 = tdot(s, z)
            pvec = z
            # r in data space (per edge type); damping-row residual = -sqrt(l)x
            r = {name: jnp.einsum("esr,es->er", Ls[name],
                                  p.edge_errors(lin, name),
                                  precision=prec)
                 for name in p.edge_types}
            # sign: b = -J^T W e, so whiten -e
            r = {k: -v for k, v in r.items()}

            thresh = eta * gamma0

            def cond(carry):
                it, gamma = carry[0], carry[1]
                return jnp.logical_and(it < max_iter, gamma > thresh)

            def body(carry):
                it, gamma, x, r, pvec = carry
                q = Jmat(data, lin, Ls, pvec)
                denom = dot_edges(q, q) + lam * tdot(pvec, pvec)
                alpha = gamma / jnp.maximum(denom, 1e-300)
                x = tmap(lambda a, b_: a + alpha * b_, x, pvec)
                r = {k: r[k] - alpha * q[k] for k in r}
                jt = Jt(data, lin, Ls, r)
                s = tmap(lambda a, b_: a - lam * b_, jt, x)
                z = apply_precond(data, minv, s)
                gamma_new = tdot(s, z)
                beta = gamma_new / jnp.maximum(gamma, 1e-300)
                pvec = tmap(lambda a, b_: a + beta * b_, z, pvec)
                return (it + 1, gamma_new, x, r, pvec)

            carry = (jnp.asarray(0, jnp.int32), gamma0, x, r, pvec)
            _, _, x, _, _ = jax.lax.while_loop(cond, body, carry)
            return p.join_tangent(x)

        self._solve_fn = solve
        self._solve_jit = jax.jit(solve)
        return self

    def solve(self, data, lin, lam=0.0):
        return self._solve_jit(data, lin, lam, self.aux)
