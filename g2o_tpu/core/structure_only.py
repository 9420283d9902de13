"""Structure-only BA refinement — analogue of the reference
``StructureOnlySolver`` (``g2o/solvers/structure_only/structure_only_solver.h:57``):
optimize landmark positions with all poses frozen.

The reference loops over landmarks, running an independent little LM with
``solveDirect`` per point.  Array-program formulation: ALL landmarks run their
LM *simultaneously* — per-landmark Hessian blocks and gradients come from
one segment-sum, the (H_jj + lambda_j I)^-1 solves are one vmapped Cholesky,
and each landmark carries its own (lambda_j, nu_j) trust-region state with
per-landmark accept/reject masks.  The whole refinement is a single jitted
``lax.fori_loop``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from g2o_tpu.ops import robust as robust_mod


def structure_only_refine(problem, n_iters: int = 10, *,
                          initial_lambda: float = 1e-4):
    """Refine marginalized landmarks in place; returns
    ``{type: (chi2_before (N,), chi2_after (N,))}`` per landmark type."""
    p = problem
    lm_types = [t for t, m in p.marginalized.items() if m.all()]
    if not lm_types:
        raise ValueError("structure_only: no marginalized landmark vertices")

    # observation edge types touching each landmark type
    obs_by_type = {t: [] for t in lm_types}
    for name, et in p.edge_types.items():
        for s, vt in enumerate(et.vertex_types):
            if vt.name in obs_by_type:
                obs_by_type[vt.name].append((name, s))

    def per_landmark_quantities(data, estimates, t, d):
        """(H (N,d,d), b (N,d), chi2 (N,)) for landmark type t."""
        N = p.counts[t]
        H = jnp.zeros((N, d, d), dtype=p.dtype)
        b = jnp.zeros((N, d), dtype=p.dtype)
        chi = jnp.zeros((N,), dtype=p.dtype)
        for name, s in obs_by_type[t]:
            et = p.edge_types[name]
            batch = data.edges[name]
            states, e = p._edge_residuals(et, batch, estimates)
            e2 = jnp.einsum("er,ers,es->e", e, batch.info, e)
            rho = p._robustify(name, batch, e2)
            act = batch.active.astype(p.dtype)
            W = batch.info * (rho[:, 1] * act)[:, None, None]
            J = jax.vmap(p._edge_jac_fns[name])(states, batch.meas,
                                                batch.param)
            if not isinstance(J, (tuple, list)):
                J = (J,)
            Jl = J[s]
            idx = batch.vidx[:, s]
            H = H.at[idx].add(jnp.einsum("erd,ers,esf->edf", Jl, W, Jl))
            b = b.at[idx].add(-jnp.einsum("erd,ers,es->ed", Jl, W, e))
            chi = chi.at[idx].add(rho[:, 0] * act)
        return H, b, chi

    results = {}
    for t in lm_types:
        vt = p.vertex_types[t]
        d = vt.tangent_dim
        eye = jnp.eye(d, dtype=p.dtype)
        fixed = p.data.fixed[t].astype(p.dtype)[:, None]

        def one_round(carry, t=t, d=d, eye=eye, fixed=fixed, vt=vt):
            estimates, lam, ni = carry
            H, b, chi0 = per_landmark_quantities(p.data, estimates, t, d)
            Hl = H + lam[:, None, None] * eye
            fx3 = fixed[:, :, None]
            Hl = Hl * (1.0 - fx3) + eye * fx3
            dx = jnp.linalg.solve(Hl, b[..., None])[..., 0]
            dx = dx * (1.0 - fixed)
            cand_t = jax.vmap(vt.oplus)(estimates[t], dx)
            cand = dict(estimates)
            cand[t] = cand_t
            _, _, chi1 = per_landmark_quantities(p.data, cand, t, d)
            scale = jnp.einsum("nd,nd->n", dx, lam[:, None] * dx + b) + 1e-3
            rho = (chi0 - chi1) / scale
            ok = jnp.logical_and(jnp.isfinite(chi1),
                                 jnp.logical_and(rho > 0, chi1 < chi0))
            factor = jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
            lam = jnp.where(ok, lam * factor.astype(p.dtype), lam * ni)
            ni = jnp.where(ok, 2.0, ni * 2.0).astype(p.dtype)
            new_t = jnp.where(ok[:, None], cand_t, estimates[t])
            new_est = dict(estimates)
            new_est[t] = new_t
            return (new_est, lam, ni)

        @jax.jit
        def run(estimates):
            N = p.counts[t]
            lam0 = jnp.full((N,), initial_lambda, dtype=p.dtype)
            ni0 = jnp.full((N,), 2.0, dtype=p.dtype)
            _, _, chi_before = per_landmark_quantities(p.data, estimates, t,
                                                       vt.tangent_dim)
            carry = (estimates, lam0, ni0)
            carry = jax.lax.fori_loop(0, n_iters,
                                      lambda i, c: one_round(c), carry)
            est_f = carry[0]
            _, _, chi_after = per_landmark_quantities(p.data, est_f, t,
                                                      vt.tangent_dim)
            return est_f, chi_before, chi_after

        est_f, chi_before, chi_after = run(p.estimates)
        p.set_estimates(est_f)
        results[t] = (np.asarray(chi_before), np.asarray(chi_after))
    return results
