"""Marginal covariance recovery — analogue of the reference
``SparseOptimizer::computeMarginals`` (``g2o/core/sparse_optimizer.cpp:594``)
backed by ``MarginalCovarianceCholesky``
(``g2o/core/marginal_covariance_cholesky.h:43``).

Two backends:

* **dense** (small problems): factorise the dense tangent-space Hessian once
  (dense Cholesky) and solve all requested columns in one batched triangular
  solve — the covariance blocks are ``(H^-1)[slots_i, slots_j]``.
* **sparse** (uniform-block pose graphs at scale): reuse the
  :class:`~g2o_tpu.core.solvers.supernodal.SupernodalCholeskySolver`'s
  amalgamated block factor and run its batched-panel triangular solves
  over a batch of unit-block right-hand sides — where the reference walks
  the CSparse/CHOLMOD factor with the Takahashi recursion (``solveBlocks``,
  ``solvers/cholmod/linear_solver_cholmod.h:160-230``), the batched version
  vmaps the substitution over the requested columns.  Memory is
  O(nnz(L) + n·d·k) instead of O(T²).

``method="auto"`` picks sparse when the problem shape admits it and the
dense Hessian would exceed ~32M entries.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _spans_for(problem, vertex_ids):
    """Per requested vertex: (vid, type, local idx, dim, fixed)."""
    fixed = {t: np.asarray(problem.data.fixed[t]) for t in problem.vertex_types}
    spans = []
    for vid in vertex_ids:
        t, i = problem.vid_index[vid]
        d = problem.vertex_types[t].tangent_dim
        spans.append((vid, t, i, d, bool(fixed[t][i])))
    return spans


def _sparse_applicable(problem) -> bool:
    """Binary edges only; mixed vertex types are fine (the direct solver
    pads blocks to the max tangent dim)."""
    return all(et.num_slots <= 2 for et in problem.edge_types.values())


def _uniform_type(problem) -> bool:
    return len(problem.vertex_types) == 1


def _sparse_cov_blocks(problem, locals_, *, lam, estimates):
    """(k, d, d) diagonal covariance blocks via the supernodal factor
    (symbolic setup is ~300x faster than the per-column schedule at
    sphere2500 scale and the triangular sweeps run over ~15 levels of
    batched dense panels instead of ~240 column levels)."""
    from g2o_tpu.core.solvers.supernodal import (SupernodalCholeskySolver,
                                                 solve_supernodal)

    p = problem
    solver = SupernodalCholeskySolver().setup(p)
    (tname,) = p.vertex_types
    d = p.vertex_types[tname].tangent_dim
    n = p.counts[tname]
    perm = np.asarray(solver.aux["perm"])
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    kcols = jnp.asarray(inv[np.asarray(locals_, dtype=np.int64)])

    lin = p.linearize_jit(p.data, estimates)
    aux = solver.aux
    dtype = p.dtype

    @jax.jit
    def run(data, lin, aux, kcols):
        blocks = solver._factor_fn(data, lin, jnp.asarray(lam, dtype), aux)

        def one(kcol):
            rhs = jnp.zeros((n, d, d), dtype=dtype).at[kcol].set(
                jnp.eye(d, dtype=dtype))
            X = jax.vmap(solve_supernodal, in_axes=(None, -1, None, None),
                         out_axes=-1)(blocks, rhs, aux["levels"], d)
            return X[kcol]                       # (d, d) = (H^-1)[v, v]

        return jax.vmap(one)(kcols)

    return np.asarray(run(p.data, lin, aux, kcols))


def _takahashi_cov_blocks(problem, *, lam, estimates):
    """ALL diagonal covariance blocks ``(n, d, d)`` (original vertex
    order) via ONE numeric factorization + ONE reverse level-scheduled
    Takahashi sweep — ``O(Σ_j |struct(j)|²)`` total, vs one
    forward/backward solve pair per requested vertex for the per-column
    path.  The batched formulation of the reference's ``computeCovariance``
    over ``MarginalCovarianceCholesky::computeEntry``
    (``marginal_covariance_cholesky.h:85-96``)."""
    from g2o_tpu.core.solvers.sparse_chol import (
        SparseCholeskySolver,
        build_takahashi_schedule,
        selected_inverse,
    )

    p = problem
    solver = SparseCholeskySolver().setup(p)
    pairs = jnp.asarray(build_takahashi_schedule(solver._sym))
    n = solver._n_blocks
    inv = jnp.asarray(solver._sym["inv"].astype(np.int64))
    lin = p.linearize_jit(p.data, estimates)
    dtype = p.dtype

    @jax.jit
    def run(data, lin, aux, pairs, inv):
        blocks = solver._factor_fn(data, lin, jnp.asarray(lam, dtype), aux)
        Sigma = selected_inverse(blocks, aux, pairs, n)
        return Sigma[:n][inv]     # (n, dmax, dmax), global original order

    cov = np.asarray(run(p.data, lin, solver.aux, pairs, inv))
    return cov, solver._type_base


def _schur_marginals(problem, spans, *, lam, estimates):
    """Diagonal covariance blocks via the reduced camera system — the
    BA-scale path the reference reaches through CHOLMOD ``solveBlocks``
    on the factor (``solvers/cholmod/linear_solver_cholmod.h:160-230``)
    plus the Takahashi recursion
    (``core/marginal_covariance_cholesky.h:92``).

    With ``H = [[A, B], [B^T, D]]`` (poses / marginalized landmarks) and
    Schur complement ``S = A - B D^-1 B^T``:

    * pose blocks:      ``Cov_pp = (S^-1)[p, p]`` — batched triangular
      solves on unit columns of the (already dense, Cholesky-factorized) reduced
      matrix;
    * landmark blocks:  ``Cov_jj = D_j^-1 + Y_j^T S^-1 Y_j`` with
      ``Y_j = (B D^-1)[:, j]`` assembled from the per-observation blocks —
      one scatter + one batched solve for ALL requested landmarks.

    Memory is O(Tp^2 + k·Tp·dl): no T×T dense Hessian is ever formed."""
    from g2o_tpu.core.solvers.schur import SchurSolver

    p = problem
    solver = SchurSolver().setup(p)
    lay = solver._layout
    aux = solver.aux
    marg = lay["marg"]
    Tp, dl = lay["Tp"], lay["dl"]
    dp = lay["dp"]
    dtype = p.dtype

    pose_req, lm_req = [], []     # (span position, reduced coordinate)
    for m, (vid, t, i, d, fx) in enumerate(spans):
        if marg[t]:
            lm_req.append((m, lay["lm_base"][t] + i))
        else:
            pose_req.append((m, lay["pose_base"][t] + i * d, d))

    lin = p.linearize_jit(p.data, estimates)
    kl = len(lm_req)
    lm_idx = jnp.asarray([j for _, j in lm_req], dtype=jnp.int32)
    pose_cols_np = np.concatenate(
        [np.arange(o, o + d) for _, o, d in pose_req]).astype(np.int32) \
        if pose_req else np.zeros(0, np.int32)
    pose_cols = jnp.asarray(pose_cols_np)
    kp = len(pose_cols_np)
    hi = jax.lax.Precision.HIGHEST

    @jax.jit
    def run(data, lin, aux):
        Hschur, _, B, Dinv = solver._reduced_parts_fn(data, lin,
                                                      jnp.asarray(lam, dtype),
                                                      aux)
        L, lower = jax.scipy.linalg.cho_factor(Hschur, lower=True)

        # pose covariances: S^-1 unit columns
        rhs = jnp.zeros((Tp, kp), dtype=dtype)
        rhs = rhs.at[pose_cols, jnp.arange(kp)].set(1.0)
        Xp = jax.scipy.linalg.cho_solve((L, lower), rhs)     # (Tp, kp)
        pose_cov = Xp[pose_cols, :]                          # (kp, kp)

        # landmark covariances: Y_j = scatter of B_e Dinv_j over the
        # observations of each requested landmark
        BD = jnp.einsum("edl,elm->edm", B, Dinv[aux["obs_lm"]],
                        precision=hi)                        # (Eo, dp, dl)
        cam_idx2 = aux["obs_cam"][:, None] + jnp.arange(dp)[None, :]
        # map landmark linear index -> requested slot (kl == dumped)
        slot_of = jnp.full((lay["NL"],), kl, dtype=jnp.int32)
        slot_of = slot_of.at[lm_idx].set(jnp.arange(kl, dtype=jnp.int32))
        s = slot_of[aux["obs_lm"]]                           # (Eo,)
        Y = jnp.zeros((kl + 1, Tp, dl), dtype=dtype)
        Y = Y.at[s[:, None], cam_idx2].add(BD)
        Y = Y[:kl]                                           # (kl, Tp, dl)
        U = jax.scipy.linalg.cho_solve(
            (L, lower),
            Y.transpose(1, 0, 2).reshape(Tp, kl * dl)
        ).reshape(Tp, kl, dl).transpose(1, 0, 2)             # (kl, Tp, dl)
        extra = jnp.einsum("ktd,kte->kde", Y, U, precision=hi)
        lm_cov = Dinv[lm_idx] + extra                        # (kl, dl, dl)
        return pose_cov, lm_cov

    pose_cov, lm_cov = run(p.data, lin, aux)
    pose_cov, lm_cov = np.asarray(pose_cov), np.asarray(lm_cov)

    out = {}
    col = 0
    for (m, o, d) in pose_req:
        vid, _, _, _, is_fixed = spans[m]
        out[vid] = (np.zeros((d, d)) if is_fixed
                    else pose_cov[col:col + d, col:col + d])
        col += d
    for r, (m, _) in enumerate(lm_req):
        vid, _, _, d, is_fixed = spans[m]
        out[vid] = np.zeros((d, d)) if is_fixed else lm_cov[r][:d, :d]
    return out


def _dense_inverse_block(problem, cols, *, lam, estimates):
    """(k, k) block of H^-1 for the given flat column indices."""
    p = problem
    lin = p.linearize_jit(p.data, estimates)
    cols = jnp.asarray(np.asarray(cols, dtype=np.int32))

    @jax.jit
    def solve_columns(data, lin):
        H = p.dense_hessian_fn(data, lin)
        Hl = H + lam * jnp.eye(H.shape[0], dtype=H.dtype)
        L, lower = jax.scipy.linalg.cho_factor(Hl, lower=True)
        rhs = jnp.zeros((H.shape[0], cols.shape[0]), dtype=H.dtype)
        rhs = rhs.at[cols, jnp.arange(cols.shape[0])].set(1.0)
        X = jax.scipy.linalg.cho_solve((L, lower), rhs)
        return X[cols, :]

    return np.asarray(solve_columns(p.data, lin))


def compute_marginals(problem, vertex_ids, *, lam: float = 0.0,
                      estimates=None, method: str = "auto"):
    """Covariance blocks for the given vertex ids.

    Returns ``{vid: (d, d) ndarray}``.  Fixed vertices get zero covariance
    (they are pinned), matching the reference convention that fixed vertices
    are excluded from the system."""
    p = problem
    estimates = estimates if estimates is not None else p.estimates
    spans = _spans_for(p, vertex_ids)

    if method == "auto":
        if any(np.asarray(m).any() for m in p.marginalized.values()):
            # the explicit Schur path handles the standard full-type
            # marginalization pattern; general patterns (partial
            # marginalization, n-ary observation edges) fall back to the
            # dense path rather than crashing on SchurSolver's guard
            partial = any(np.asarray(m).any() and not np.asarray(m).all()
                          for m in p.marginalized.values())
            nary_obs = any(
                et.num_slots > 2 and any(
                    np.asarray(p.marginalized[vt.name]).any()
                    for vt in et.vertex_types)
                for et in p.edge_types.values())
            method = "dense" if (partial or nary_obs) else "schur"
        elif (_sparse_applicable(p)
              and p.total_dim * p.total_dim > 32_000_000):
            method = "sparse"
        else:
            method = "dense"
    if method == "sparse" and not _sparse_applicable(p):
        raise NotImplementedError(
            "sparse marginals require a single uniform vertex type and "
            "binary edges")

    if method == "schur":
        return _schur_marginals(p, spans, lam=lam, estimates=estimates)

    out = {}
    if method == "takahashi":
        if not _sparse_applicable(p):
            raise NotImplementedError(
                "takahashi marginals require binary edges")
        cov_all, tbase = _takahashi_cov_blocks(p, lam=lam,
                                               estimates=estimates)
        for (vid, t, i, d, is_fixed) in spans:
            out[vid] = (np.zeros((d, d)) if is_fixed
                        else cov_all[tbase[t] + i][:d, :d])
        return out

    if method == "sparse":
        # requesting most of the graph — or a mixed-type graph (the
        # per-column supernodal path is uniform-type only): the Takahashi
        # sweep computes ALL blocks for one factorization's worth of work
        if (not _uniform_type(p)
                or len(spans) * 8 >= sum(p.counts.values())):
            return compute_marginals(p, vertex_ids, lam=lam,
                                     estimates=estimates,
                                     method="takahashi")
        locals_ = [i for (_, _, i, _, _) in spans]
        cov = _sparse_cov_blocks(p, locals_, lam=lam, estimates=estimates)
        for m, (vid, _, _, d, is_fixed) in enumerate(spans):
            out[vid] = np.zeros((d, d)) if is_fixed else cov[m]
        return out

    offsets = {t: np.asarray(p.data.offsets[t]) for t in p.vertex_types}
    cols, pos = [], 0
    starts = []
    for (_, t, i, d, _) in spans:
        starts.append(pos)
        cols.extend(range(int(offsets[t][i]), int(offsets[t][i]) + d))
        pos += d
    block = _dense_inverse_block(p, cols, lam=lam, estimates=estimates)
    for (vid, _, _, d, is_fixed), start in zip(spans, starts):
        out[vid] = (np.zeros((d, d)) if is_fixed
                    else block[start:start + d, start:start + d])
    return out


def compute_cross_marginals(problem, vid_a, vid_b, *, lam: float = 0.0,
                            method: str = "dense"):
    """Cross-covariance block ``(H^-1)[a, b]`` (needed by condensed-edge
    construction in hierarchical optimization)."""
    p = problem
    ta, ia = p.vid_index[vid_a]
    tb, ib = p.vid_index[vid_b]
    da = p.vertex_types[ta].tangent_dim
    db = p.vertex_types[tb].tangent_dim

    if method == "sparse":
        # this path additionally unpacks the single vertex type below —
        # _sparse_applicable allows mixed types (the direct solvers pad),
        # but the column-rhs construction here does not
        if not _sparse_applicable(p) or not _uniform_type(p):
            raise NotImplementedError("sparse cross-marginals need a "
                                      "uniform-block problem with binary "
                                      "edges")
        from g2o_tpu.core.solvers.supernodal import (
            SupernodalCholeskySolver, solve_supernodal)

        solver = SupernodalCholeskySolver().setup(p)
        (tname,) = p.vertex_types
        n = p.counts[tname]
        perm = np.asarray(solver.aux["perm"])
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm))
        lin = p.linearize_jit(p.data, p.estimates)
        aux = solver.aux
        dtype = p.dtype
        ka, kb = int(inv[ia]), int(inv[ib])

        @jax.jit
        def run(data, lin, aux):
            blocks = solver._factor_fn(data, lin, jnp.asarray(lam, dtype),
                                       aux)
            rhs = jnp.zeros((n, db, db), dtype=dtype).at[kb].set(
                jnp.eye(db, dtype=dtype))
            X = jax.vmap(solve_supernodal, in_axes=(None, -1, None, None),
                         out_axes=-1)(blocks, rhs, aux["levels"], db)
            return X[ka]

        return np.asarray(run(p.data, lin, aux))

    offsets = {t: np.asarray(p.data.offsets[t]) for t in p.vertex_types}
    oa, ob = int(offsets[ta][ia]), int(offsets[tb][ib])
    cols = list(range(oa, oa + da)) + list(range(ob, ob + db))
    M = _dense_inverse_block(p, cols, lam=lam, estimates=p.estimates)
    return M[:da, da:da + db]
