"""Schur-complement linear solver for bundle adjustment.

Array-program reformulation of the reference ``BlockSolver::solve`` Schur
path (``g2o/core/block_solver.hpp:315-447``):

* the per-landmark ``Dinv = Hll_j^-1`` loop (``:350``) becomes one vmapped
  batched inverse over all landmark blocks;
* the mutex-guarded accumulation ``Hschur_ik -= (B_i Dinv) B_k^T``
  (``:381-391``) becomes a batched einsum over a *precomputed pair list*
  (all ordered pairs of observations sharing a landmark) scatter-added into
  the dense reduced camera matrix — pairs replace the CCS column walk, and
  scatter-add replaces the mutexes;
* the reduced system is factorized with XLA's dense Cholesky —
  the analogue of handing ``Hschur`` to CHOLMOD (``:408``);
* landmark back-substitution ``xl = Dinv (bl - Hpl^T xp)`` (``:420-443``)
  is a segment-sum + batched matmul.

Landmark selection follows the reference convention: vertices marked
``marginalized`` are Schur-eliminated
(``optimization_algorithm_with_hessian.cpp:49-68`` auto-detects this).
Restrictions (round 1): marginalization must be homogeneous per vertex type;
observation edges must be binary (pose-type, landmark-type); all landmark
types must share one tangent dim, and all observation pose slots one dim.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from g2o_tpu.ops.smallblocks import inv_small

_HI = jax.lax.Precision.HIGHEST


class SchurSolver:
    name = "schur"

    def __init__(self, use_cholesky: bool = True, mesh=None):
        """``mesh``: optional ``jax.sharding.Mesh`` with an ``'edges'`` axis.
        When given, the observation and Schur-pair batches are sharded over
        it, so the per-landmark inversions, B-block products and pair
        outer-products run data-parallel; GSPMD inserts the
        psum/reduce-scatter collectives when the partial results accumulate
        into the replicated reduced camera system — the distributed
        formulation of the reference's shared-memory Schur loop
        (``block_solver.hpp:339-393``, SURVEY.md §2.7/§7)."""
        self.use_cholesky = use_cholesky
        self.mesh = mesh
        self._solve_jit = None

    # ------------------------------------------------------------------ #

    def setup(self, problem):
        p = problem
        marg = {t: bool(m.all()) for t, m in problem.marginalized.items()}
        for t, m in problem.marginalized.items():
            if m.any() and not m.all():
                raise NotImplementedError(
                    f"SchurSolver: vertex type {t} is partially "
                    "marginalized — use ImplicitSchurSolver, whose general "
                    "path supports per-vertex marginalization and n-ary "
                    "observation edges exactly"
                )
        lm_types = [t for t, v in marg.items() if v]
        pose_types = [t for t, v in marg.items() if not v]
        if not lm_types:
            raise ValueError("SchurSolver: no marginalized vertices")

        lm_dims = {problem.vertex_types[t].tangent_dim for t in lm_types}
        if len(lm_dims) != 1:
            raise NotImplementedError("mixed landmark tangent dims")
        (dl,) = lm_dims

        # pose-only flat layout
        pose_base, base = {}, 0
        for t in pose_types:
            pose_base[t] = base
            base += problem.counts[t] * problem.vertex_types[t].tangent_dim
        Tp = base
        # landmark linear index across landmark types
        lm_base, nl = {}, 0
        for t in lm_types:
            lm_base[t] = nl
            nl += problem.counts[t]
        NL = nl

        pose_off = {
            t: jnp.asarray(
                pose_base[t]
                + np.arange(problem.counts[t], dtype=np.int32)
                * problem.vertex_types[t].tangent_dim
            )
            for t in pose_types
        }
        pose_fixed_flat = np.zeros(Tp)
        for t in pose_types:
            d = problem.vertex_types[t].tangent_dim
            fx = np.asarray(problem.data.fixed[t])
            for i in np.nonzero(fx)[0]:
                o = pose_base[t] + i * d
                pose_fixed_flat[o:o + d] = 1.0
        pose_fixed_flat = jnp.asarray(pose_fixed_flat, dtype=problem.dtype)

        # classify edge types
        obs_specs = []   # (name, pose_slot, lm_slot)
        pose_edge_types = []
        obs_pose_dims = set()
        for name, et in problem.edge_types.items():
            slots_marg = [marg[vt.name] for vt in et.vertex_types]
            if not any(slots_marg):
                pose_edge_types.append(name)
                continue
            if len(slots_marg) != 2 or all(slots_marg):
                raise NotImplementedError(
                    f"SchurSolver: edge type {name} connects landmarks in an "
                    f"unsupported pattern"
                )
            lm_slot = slots_marg.index(True)
            pose_slot = 1 - lm_slot
            obs_specs.append((name, pose_slot, lm_slot))
            obs_pose_dims.add(et.vertex_types[pose_slot].tangent_dim)
        if len(obs_pose_dims) > 1:
            raise NotImplementedError("mixed pose tangent dims in observations")
        dp = obs_pose_dims.pop() if obs_pose_dims else 0

        # concatenated observation arrays (host-side, static)
        obs_cam_np, obs_lm_np = [], []
        for name, pose_slot, lm_slot in obs_specs:
            et = problem.edge_types[name]
            vidx = np.asarray(problem.data.edges[name].vidx)
            pt, lt = et.vertex_types[pose_slot].name, et.vertex_types[lm_slot].name
            obs_cam_np.append(np.asarray(pose_off[pt])[vidx[:, pose_slot]])
            obs_lm_np.append(lm_base[lt] + vidx[:, lm_slot])
        obs_cam = jnp.asarray(np.concatenate(obs_cam_np).astype(np.int32))  # (Eo,) pose flat offset
        obs_lm_np = np.concatenate(obs_lm_np).astype(np.int32)
        obs_lm = jnp.asarray(obs_lm_np)                                      # (Eo,) landmark linear idx

        # all ordered pairs of observations per landmark (Schur pattern)
        order = np.argsort(obs_lm_np, kind="stable")
        sorted_lm = obs_lm_np[order]
        pairs_a, pairs_b = [], []
        start = 0
        for end in np.flatnonzero(
            np.r_[sorted_lm[1:] != sorted_lm[:-1], True]
        ) + 1:
            grp = order[start:end]
            ga, gb = np.meshgrid(grp, grp, indexing="ij")
            pairs_a.append(ga.reshape(-1))
            pairs_b.append(gb.reshape(-1))
            start = end
        pairs_a_np = (np.concatenate(pairs_a).astype(np.int32)
                      if pairs_a else np.zeros(0, np.int32))
        pairs_b_np = (np.concatenate(pairs_b).astype(np.int32)
                      if pairs_b else np.zeros(0, np.int32))
        # group pairs by (camera-block-row, camera-block-col): many landmark
        # pairs share a camera pair, so Schur contributions are segment-summed
        # into <= (#cam blocks)^2 unique blocks before touching the dense
        # reduced matrix — this keeps the scatter tiny (the analogue of the
        # reference writing into the Hschur block pattern,
        # ``block_solver.hpp:381-391``)
        obs_cam_np_c = np.concatenate(obs_cam_np).astype(np.int64) \
            if obs_cam_np else np.zeros(0, np.int64)
        key = (obs_cam_np_c[pairs_a_np] << 32) | obs_cam_np_c[pairs_b_np]
        uniq, pair_seg_np = np.unique(key, return_inverse=True)
        n_uniq = len(uniq)
        uniq_row = (uniq >> 32).astype(np.int32)
        uniq_col = (uniq & 0xFFFFFFFF).astype(np.int32)
        pair_seg_np = pair_seg_np.astype(np.int32)
        pair_valid_np = np.ones(len(pairs_a_np), dtype=bool)

        # shard the pair batch over the mesh edge axis (pad to divisibility;
        # padded pairs masked out)
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            n_dev = self.mesh.devices.size
            n_pad = (-len(pairs_a_np)) % n_dev
            if n_pad:
                pairs_a_np = np.concatenate(
                    [pairs_a_np, np.zeros(n_pad, np.int32)])
                pairs_b_np = np.concatenate(
                    [pairs_b_np, np.zeros(n_pad, np.int32)])
                pair_seg_np = np.concatenate(
                    [pair_seg_np, np.zeros(n_pad, np.int32)])
                pair_valid_np = np.concatenate(
                    [pair_valid_np, np.zeros(n_pad, bool)])
            shard = NamedSharding(self.mesh, P(self.mesh.axis_names[0]))
            put = lambda a: jax.device_put(jnp.asarray(a), shard)  # noqa: E731
        else:
            put = jnp.asarray
        pairs_a = put(pairs_a_np)
        pairs_b = put(pairs_b_np)
        pair_seg = put(pair_seg_np)
        pair_valid = put(pair_valid_np)
        uniq_row_j = jnp.asarray(uniq_row)
        uniq_col_j = jnp.asarray(uniq_col)

        # landmark global tangent offsets (into the full b / dx vectors)
        lm_goff_np = np.zeros(NL, dtype=np.int32)
        for t in lm_types:
            lm_goff_np[lm_base[t]:lm_base[t] + problem.counts[t]] = \
                np.asarray(problem.data.offsets[t])
        lm_goff = jnp.asarray(lm_goff_np)

        # pose global tangent offsets aligned with pose flat layout
        pose_goff_rows = []
        for t in pose_types:
            d = problem.vertex_types[t].tangent_dim
            offs = np.asarray(problem.data.offsets[t])
            for i in range(problem.counts[t]):
                pose_goff_rows.append((pose_base[t] + i * d, offs[i], d))
        # build gather map global->pose and scatter map pose->global
        pose_to_global = np.zeros(Tp, dtype=np.int32)
        for po, go, d in pose_goff_rows:
            pose_to_global[po:po + d] = np.arange(go, go + d)
        pose_to_global = jnp.asarray(pose_to_global)

        lm_fixed_np = np.zeros(NL, dtype=bool)
        for t in lm_types:
            lm_fixed_np[lm_base[t]:lm_base[t] + problem.counts[t]] = \
                np.asarray(problem.data.fixed[t])
        lm_fixed = jnp.asarray(lm_fixed_np)

        dtype = problem.dtype
        eye_l = jnp.eye(dl, dtype=dtype)

        # all solver-owned index/mask arrays travel as a runtime argument
        # (self.aux) instead of jit-closure constants — embedding ~100k-element
        # index tensors as HLO constants makes compilation (especially remote
        # compilation) pathologically slow
        self.aux = dict(
            obs_cam=obs_cam, obs_lm=obs_lm,
            pairs_a=pairs_a, pairs_b=pairs_b, pair_seg=pair_seg,
            pair_valid=pair_valid,
            uniq_row=uniq_row_j, uniq_col=uniq_col_j,
            pose_off=pose_off, pose_to_global=pose_to_global,
            lm_goff=lm_goff, pose_fixed_flat=pose_fixed_flat,
            lm_fixed=lm_fixed,
        )

        def build_B(data, lin):
            """Per-observation Hessian off-diagonal blocks B = Jp^T W Jl."""
            Bs = []
            for name, pose_slot, lm_slot in obs_specs:
                Js = p.edge_jacs(lin, name)
                W = p.edge_weights(lin, name)
                Bs.append(jnp.einsum("erd,ers,esf->edf",
                                     Js[pose_slot], W, Js[lm_slot],
                                     precision=_HI))
            return jnp.concatenate(Bs, axis=0) if Bs else \
                jnp.zeros((0, dp, dl), dtype=dtype)

        def landmark_diag(lin, lam, aux):
            Ds = []
            for t in lm_types:
                Ds.append(lin.diag[t])
            D = jnp.concatenate(Ds, axis=0) + lam * eye_l
            fx = aux["lm_fixed"].astype(dtype)[:, None, None]
            D = D * (1.0 - fx) + eye_l * fx
            return D

        def build_Hpp(data, lin, lam, aux):
            H = jnp.zeros((Tp, Tp), dtype=dtype)
            for t in pose_types:
                d = problem.vertex_types[t].tangent_dim
                idx = aux["pose_off"][t][:, None] + jnp.arange(d)[None, :]
                H = H.at[idx[:, :, None], idx[:, None, :]].add(lin.diag[t])
            for name in pose_edge_types:
                et = problem.edge_types[name]
                batch = data.edges[name]
                Js = p.edge_jacs(lin, name)
                W = p.edge_weights(lin, name)
                idxs = []
                for s, vt in enumerate(et.vertex_types):
                    d = vt.tangent_dim
                    idx = aux["pose_off"][vt.name][batch.vidx[:, s]][:, None] \
                        + jnp.arange(d)[None, :]
                    idxs.append(idx)
                k = len(Js)
                for i in range(k):
                    WJi = jnp.einsum("ers,erd->esd", W, Js[i],
                                     precision=_HI)
                    for j in range(i + 1, k):
                        Hij = jnp.einsum("esd,esf->edf", WJi, Js[j],
                                         precision=_HI)
                        rows = idxs[i][:, :, None]
                        cols = idxs[j][:, None, :]
                        H = H.at[rows, cols].add(Hij)
                        H = H.at[cols.transpose(0, 2, 1),
                                 rows.transpose(0, 2, 1)].add(
                            Hij.transpose(0, 2, 1))
            H = H + lam * jnp.eye(Tp, dtype=dtype) \
                + jnp.diag(aux["pose_fixed_flat"])
            return H

        def reduced_parts(data, lin, lam, aux):
            """(Hschur, bschur, B, Dinv) — the dense reduced camera system
            plus the per-observation off-diagonal blocks and landmark block
            inverses.  Shared by the linear solve and by Schur-based marginal
            covariance recovery (``core/marginals.py``)."""
            B = build_B(data, lin)                        # (Eo, dp, dl)
            Dinv = inv_small(landmark_diag(lin, lam, aux))

            # split gradient
            bp = lin.b[aux["pose_to_global"]]             # (Tp,)
            lm_idx2 = aux["lm_goff"][:, None] + jnp.arange(dl)[None, :]
            bl = lin.b[lm_idx2]                           # (NL, dl)
            y = jnp.einsum("nij,nj->ni", Dinv, bl,
                           precision=_HI)                 # Dinv * bl

            # bschur = bp - B * y  (scatter over observations)
            contrib = jnp.einsum("edl,el->ed", B, y[aux["obs_lm"]],
                                 precision=_HI)
            cam_idx2 = aux["obs_cam"][:, None] + jnp.arange(dp)[None, :]
            bschur = bp.at[cam_idx2].add(-contrib)

            # Hschur = Hpp - sum over pairs B_a Dinv B_b^T, aggregated per
            # unique camera-block pair first (segment-sum), then one small
            # block scatter into the dense reduced matrix
            Hpp = build_Hpp(data, lin, lam, aux)
            BD = jnp.einsum("edl,elm->edm", B, Dinv[aux["obs_lm"]],
                            precision=_HI)
            M = jnp.einsum("pdm,pfm->pdf", BD[aux["pairs_a"]],
                           B[aux["pairs_b"]], precision=_HI)
            M = M * aux["pair_valid"][:, None, None].astype(M.dtype)
            Mu = jax.ops.segment_sum(M, aux["pair_seg"],
                                     num_segments=n_uniq)
            rows = (aux["uniq_row"][:, None]
                    + jnp.arange(dp)[None, :])[:, :, None]
            cols = (aux["uniq_col"][:, None]
                    + jnp.arange(dp)[None, :])[:, None, :]
            Hschur = Hpp.at[rows, cols].add(-Mu)
            return Hschur, bschur, B, Dinv

        def solve(data, lin, lam, aux):
            Hschur, bschur, B, Dinv = reduced_parts(data, lin, lam, aux)
            lm_idx2 = aux["lm_goff"][:, None] + jnp.arange(dl)[None, :]
            bl = lin.b[lm_idx2]                           # (NL, dl)
            cam_idx2 = aux["obs_cam"][:, None] + jnp.arange(dp)[None, :]

            if self.use_cholesky:
                L, lower = jax.scipy.linalg.cho_factor(Hschur, lower=True)
                dxp = jax.scipy.linalg.cho_solve((L, lower), bschur)
            else:
                dxp = jnp.linalg.solve(Hschur, bschur)

            # back-substitute landmarks: dxl = Dinv (bl - B^T dxp)
            w = jnp.einsum("edl,ed->el", B, dxp[cam_idx2],
                           precision=_HI)
            wl = jnp.zeros_like(bl).at[aux["obs_lm"]].add(w)
            dxl = jnp.einsum("nij,nj->ni", Dinv, bl - wl,
                             precision=_HI)

            # assemble full update
            dx = jnp.zeros_like(lin.b)
            dx = dx.at[aux["pose_to_global"]].set(dxp)
            dx = dx.at[lm_idx2].set(dxl)
            return dx

        self._solve_fn = solve          # unjitted, for fusion into one step
        self._solve_jit = jax.jit(solve)
        self._reduced_parts_fn = reduced_parts   # for marginals
        # layout facts marginals needs to map vertex ids into the reduced
        # (pose-flat / landmark-linear) coordinates
        self._layout = dict(pose_base=pose_base, lm_base=lm_base, Tp=Tp,
                            NL=NL, dp=dp, dl=dl, marg=marg)
        return self

    def solve(self, data, lin, lam=0.0):
        return self._solve_jit(data, lin, lam, self.aux)
