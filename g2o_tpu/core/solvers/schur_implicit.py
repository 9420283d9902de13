"""Implicit (matrix-free) Schur-complement solver for large BA.

The explicit :class:`~g2o_tpu.core.solvers.schur.SchurSolver` enumerates all
observation pairs sharing a landmark (Σ deg² entries) to materialise the
reduced camera matrix — prohibitive at Venice scale.  Here the reduced
system

    S x = (Hpp − Hpl Dinv Hpl^T) x = bschur

is solved by preconditioned CG where S·v is applied *implicitly* from the
per-observation blocks:

    u_e = v[cam_e];  t_j = Σ_{e∈obs(j)} B_e^T u_e;  s_j = Dinv_j t_j;
    S v = Hpp v − Σ_e B_e s_{lm_e}

Landmarks back-substitute exactly as in the explicit path.  This is the
scalable counterpart of the reference's Schur loop
(``block_solver.hpp:339-393``) for graphs where the pair clique expansion
explodes, and complements the square-root CGLS path (which iterates on the
FULL system rather than the reduced one).

Two observation layouts:

* ``layout="rows"`` (default) — row-level gathers/scatters through each edge
  batch's own ``vidx`` (which already travels inside ``data``).  The solver
  owns no index arrays, every reduction is a plain XLA scatter-add, and
  GSPMD edge-sharding reproduces the single-device result bit-for-bit.
* ``layout="bucketed"`` — no row gathers or scatters over the observation
  axis.  At ``setup`` the observations are permuted into a
  landmark-degree-bucketed layout (``g2o_tpu/ops/bucketed.py``): the
  landmark-side reduction/broadcast become per-bucket ``einsum`` over a
  dense degree axis (no gather/scatter at all), and the camera-side
  gather/scatter become one-hot matmuls at ``Precision.HIGHEST`` (exact
  in f32).  Index arrays travel via ``solver.aux``.  Whether it beats
  ``rows`` depends on the device: on the GPU a scatter-add is native, and
  the (N, cameras) one-hot may be materialised rather than fused into the
  matmul.

Preconditioners:

* ``"schur_jacobi"`` (default) — per-camera diagonal blocks of the REDUCED
  system, ``S_jj = Hpp_jj − Σ_{e∈obs(j)} B_e Dinv_{lm(e)} B_e^T`` (the
  standard BA reduced-camera preconditioner); one extra reduction per
  λ-trial, typically several-fold fewer CG iterations than Hpp-Jacobi.
* ``"jacobi"`` — damped Hpp diagonal blocks only.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from g2o_tpu.ops.bucketed import bucket_by_segment
from g2o_tpu.ops.onehot import (onehot_gather as _onehot_matmul_gather,
                                onehot_gather_t as _onehot_gather_t,
                                onehot_scatter_add as _onehot_matmul_scatter,
                                onehot_scatter_add_t as _onehot_scatter_t)
from g2o_tpu.ops.smallblocks import inv_small, inv_small_t

_HI = jax.lax.Precision.HIGHEST


class ImplicitSchurSolver:
    name = "schur_implicit"

    def __init__(self, max_iter: int = 100, tol: float = 1e-8, *,
                 precond: str = "schur_jacobi", layout: str = "auto",
                 onehot_max_segments: int = 8192, max_buckets: int = 10,
                 matvec_precision: str = "auto",
                 absolute_tolerance: bool = True,
                 deflate_basis=None):
        if layout not in ("auto", "rows", "bucketed"):
            raise ValueError(f"unknown layout {layout!r}")
        if precond not in ("schur_jacobi", "jacobi"):
            raise ValueError(f"unknown precond {precond!r}")
        if matvec_precision not in ("auto", "default", "highest"):
            raise ValueError(f"unknown matvec_precision {matvec_precision!r}")
        self.max_iter = int(max_iter)
        self.tol = float(tol)
        self.precond = precond
        self.layout = layout
        self.onehot_max_segments = int(onehot_max_segments)
        self.max_buckets = int(max_buckets)
        # precision of the S·v one-hot matmuls INSIDE the CG loop.  "auto"
        # uses DEFAULT precision (TF32 on the GPU's tensor cores, ~1e-3
        # relative) when the eta-forcing tolerance is loose enough to
        # absorb it (tol >= 1e-3; the setup, preconditioner, and
        # back-substitution always run at HIGHEST) and exact f32
        # otherwise.
        self.matvec_precision = matvec_precision
        # reference-PCG absoluteTolerance semantics: carry half the final
        # preconditioned residual into the next solve's stopping threshold
        # (``solvers/pcg/linear_solver_pcg.h:55``, ``.hpp:124-127,149``)
        self.absolute_tolerance = bool(absolute_tolerance)
        # near-null-space deflation: ``{pose_type: (N, d, k)}`` ORTHONORMAL
        # basis (flattened columns orthonormal).  The reduced CG runs on
        # the orthogonal complement — rhs, preconditioned residuals and
        # matvec outputs are projected, so the Krylov space never excites
        # the λ-eigenvalue gauge cluster that otherwise costs 15-130
        # iterations on free-gauge late solves (the gradient is exactly
        # orthogonal to gauge orbits, so the discarded component is noise).
        # Build with ``g2o_tpu.types.bal.bal_gauge_basis(problem)``.
        self.deflate_basis = deflate_basis
        self.aux = ()
        self._solve_fn = None
        self._solve_jit = None

    # ------------------------------------------------------------------ #

    def _classify(self, problem):
        """General per-vertex classification.

        Returns ``(lm_types, pose_types, obs_specs, pose_edge_types,
        partial, general)`` where ``obs_specs`` entries are
        ``(name, pose_slots tuple, lm_slot)``.  An edge type is an
        observation iff at least one endpoint vertex in its marginal slot
        is actually marginalized; the reference builds its Schur pattern
        per-vertex the same way (``block_solver.hpp:224-253``) and its
        n-ary quadratic form provides all slot-pair blocks
        (``base_multi_edge.h:51,115``).  Edges coupling TWO marginalized
        vertices would break the block-diagonal Hll the Schur trick needs
        (also assumed by the reference) and are rejected."""
        p = problem
        marg_np = {t: np.asarray(m) for t, m in p.marginalized.items()}
        lm_types = [t for t, m in marg_np.items() if m.any()]
        pose_types = [t for t in p.vertex_types if t not in lm_types]
        partial = {t: bool(marg_np[t].any() and not marg_np[t].all())
                   for t in p.vertex_types}
        if not lm_types:
            raise ValueError("ImplicitSchurSolver: no marginalized vertices")

        obs_specs, pose_edge_types = [], []
        for name, et in p.edge_types.items():
            lm_slots = [s for s, vt in enumerate(et.vertex_types)
                        if vt.name in lm_types]
            if not lm_slots:
                pose_edge_types.append(name)
                continue
            vidx = np.asarray(p.data.edges[name].vidx)
            hot = [s for s in lm_slots
                   if marg_np[et.vertex_types[s].name][
                       np.minimum(vidx[:, s],
                                  len(marg_np[et.vertex_types[s].name]) - 1)
                   ].any()]
            if len(hot) > 1:
                raise NotImplementedError(
                    f"{name}: edges coupling two marginalized vertices are "
                    "not supported (Hll must stay block-diagonal)")
            if not hot:
                pose_edge_types.append(name)
                continue
            ls = hot[0]
            pose_slots = tuple(s for s in range(et.num_slots) if s != ls)
            obs_specs.append((name, pose_slots, ls))
        general = (any(partial[t] for t in lm_types)
                   or any(len(pslots) != 1 for _, pslots, _ in obs_specs))
        return (lm_types, pose_types, obs_specs, pose_edge_types, partial,
                general)

    def setup(self, problem):
        p = problem
        (lm_types, pose_types, obs_specs, pose_edge_types, partial,
         general) = self._classify(p)
        if general:
            # n-ary observation edges and/or per-vertex partial
            # marginalization: the exact rows-layout general path (the
            # bucketed fast paths cover the standard binary BA pattern)
            if self.layout == "bucketed":
                raise NotImplementedError(
                    "layout='bucketed' supports the standard binary "
                    "pose-landmark pattern only; this graph needs the "
                    "general path (layout='rows'/'auto')")
            return self._setup_general(p, lm_types, pose_types, obs_specs,
                                       pose_edge_types, partial)
        obs_specs = [(name, pslots[0], ls)
                     for name, pslots, ls in obs_specs]
        dtype = p.dtype
        max_iter, tol = self.max_iter, self.tol
        tmap = jax.tree_util.tree_map
        use_schur_precond = self.precond == "schur_jacobi"
        # "auto": use the bucketed fast path iff the problem was compiled
        # with bucket_landmarks=True (its edge batches are already in the
        # padded bucket layout — no per-solve permutation needed at all)
        pre = {name: name in p.bucket_specs for name, _, _ in obs_specs}
        if self.layout == "bucketed":
            bucketed = True
        elif self.layout == "auto":
            bucketed = bool(obs_specs) and all(pre.values())
        else:
            bucketed = False

        def damped_diag(data, lin, lam, types):
            out = {}
            for t in types:
                d = p.vertex_types[t].tangent_dim
                eye = jnp.eye(d, dtype=dtype)
                blocks = lin.diag[t] + lam * eye
                fx = data.fixed[t].astype(dtype)[:, None, None]
                out[t] = blocks * (1.0 - fx) + eye * fx
            return out

        def pdot(a, b):
            # multiply+sum: exact f32 elementwise work (a DEFAULT-precision
            # dot may run in TF32 — noisy CG scalars stall convergence)
            return sum(jnp.sum(a[t] * b[t]) for t in pose_types)

        # ---------------- bucketed layout: host symbolic phase ------------ #
        # per obs edge type: a landmark-degree BucketPlan over its rows, the
        # permuted source-row and camera-id arrays (travel via aux), and the
        # static per-bucket (count, degree) shapes (baked in the closure)
        bspec = {}
        aux = {}
        if bucketed:
            for name, ps, ls in obs_specs:
                if pre[name]:
                    # compile-time bucketed batch: rows are already in slab
                    # order, seg_perm travels in data.plans, camera ids ARE
                    # the (padded) vidx pose column
                    sp = p.bucket_specs[name]
                    bspec[name] = (sp.counts, sp.degrees, sp.n_rows)
                    continue
                et = p.edge_types[name]
                lt = et.vertex_types[ls].name
                pt = et.vertex_types[ps].name
                vidx = np.asarray(p.data.edges[name].vidx)
                E = vidx.shape[0]
                plan = bucket_by_segment(vidx[:, ls], p.counts[lt],
                                         max_buckets=self.max_buckets)
                camz = np.concatenate(
                    [vidx[:, ps].astype(np.int64), [p.counts[pt]]])
                cam_pad = camz[plan.perm_src].astype(np.int32)
                aux[name] = {
                    "perm": jnp.asarray(plan.perm_src),
                    "cam": jnp.asarray(cam_pad),
                    "segp": jnp.asarray(plan.seg_perm),
                }
                bspec[name] = (plan.counts, plan.degrees,
                               int(len(plan.perm_src)))
            self.aux = aux
        if self.deflate_basis:
            aux["deflate_G"] = {t: jnp.asarray(np.asarray(v), dtype=dtype)
                                for t, v in self.deflate_basis.items()}
            self.aux = aux

        if self.matvec_precision == "default":
            MV = jax.lax.Precision.DEFAULT
        elif self.matvec_precision == "highest":
            MV = _HI
        else:
            # TF32 matmuls (~1e-3 relative) are absorbed by eta-forcing CG
            # when tol is loose; exact f32 otherwise (and always in f64)
            MV = (jax.lax.Precision.DEFAULT
                  if (self.tol >= 1e-3
                      and np.dtype(dtype) == np.dtype(np.float32))
                  else _HI)

        def pose_rows_gather(vb_t, idx, n_pose, prec=_HI):
            if n_pose <= self.onehot_max_segments:
                return _onehot_matmul_gather(idx, vb_t, precision=prec)
            return vb_t[jnp.minimum(idx, n_pose - 1)] * \
                (idx < n_pose).astype(dtype)[:, None]

        def pose_rows_scatter(idx, rows, n_pose, prec=_HI):
            if n_pose <= self.onehot_max_segments:
                return _onehot_matmul_scatter(idx, rows, n_pose,
                                              precision=prec)
            return jnp.zeros((n_pose,) + rows.shape[1:],
                             dtype=rows.dtype).at[idx].add(rows)

        # dims-major twins: rows travel (d, E) so the one-hot dot contracts
        # the edge axis directly — no (E, d) <-> (d, E) relayout in the CG
        # body at all
        def pose_rows_gather_t(vb_t, idx, n_pose, prec=_HI):
            if n_pose <= self.onehot_max_segments:
                return _onehot_gather_t(idx, vb_t, precision=prec)
            return pose_rows_gather(vb_t, idx, n_pose, prec).T

        def pose_rows_scatter_t(idx, rows_t, n_pose, prec=_HI):
            if n_pose <= self.onehot_max_segments:
                return _onehot_scatter_t(idx, rows_t, n_pose, precision=prec)
            return jnp.zeros((n_pose, rows_t.shape[0]),
                             dtype=rows_t.dtype).at[idx].add(rows_t.T)

        def bucket_down(spec, B_pad, u_pad):
            """Per-bucket Σ_rows B^T u → per-segment (S_used, dl); the
            degree axis reduces inside the einsum (no materialised
            intermediate).  Slabs are degree-major: (deg, n_seg)."""
            counts, degrees, _ = spec
            out, off = [], 0
            for n, d in zip(counts, degrees):
                Bb = B_pad[off:off + n * d]
                ub = u_pad[off:off + n * d]
                Bb = Bb.reshape((d, n) + Bb.shape[1:])
                ub = ub.reshape((d, n) + ub.shape[1:])
                out.append(jnp.einsum("dnij,dni->nj", Bb, ub))
                off += n * d
            return jnp.concatenate(out, axis=0)

        def bucket_up(spec, B_pad, s_used):
            """Per-bucket B s_{segment(row)} → padded rows (E_pad, dp); the
            broadcast over the degree axis fuses into the einsum."""
            counts, degrees, _ = spec
            out, off, k = [], 0, 0
            for n, d in zip(counts, degrees):
                Bb = B_pad[off:off + n * d]
                Bb = Bb.reshape((d, n) + Bb.shape[1:])
                sb = s_used[k:k + n]
                yb = jnp.einsum("dnij,nj->dni", Bb, sb)
                out.append(yb.reshape((n * d,) + yb.shape[2:]))
                off += n * d
                k += n
            return jnp.concatenate(out, axis=0)

        # ----- dims-major (transposed) CG-loop kernels ----- #
        # Batched tiny-block einsums on (E, dp, dl) arrays waste a matmul
        # unit on 9x3 tiles; with the EDGE axis minormost every
        # contraction is elementwise work over a long, contiguous axis
        # instead, which XLA fuses.

        def bucket_down_t(spec, Bt, ut):
            """Σ_rows Bᵀu in dims-major: Bt (dp, dl, E), ut (dp, E) →
            (dl, S_used) in bucket order.  Degree-major slabs: the (dl,
            deg, n_seg) view keeps the large segment axis on lanes."""
            counts, degrees, _ = spec
            z = jnp.einsum("ile,ie->le", Bt, ut)
            out, off = [], 0
            for n, d in zip(counts, degrees):
                blk = z[:, off:off + n * d]
                out.append(blk.reshape(blk.shape[0], d, n).sum(axis=1))
                off += n * d
            return jnp.concatenate(out, axis=1)

        def bucket_up_t(spec, Bt, st):
            """B s per row in dims-major: st (dl, S_used) → rows (dp, E)."""
            counts, degrees, _ = spec
            parts, off = [], 0
            for n, d in zip(counts, degrees):
                sb = st[:, off:off + n]
                parts.append(jnp.broadcast_to(
                    sb[:, None, :], (sb.shape[0], d, n)).reshape(
                    sb.shape[0], n * d))
                off += n
            se = jnp.concatenate(parts, axis=1)
            return jnp.einsum("ile,le->ie", Bt, se)

        def bucket_broadcast_t(spec, x):
            """Broadcast per-segment values ``(..., S_used)`` to padded row
            layout ``(..., E)`` — pure reshapes, edge axis minormost
            (degree-major slabs)."""
            counts, degrees, _ = spec
            parts, off = [], 0
            for n, d in zip(counts, degrees):
                xb = x[..., off:off + n]
                parts.append(jnp.broadcast_to(
                    xb[..., None, :], xb.shape[:-1] + (d, n)).reshape(
                    x.shape[:-1] + (n * d,)))
                off += n
            return jnp.concatenate(parts, axis=-1)

        # landmark types touched by exactly ONE observation edge type run
        # the CG loop entirely in bucket order — no index op at all beside
        # the camera one-hots (BAL and every standard BA graph)
        lm_touch = {}
        for name, ps, ls in obs_specs:
            lt = p.edge_types[name].vertex_types[ls].name
            lm_touch.setdefault(lt, []).append(name)
        sole_obs = {name: (len(lm_touch[
            p.edge_types[name].vertex_types[ls].name]) == 1)
            for name, ps, ls in obs_specs}

        # ------------------------------------------------------------------ #

        def solve_full(data, lin, lam, aux=(), carry=None):
            ext = getattr(lin, "extras", None) or {}
            # edges on the fully dims-major fast path: compile-time bucketed
            # slabs whose B / bucket-order landmark system were already
            # produced by linearize (shared across λ-trials) and whose
            # landmark type has a single observation edge type — BAL and
            # every standard BA graph
            dm = {name: (bucketed and pre.get(name, False)
                         and sole_obs[name] and "Bt" in ext.get(name, ()))
                  for name, ps, ls in obs_specs}
            dm_lm = {p.edge_types[name].vertex_types[ls].name
                     for name, ps, ls in obs_specs if dm[name]}

            if bucketed:
                def segp_of(name):
                    return (data.plans[name]["segp"] if pre[name]
                            else aux[name]["segp"])

                def cam_of(name, ps):
                    if pre[name]:
                        return data.edges[name].vidx[:bspec[name][2], ps]
                    return aux[name]["cam"]

                def seg_ident(name):
                    return (pre[name]
                            and p.bucket_specs[name].seg_identity)

                # bucket-order <-> natural-order landmark rows: static
                # slices when the type was reordered into bucket order at
                # compile time (seg_identity), else permutation ops
                def seg_take(name, arr):
                    if seg_ident(name):
                        return arr[:sum(p.bucket_specs[name].counts)]
                    return arr[segp_of(name)]

                def seg_add(name, out, vals):
                    if seg_ident(name):
                        return out.at[:vals.shape[0]].add(vals)
                    return out.at[segp_of(name)].add(vals,
                                                     unique_indices=True)

                def seg_set(name, out, vals):
                    if seg_ident(name):
                        return out.at[:vals.shape[0]].set(vals)
                    return out.at[segp_of(name)].set(vals,
                                                     unique_indices=True)

            # per-landmark-type Dinv (batched closed-form inverses) for
            # types NOT on the dims-major path
            Dinv = {t: inv_small(D)
                    for t, D in damped_diag(
                        data, lin, lam,
                        [t for t in lm_types if t not in dm_lm]).items()}

            # dims-major fast path: bucket-order landmark system straight
            # from the linearize extras — never scattered to natural order
            # and gathered back, and never relayouted: the (dd, S) extras
            # feed ``inv_small_t`` directly, so the per-λ-trial
            # ``(S, d, d) <-> (d, d, S)`` transpose copies are gone
            Bt_s, Dinv_t, bl_bt = {}, {}, {}
            for name, ps, ls in obs_specs:
                if not dm[name]:
                    continue
                lt = p.edge_types[name].vertex_types[ls].name
                d = p.vertex_types[lt].tangent_dim
                nb = bspec[name][2]
                Bt_s[name] = ext[name]["Bt"][:, :, :nb]
                blt = ext[name].get("bl_bucket_t")
                if blt is None:                    # older extras producers
                    blt = ext[name]["bl_bucket"].T
                    Hll_t = ext[name]["Hll_bucket"].reshape(-1, d * d).T
                else:
                    Hll_t = ext[name]["Hll_bucket_t"]
                bl_bt[name] = blt                              # (d, S)
                Hll_t = Hll_t.reshape(d, d, -1)                # (d, d, S)
                eye_t = jnp.eye(d, dtype=dtype)[:, :, None]
                # all-zero blocks = fixed landmarks (Jacobian slots masked
                # at linearize) → unit diagonal, dx = 0: the same
                # protection damped_diag applies via data.fixed
                zero = jnp.all(Hll_t == 0, axis=(0, 1))[None, None, :]
                Dinv_t[name] = inv_small_t(
                    jnp.where(zero, eye_t, Hll_t + lam * eye_t))

            # off-diagonal blocks B = Jp^T W Jl for the remaining edges,
            # DIMS-MAJOR (edge axis minormost) via explicit broadcast-
            # multiply-reduce: exact f32 elementwise work (the equivalent
            # einsum lowers to E-batched tiny dots)
            B, Bt = {}, {}
            for name, ps, ls in obs_specs:
                if dm[name]:
                    continue
                Js, W = lin.jacs[name], lin.weights[name]
                if name in p.bucket_specs:
                    # bucketed leaves are already dims-major
                    Jpt, Jlt, Wt = Js[ps], Js[ls], W
                else:
                    Jpt = Js[ps].transpose(1, 2, 0)          # (r, dp, E)
                    Jlt = Js[ls].transpose(1, 2, 0)          # (r, dl, E)
                    Wt = W.transpose(1, 2, 0)                # (r, s, E)
                WJl = jnp.sum(Wt[:, :, None, :] * Jlt[None, :, :, :], axis=1)
                Bt[name] = jnp.sum(Jpt[:, :, None, :] * WJl[:, None, :, :],
                                   axis=0)                   # (dp, dl, E)
                B[name] = Bt[name].transpose(2, 0, 1)

            if bucketed:
                # B already lands in slab order for compile-time bucketed
                # batches; otherwise permute once per solve (sentinel row E
                # is zero)
                Bp, Dinv_perm = {}, {}
                for name, ps, ls in obs_specs:
                    if dm[name]:
                        continue
                    et = p.edge_types[name]
                    lt = et.vertex_types[ls].name
                    if pre[name]:
                        Bp[name] = B[name]
                    else:
                        Bz = jnp.concatenate(
                            [B[name],
                             jnp.zeros((1,) + B[name].shape[1:],
                                       dtype=dtype)])
                        Bp[name] = Bz[aux[name]["perm"]]
                    Dinv_perm[name] = seg_take(name, Dinv[lt])
                # dims-major copies for the CG loop; trailing
                # pad_edges_to_multiple rows beyond the slab-covered prefix
                # are dropped (they carry W == 0).  Compile-time bucketed
                # batches reuse Bt directly — no relayout at all.
                Bpt = {name: (Bt[name][:, :, :bspec[name][2]] if pre[name]
                              else Bp[name][:bspec[name][2]]
                              .transpose(1, 2, 0))
                       for name in Bp}
                DinvT_perm = {name: v.transpose(1, 2, 0)
                              for name, v in Dinv_perm.items()}

            ball = p.split_tangent(lin.b)
            bp = {t: ball[t] for t in pose_types}
            bl = {t: ball[t] for t in lm_types}
            y = {t: jnp.einsum("nij,nj->ni", Dinv[t], bl[t])
                 for t in lm_types if t not in dm_lm}
            # dims-major Dinv·bl: exact elementwise work (the row-major
            # batched tiny matvec lowers to tiny dots)
            y_bt = {name: jnp.einsum("ijn,jn->in", Dinv_t[name],
                                     bl_bt[name])
                    for name in Dinv_t}

            # bschur = bp - B * (Dinv bl)
            bschur = dict(bp)
            for name, ps, ls in obs_specs:
                et = p.edge_types[name]
                pt = et.vertex_types[ps].name
                lt = et.vertex_types[ls].name
                if dm[name]:
                    rows_t = bucket_up_t(bspec[name], Bt_s[name],
                                         y_bt[name])
                    bschur[pt] = bschur[pt] - pose_rows_scatter_t(
                        cam_of(name, ps), rows_t, p.counts[pt])
                elif bucketed:
                    rows = bucket_up(bspec[name], Bp[name],
                                     seg_take(name, y[lt]))
                    bschur[pt] = bschur[pt] - pose_rows_scatter(
                        cam_of(name, ps), rows, p.counts[pt])
                else:
                    vidx = data.edges[name].vidx
                    bschur[pt] = bschur[pt].at[vidx[:, ps]].add(
                        -jnp.einsum("edl,el->ed", B[name],
                                    y[lt][vidx[:, ls]]))

            # preconditioner: damped Hpp diag, optionally minus the Schur
            # term's per-camera diagonal (the reduced-system Jacobi blocks)
            diag_blocks = damped_diag(data, lin, lam, pose_types)
            sdiag = dict(diag_blocks)
            if use_schur_precond:
                for name, ps, ls in obs_specs:
                    et = p.edge_types[name]
                    pt = et.vertex_types[ps].name
                    lt = et.vertex_types[ls].name
                    if dm[name]:
                        # C = B Dinv Bᵀ per row, dims-major broadcast form
                        Bts = Bt_s[name]
                        dp_ = Bts.shape[0]
                        Drows = bucket_broadcast_t(bspec[name],
                                                   Dinv_t[name])   # (l,l,E)
                        T_ = jnp.sum(Bts[:, :, None, :]
                                     * Drows[None, :, :, :], axis=1)
                        C_t = jnp.sum(T_[:, None, :, :]
                                      * Bts[None, :, :, :], axis=2)
                        sdiag[pt] = sdiag[pt] - pose_rows_scatter_t(
                            cam_of(name, ps), C_t.reshape(dp_ * dp_, -1),
                            p.counts[pt]).reshape(-1, dp_, dp_)
                    elif bucketed:
                        counts, degrees, _ = bspec[name]
                        Dp, off, k, rows = Dinv_perm[name], 0, 0, []
                        for n, d in zip(counts, degrees):
                            Bb = Bp[name][off:off + n * d]
                            Bb = Bb.reshape((d, n) + Bb.shape[1:])
                            Cb = jnp.einsum("dnij,njk,dnlk->dnil",
                                            Bb, Dp[k:k + n], Bb,
                                            precision=_HI)
                            rows.append(Cb.reshape((n * d,) + Cb.shape[2:]))
                            off += n * d
                            k += n
                        C = jnp.concatenate(rows, axis=0)
                        sdiag[pt] = sdiag[pt] - pose_rows_scatter(
                            cam_of(name, ps), C, p.counts[pt])
                    else:
                        vidx = data.edges[name].vidx
                        C = jnp.einsum("edl,elm,efm->edf", B[name],
                                       Dinv[lt][vidx[:, ls]], B[name],
                                       precision=_HI)
                        sdiag[pt] = sdiag[pt].at[vidx[:, ps]].add(-C)
                # fixed cameras keep their unit rows (B rows are zeroed at
                # linearize, so the subtraction leaves them intact)
            minv = {t: inv_small(sdiag[t]) for t in pose_types}

            def S_vec(vb):
                # Hpp v: diagonal blocks (pure einsum) + pose-pose couplings
                out = {t: jnp.einsum("nij,nj->ni", diag_blocks[t], vb[t],
                                     precision=MV)
                       for t in pose_types}
                for name in pose_edge_types:
                    et = p.edge_types[name]
                    vidx = data.edges[name].vidx
                    Js = p.edge_jacs(lin, name)
                    W = p.edge_weights(lin, name)
                    k = len(Js)
                    for i in range(k):
                        ti = et.vertex_types[i].name
                        acc = None
                        for j in range(k):
                            if i == j:
                                continue
                            tj = et.vertex_types[j].name
                            h = jnp.einsum(
                                "erd,ers,esf,ef->ed", Js[i], W, Js[j],
                                vb[tj][vidx[:, j]], precision=MV)
                            acc = h if acc is None else acc + h
                        if acc is not None:
                            out[ti] = out[ti].at[vidx[:, i]].add(acc)
                # Schur term: − B Dinv B^T v.
                # Landmark types with a single observation edge type run
                # fully in BUCKET ORDER and dims-major layout — no segment
                # index op at all; only the camera one-hots remain, at the
                # matvec precision MV.
                if bucketed:
                    for name, ps, ls in obs_specs:
                        if not sole_obs[name]:
                            continue
                        pt = p.edge_types[name].vertex_types[ps].name
                        if dm[name]:
                            # fully dims-major: the gather/scatter one-hot
                            # dots contract the edge axis, so no (E, d) <->
                            # (d, E) relayout appears in the loop body
                            u_t = pose_rows_gather_t(
                                vb[pt], cam_of(name, ps), p.counts[pt], MV)
                            t_ = bucket_down_t(bspec[name], Bt_s[name], u_t)
                            s_t = jnp.einsum("lke,ke->le",
                                             Dinv_t[name], t_)
                            rows_t = bucket_up_t(bspec[name], Bt_s[name],
                                                 s_t)
                            out[pt] = out[pt] - pose_rows_scatter_t(
                                cam_of(name, ps), rows_t, p.counts[pt], MV)
                            continue
                        u = pose_rows_gather(vb[pt], cam_of(name, ps),
                                             p.counts[pt], MV)
                        t_ = bucket_down_t(bspec[name], Bpt[name], u.T)
                        s_t = jnp.einsum("lke,ke->le",
                                         DinvT_perm[name], t_)
                        rows_t = bucket_up_t(bspec[name], Bpt[name], s_t)
                        out[pt] = out[pt] - pose_rows_scatter(
                            cam_of(name, ps), rows_t.T, p.counts[pt], MV)
                rem = [spec for spec in obs_specs
                       if not (bucketed and sole_obs[spec[0]])]
                if rem:
                    tl = {t: jnp.zeros((p.counts[t],
                                        p.vertex_types[t].tangent_dim),
                                       dtype=dtype) for t in lm_types}
                    for name, ps, ls in rem:
                        et = p.edge_types[name]
                        pt = et.vertex_types[ps].name
                        lt = et.vertex_types[ls].name
                        if bucketed:
                            u = pose_rows_gather(vb[pt], cam_of(name, ps),
                                                 p.counts[pt])
                            part = bucket_down(bspec[name], Bp[name], u)
                            tl[lt] = seg_add(name, tl[lt], part)
                        else:
                            vidx = data.edges[name].vidx
                            u = vb[pt][vidx[:, ps]]
                            tl[lt] = tl[lt].at[vidx[:, ls]].add(
                                jnp.einsum("edl,ed->el", B[name], u,
                                           precision=MV))
                    s_ = {t: jnp.einsum("nij,nj->ni", Dinv[t], tl[t],
                                        precision=MV)
                          for t in lm_types}
                    for name, ps, ls in rem:
                        et = p.edge_types[name]
                        pt = et.vertex_types[ps].name
                        lt = et.vertex_types[ls].name
                        if bucketed:
                            rows = bucket_up(bspec[name], Bp[name],
                                             seg_take(name, s_[lt]))
                            out[pt] = out[pt] - pose_rows_scatter(
                                cam_of(name, ps), rows, p.counts[pt])
                        else:
                            vidx = data.edges[name].vidx
                            out[pt] = out[pt].at[vidx[:, ps]].add(
                                -jnp.einsum("edl,el->ed", B[name],
                                            s_[lt][vidx[:, ls]],
                                            precision=MV))
                return out

            def precond(rb):
                return {t: jnp.einsum("nij,nj->ni", minv[t], rb[t])
                        for t in pose_types}

            # gauge deflation (free-gauge BA): run CG on the orthogonal
            # complement of the analytic near-null basis — rhs, matvec
            # outputs and preconditioned residuals are projected, so the
            # λ-eigenvalue cluster never enters the Krylov space
            G = aux.get("deflate_G") if isinstance(aux, dict) else None
            if G is not None:
                def project(vb):
                    coef = None
                    for t, Gt in G.items():
                        c = jnp.einsum("ndk,nd->k", Gt, vb[t])
                        coef = c if coef is None else coef + c
                    out = dict(vb)
                    for t, Gt in G.items():
                        out[t] = vb[t] - jnp.einsum("ndk,k->nd", Gt, coef)
                    return out
            else:
                def project(vb):
                    return vb

            x0 = tmap(jnp.zeros_like, bschur)
            r0 = project(bschur)
            z0 = project(precond(r0))
            rz0 = pdot(r0, z0)
            # termination: ||r||^2 <= max(tol^2 ||b||^2, carry), where
            # ``carry`` is half the final ||r||^2 of the PREVIOUS solve —
            # the reference PCG's absoluteTolerance residual continuation
            # (``solvers/pcg/linear_solver_pcg.hpp:124-127,149``, applied
            # there to the preconditioned norm).  Successive LM solves then
            # only deepen by one halving each; without the carry, CG grinds
            # the full budget once LM has converged and the relative
            # criterion chases a vanishing rhs.
            rhs2 = pdot(bschur, bschur)
            thresh = tol * tol * rhs2
            if carry is not None:
                thresh = jnp.maximum(thresh, carry.astype(thresh.dtype))

            def cond(c):
                return jnp.logical_and(c[5] < max_iter,
                                       pdot(c[1], c[1]) > thresh)

            def body(c):
                x, r, z, pv, rz, it = c
                Ap = project(S_vec(pv))
                alpha = rz / pdot(pv, Ap)
                x = tmap(lambda a, b_: a + alpha * b_, x, pv)
                r = tmap(lambda a, b_: a - alpha * b_, r, Ap)
                z = project(precond(r))
                rz2 = pdot(r, z)
                pv = tmap(lambda a, b_: a + (rz2 / rz) * b_, z, pv)
                return (x, r, z, pv, rz2, it + 1)

            dxp, r_f, _, _, rz_f, cg_iters = jax.lax.while_loop(
                cond, body, (x0, r0, z0, z0, rz0, 0))

            # back-substitute landmarks: dxl = Dinv (bl - B^T dxp)
            wl = {t: jnp.zeros_like(bl[t])
                  for t in lm_types if t not in dm_lm}
            dxl = {}
            for name, ps, ls in obs_specs:
                et = p.edge_types[name]
                pt = et.vertex_types[ps].name
                lt = et.vertex_types[ls].name
                if dm[name]:
                    # bucket order end-to-end; ONE row scatter places the
                    # final landmark update into natural order
                    u_t = pose_rows_gather_t(dxp[pt], cam_of(name, ps),
                                             p.counts[pt])
                    t_ = bucket_down_t(bspec[name], Bt_s[name], u_t)
                    dxl_t = jnp.einsum("ijn,jn->in", Dinv_t[name],
                                       bl_bt[name] - t_)
                    d = p.vertex_types[lt].tangent_dim
                    dxl[lt] = seg_set(name, jnp.zeros(
                        (p.counts[lt], d), dtype=dtype), dxl_t.T)
                elif bucketed:
                    u = pose_rows_gather(dxp[pt], cam_of(name, ps),
                                         p.counts[pt])
                    part = bucket_down(bspec[name], Bp[name], u)
                    wl[lt] = seg_add(name, wl[lt], part)
                else:
                    vidx = data.edges[name].vidx
                    wl[lt] = wl[lt].at[vidx[:, ls]].add(
                        jnp.einsum("edl,ed->el", B[name],
                                   dxp[pt][vidx[:, ps]]))
            for t in lm_types:
                if t not in dm_lm:
                    dxl[t] = jnp.einsum("nij,nj->ni", Dinv[t],
                                        bl[t] - wl[t])

            res2 = pdot(r_f, r_f)
            stats = {"cg_iterations": cg_iters,
                     "residual2": res2,
                     "rhs2": rhs2,
                     "carry": 0.5 * res2}
            return p.join_tangent({**dxp, **dxl}), stats

        def solve(data, lin, lam, aux=()):
            return solve_full(data, lin, lam, aux)[0]

        def solve_state(data, lin, lam, aux, state):
            dx, st = solve_full(data, lin, lam, aux, carry=state)
            return dx, st["carry"], st

        # diagnostic entry point: also returns CG iteration count and final
        # residual (the analogue of the reference's iterationsLinearSolver
        # batch stat, ``g2o/core/batch_stats.h:59``)
        self._solve_full = solve_full
        self._solve_full_jit = jax.jit(solve_full)
        self._solve_fn = solve
        self._solve_jit = jax.jit(solve)
        if self.absolute_tolerance:
            # stateful protocol: drivers thread the residual carry through
            # their iteration loops (``lm_fused`` detects _solve_state_fn)
            self._solve_state_fn = solve_state
            self._solve_state_jit = jax.jit(solve_state)
            self.state0 = jnp.asarray(-1.0, dtype)
        self._host_state = None
        return self

    def _setup_general(self, problem, lm_types, pose_types, obs_specs,
                       pose_edge_types, partial):
        """Exact rows-layout path for the GENERAL marginalization patterns
        the reference supports (``block_solver.hpp:224-253,315-447``,
        ``base_multi_edge.h:51,115``):

        * n-ary observation edges — multiple pose slots per edge, e.g.
          inverse-depth ``EdgeProjectPSI2UV`` (point-psi, anchor, observer;
          ``types/sba/types_six_dof_expmap.h:183``): every pose-slot pair
          contributes an Hpp coupling; every pose slot couples to the
          marginalized slot through its own B block.
        * per-vertex partial marginalization — a strict subset of a type's
          vertices is eliminated (per-edge ``elim`` mask); retained
          vertices of that type ride the reduced CG system alongside the
          pose types, pinned to zero on eliminated rows.
        """
        p = problem
        dtype = p.dtype
        max_iter, tol = self.max_iter, self.tol
        tmap = jax.tree_util.tree_map
        use_schur_precond = self.precond == "schur_jacobi"
        cg_types = pose_types + [t for t in lm_types if partial[t]]
        full_lm = [t for t in lm_types if not partial[t]]
        if self.deflate_basis:
            # the analytic gauge bases are built for the standard BAL
            # camera/landmark split; silently dropping the user's request
            # here would leave late free-gauge solves grinding the cap
            raise NotImplementedError(
                "deflate_basis is not supported on the general "
                "(n-ary/partial) marginalization path")

        # static masks -> aux (solver-owned arrays travel as jit arguments)
        aux = {"marg": {}, "elim": {}}
        marg_np = {t: np.asarray(p.marginalized[t]) for t in lm_types}
        for t in lm_types:
            if partial[t]:
                aux["marg"][t] = jnp.asarray(marg_np[t].astype(np.float64),
                                             dtype=dtype)
        for name, pslots, ls in obs_specs:
            lt = p.edge_types[name].vertex_types[ls].name
            vl = np.asarray(p.data.edges[name].vidx)[:, ls]
            elim = marg_np[lt][np.minimum(vl, len(marg_np[lt]) - 1)]
            aux["elim"][name] = jnp.asarray(elim.astype(np.float64),
                                            dtype=dtype)
        self.aux = aux
        hi = _HI
        # CG-body matvec precision, same contract as the standard path:
        # "auto"/"default" = TF32 on the GPU, "highest" = exact f32
        # (reduced-precision matvecs stall CG at the cap once LM converges)
        mv = _HI if self.matvec_precision == "highest" else None

        def damped_diag(data, lin, lam, types):
            out = {}
            for t in types:
                d = p.vertex_types[t].tangent_dim
                eye = jnp.eye(d, dtype=dtype)
                blocks = lin.diag[t] + lam * eye
                fx = data.fixed[t].astype(dtype)[:, None, None]
                out[t] = blocks * (1.0 - fx) + eye * fx
            return out

        def pdot(a, b):
            return sum(jnp.sum(a[t] * b[t]) for t in cg_types)

        def solve_full(data, lin, lam, aux=(), carry=None):
            aux = aux or self.aux
            eyes = {t: jnp.eye(p.vertex_types[t].tangent_dim, dtype=dtype)
                    for t in p.vertex_types}
            # eliminated-block inverses: damped diag on marginalized rows,
            # unit elsewhere (unused there — back-substitution masks)
            Dfull = damped_diag(data, lin, lam, lm_types)
            Dinv = {}
            for t in lm_types:
                if partial[t]:
                    mu = aux["marg"][t][:, None, None]
                    Dinv[t] = inv_small(Dfull[t] * mu
                                        + eyes[t] * (1.0 - mu))
                else:
                    Dinv[t] = inv_small(Dfull[t])

            # B blocks: one per (edge type, pose slot)
            B = {}
            for name, pslots, ls in obs_specs:
                Js = p.edge_jacs(lin, name)
                W = p.edge_weights(lin, name)
                B[name] = {s: jnp.einsum("erd,ers,esf->edf", Js[s], W,
                                         Js[ls], precision=hi)
                           for s in pslots}

            ball = p.split_tangent(lin.b)
            bl = {t: ball[t] for t in lm_types}
            y = {t: jnp.einsum("nij,nj->ni", Dinv[t], bl[t], precision=hi)
                 for t in lm_types}

            # reduced rhs over the retained system
            bschur = {}
            for t in cg_types:
                if t in lm_types:          # partial type: retained rows
                    bschur[t] = ball[t] * (1.0 - aux["marg"][t][:, None])
                else:
                    bschur[t] = ball[t]
            for name, pslots, ls in obs_specs:
                et = p.edge_types[name]
                lt = et.vertex_types[ls].name
                vidx = data.edges[name].vidx
                el = aux["elim"][name][:, None]
                yl = y[lt][vidx[:, ls]]
                for s in pslots:
                    ts = et.vertex_types[s].name
                    bschur[ts] = bschur[ts].at[vidx[:, s]].add(
                        -el * jnp.einsum("edl,el->ed", B[name][s], yl,
                                         precision=hi))

            # preconditioner
            diag_blocks = damped_diag(data, lin, lam, cg_types)
            for t in cg_types:
                if t in lm_types:
                    mu = aux["marg"][t][:, None, None]
                    diag_blocks[t] = (diag_blocks[t] * (1.0 - mu)
                                      + eyes[t] * mu)
            sdiag = dict(diag_blocks)
            if use_schur_precond:
                for name, pslots, ls in obs_specs:
                    et = p.edge_types[name]
                    lt = et.vertex_types[ls].name
                    vidx = data.edges[name].vidx
                    el = aux["elim"][name][:, None, None]
                    Dl = Dinv[lt][vidx[:, ls]]
                    for s in pslots:
                        ts = et.vertex_types[s].name
                        C = jnp.einsum("edl,elm,efm->edf", B[name][s], Dl,
                                       B[name][s], precision=hi)
                        sdiag[ts] = sdiag[ts].at[vidx[:, s]].add(-el * C)
            minv = {t: inv_small(sdiag[t]) for t in cg_types}

            def S_vec(vb):
                out = {t: jnp.einsum("nij,nj->ni", diag_blocks[t], vb[t],
                                     precision=mv)
                       for t in cg_types}
                # pose-only edges: all slot-pair couplings
                for name in pose_edge_types:
                    et = p.edge_types[name]
                    vidx = data.edges[name].vidx
                    Js = p.edge_jacs(lin, name)
                    W = p.edge_weights(lin, name)
                    k = len(Js)
                    for i in range(k):
                        ti = et.vertex_types[i].name
                        acc = None
                        for j in range(k):
                            if i == j:
                                continue
                            tj = et.vertex_types[j].name
                            h = jnp.einsum(
                                "erd,ers,esf,ef->ed", Js[i], W, Js[j],
                                vb[tj][vidx[:, j]], precision=mv)
                            acc = h if acc is None else acc + h
                        if acc is not None:
                            out[ti] = out[ti].at[vidx[:, i]].add(acc)
                # observation edges
                for name, pslots, ls in obs_specs:
                    et = p.edge_types[name]
                    lt = et.vertex_types[ls].name
                    vidx = data.edges[name].vidx
                    el = aux["elim"][name][:, None]
                    Js = p.edge_jacs(lin, name)
                    W = p.edge_weights(lin, name)
                    # (a) direct Hpp couplings between pose-slot pairs
                    #     (ALL edges — these blocks live in the retained
                    #     system whether or not the landmark is eliminated)
                    for i in pslots:
                        ti = et.vertex_types[i].name
                        acc = None
                        for j in pslots:
                            if i == j:
                                continue
                            tj = et.vertex_types[j].name
                            h = jnp.einsum(
                                "erd,ers,esf,ef->ed", Js[i], W, Js[j],
                                vb[tj][vidx[:, j]], precision=mv)
                            acc = h if acc is None else acc + h
                        if acc is not None:
                            out[ti] = out[ti].at[vidx[:, i]].add(acc)
                    # (b) retained-landmark couplings (non-eliminated rows)
                    if lt in cg_types:
                        vl = vb[lt][vidx[:, ls]]
                        accl = None
                        for s in pslots:
                            ts = et.vertex_types[s].name
                            out[ts] = out[ts].at[vidx[:, s]].add(
                                (1.0 - el) * jnp.einsum(
                                    "edl,el->ed", B[name][s], vl,
                                    precision=mv))
                            hl = jnp.einsum("edl,ed->el", B[name][s],
                                            vb[ts][vidx[:, s]],
                                            precision=mv)
                            accl = hl if accl is None else accl + hl
                        if accl is not None:
                            out[lt] = out[lt].at[vidx[:, ls]].add(
                                (1.0 - el) * accl)
                # (c) Schur term − Σ_s B_s Dinv (Σ_s' B_s'ᵀ v) over
                #     eliminated rows
                tl = {t: jnp.zeros_like(y[t]) for t in lm_types}
                for name, pslots, ls in obs_specs:
                    et = p.edge_types[name]
                    lt = et.vertex_types[ls].name
                    vidx = data.edges[name].vidx
                    el = aux["elim"][name][:, None]
                    acc = None
                    for s in pslots:
                        ts = et.vertex_types[s].name
                        h = jnp.einsum("edl,ed->el", B[name][s],
                                       vb[ts][vidx[:, s]], precision=mv)
                        acc = h if acc is None else acc + h
                    if acc is not None:       # unary landmark priors: none
                        tl[lt] = tl[lt].at[vidx[:, ls]].add(el * acc)
                s_ = {t: jnp.einsum("nij,nj->ni", Dinv[t], tl[t],
                                    precision=mv)
                      for t in lm_types}
                for name, pslots, ls in obs_specs:
                    et = p.edge_types[name]
                    lt = et.vertex_types[ls].name
                    vidx = data.edges[name].vidx
                    el = aux["elim"][name][:, None]
                    sl = s_[lt][vidx[:, ls]]
                    for s in pslots:
                        ts = et.vertex_types[s].name
                        out[ts] = out[ts].at[vidx[:, s]].add(
                            -el * jnp.einsum("edl,el->ed", B[name][s], sl,
                                             precision=mv))
                return out

            def precond(rb):
                return {t: jnp.einsum("nij,nj->ni", minv[t], rb[t])
                        for t in cg_types}

            x0 = tmap(jnp.zeros_like, bschur)
            r0 = bschur
            z0 = precond(r0)
            rz0 = pdot(r0, z0)
            rhs2 = pdot(bschur, bschur)
            thresh = tol * tol * rhs2
            if carry is not None:
                thresh = jnp.maximum(thresh, carry.astype(thresh.dtype))

            def cond(c):
                return jnp.logical_and(c[5] < max_iter,
                                       pdot(c[1], c[1]) > thresh)

            def body(c):
                x, r, z, pv, rz, it = c
                Ap = S_vec(pv)
                alpha = rz / pdot(pv, Ap)
                x = tmap(lambda a, b_: a + alpha * b_, x, pv)
                r = tmap(lambda a, b_: a - alpha * b_, r, Ap)
                z = precond(r)
                rz2 = pdot(r, z)
                pv = tmap(lambda a, b_: a + (rz2 / rz) * b_, z, pv)
                return (x, r, z, pv, rz2, it + 1)

            dxp, r_f, _, _, _, cg_iters = jax.lax.while_loop(
                cond, body, (x0, r0, z0, z0, rz0, 0))

            # back-substitute eliminated rows: dxl = Dinv (bl − Σ B_sᵀ dxp)
            wl = {t: jnp.zeros_like(bl[t]) for t in lm_types}
            for name, pslots, ls in obs_specs:
                et = p.edge_types[name]
                lt = et.vertex_types[ls].name
                vidx = data.edges[name].vidx
                el = aux["elim"][name][:, None]
                acc = None
                for s in pslots:
                    ts = et.vertex_types[s].name
                    h = jnp.einsum("edl,ed->el", B[name][s],
                                   dxp[ts][vidx[:, s]], precision=hi)
                    acc = h if acc is None else acc + h
                if acc is not None:
                    wl[lt] = wl[lt].at[vidx[:, ls]].add(el * acc)
            dxl = {}
            for t in full_lm:
                dxl[t] = jnp.einsum("nij,nj->ni", Dinv[t], bl[t] - wl[t],
                                    precision=hi)
            out = dict(dxl)
            for t in cg_types:
                if t in lm_types:      # partial: merge retained + eliminated
                    mu = aux["marg"][t][:, None]
                    out[t] = (dxp[t] * (1.0 - mu)
                              + mu * jnp.einsum("nij,nj->ni", Dinv[t],
                                                bl[t] - wl[t],
                                                precision=hi))
                else:
                    out[t] = dxp[t]

            res2 = pdot(r_f, r_f)
            stats = {"cg_iterations": cg_iters, "residual2": res2,
                     "rhs2": rhs2, "carry": 0.5 * res2}
            return p.join_tangent(out), stats

        def solve(data, lin, lam, aux=()):
            return solve_full(data, lin, lam, aux)[0]

        def solve_state(data, lin, lam, aux, state):
            dx, st = solve_full(data, lin, lam, aux, carry=state)
            return dx, st["carry"], st

        self._solve_full = solve_full
        self._solve_full_jit = jax.jit(solve_full)
        self._solve_fn = solve
        self._solve_jit = jax.jit(solve)
        if self.absolute_tolerance:
            self._solve_state_fn = solve_state
            self._solve_state_jit = jax.jit(solve_state)
            self.state0 = jnp.asarray(-1.0, dtype)
        self._host_state = None
        return self

    def solve(self, data, lin, lam=0.0):
        if self.absolute_tolerance:
            if self._host_state is None:
                self._host_state = self.state0
            dx, self._host_state, _ = self._solve_state_jit(
                data, lin, lam, self.aux, self._host_state)
            return dx
        return self._solve_jit(data, lin, lam, self.aux)
