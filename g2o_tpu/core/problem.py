"""Compiled structure-of-arrays problem + batched linearization/assembly.

This module is the array-program replacement for the reference's per-edge
virtual-dispatch pipeline:

* ``SparseOptimizer::computeActiveErrors`` (``g2o/core/sparse_optimizer.cpp:63``)
  → one vmapped residual evaluation per *edge type batch*;
* ``BlockSolver::buildSystem`` (``g2o/core/block_solver.hpp:463``) — per-edge
  ``linearizeOplus`` + ``constructQuadraticForm`` under per-vertex mutexes —
  → batched ``jacfwd`` Jacobians and ``segment-sum`` scatter-adds into a flat
  tangent-space gradient and per-vertex diagonal blocks;
* the numeric-diff fallback (``g2o/core/base_binary_edge.hpp:199-240``) →
  exact forward-mode autodiff through each vertex's ``oplus``.

The Hessian is never materialised as a sparse pointer structure: solvers use
either (a) batched Hessian-vector products Σ Jᵀ(W(Jv)) (for PCG/dogleg), or
(b) a dense scatter-assembled H (small problems), or (c) the Schur-complement
path over landmark blocks (``g2o_tpu/core/solvers/schur.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from g2o_tpu.core.types import EdgeType, VertexType
from g2o_tpu.ops import robust as robust_mod


class EdgeBatchData(NamedTuple):
    """Arrays for one edge-type batch (pytree leaf bundle)."""

    vidx: jax.Array      # (E, k) int32 — per-slot index into that slot's vertex-type arrays
    meas: jax.Array      # (E, m)
    info: jax.Array      # (E, r, r)
    kernel: jax.Array    # (E,) int32 robust-kernel id
    delta: jax.Array     # (E,) robust-kernel width
    active: jax.Array    # (E,) bool — the fork's per-edge isActive flag
    param: jax.Array     # (E, p)


class ProblemData(NamedTuple):
    """Non-estimate arrays of a compiled problem (pytree)."""

    edges: dict          # name -> EdgeBatchData
    fixed: dict          # vertex-type name -> (N_t,) bool
    offsets: dict        # vertex-type name -> (N_t,) int32 flat tangent offset
    fixed_flat: jax.Array  # (T,) 1.0 where the tangent slot belongs to a fixed vertex
    plans: dict = {}     # edge name -> {"segp": (S_used,) int32} bucket arrays


class BucketedEdgeSpec(NamedTuple):
    """Static shape info of a compile-time landmark-bucketed edge batch
    (the index arrays travel in ``ProblemData.plans``; see
    ``g2o_tpu/ops/bucketed.py``).  Rows ``[0, n_rows)`` of the batch are
    grouped into ``len(degrees)`` slabs — slab ``b`` holds ``counts[b]``
    landmarks × ``degrees[b]`` padded rows; inactive padding rows carry
    W == 0 so dense per-slab reductions equal the scatter-add."""

    pose_slot: int
    lm_slot: int
    counts: tuple
    degrees: tuple
    n_rows: int          # sum(counts[b] * degrees[b]) — slab-covered prefix
    # True when the landmark type's internal vertex order IS the bucket
    # segment order (build_problem reorders it when a single edge type
    # buckets the type): ``segp == arange``, so every segment gather /
    # scatter in linearize and the solvers becomes a static slice —
    # and a 150k-row permutation op is a full pass over the data
    seg_identity: bool = False


class LinearizedSystem(NamedTuple):
    """Output of one linearization — everything iterative solvers need."""

    jacs: dict           # name -> tuple of (E, r, d_i) per slot (fixed
    # slots zeroed); BUCKETED batches store DIMS-MAJOR (r, d_i, E) leaves
    # (use Problem.edge_jacs for a row-major view)
    weights: dict        # name -> (E, r, r) = rho' * active * Omega
    # (bucketed: (r, r, E); Problem.edge_weights)
    errors: dict         # name -> (E, r)  (bucketed: (r, E))
    b: jax.Array         # (T,) = -J^T W e   (solve H dx = b)
    diag: dict           # vertex-type name -> (N_t, D, D) Hessian diagonal blocks
    chi2_robust: jax.Array
    chi2: jax.Array
    # per-edge precomputes for compile-time bucketed (BA) batches, shared
    # with the implicit Schur solver so it never re-derives them per
    # λ-trial: {"Bt": (dp, dl, E) dims-major Jpᵀ·W·Jl off-diagonal blocks,
    # "Hll_bucket"/"bl_bucket": landmark diag blocks / gradient rows in
    # BUCKET order (before the scatter back to natural order)}
    extras: dict = {}


def _np_dtype(dtype):
    """jnp dtype spec -> numpy dtype (host staging before device_put)."""
    return np.dtype(jnp.dtype(dtype))


def _seg_ids(offsets_t, vidx_col, d):
    """(E,) vertex indices -> (E, d) flat tangent indices."""
    base = offsets_t[vidx_col]
    return base[:, None] + jnp.arange(d, dtype=base.dtype)[None, :]


class Problem:
    """Immutable compiled problem. Estimates flow through as pytree args."""

    def __init__(self, vertex_types, counts, edge_types, data: ProblemData,
                 estimates: dict, marginalized: dict, vid_index: dict,
                 type_bases: dict, total_dim: int, dtype,
                 bucket_specs=None, assembly_onehot_max: int = 8192,
                 uniform_kernel=None, state_dtype=None,
                 assembly_precision: str = "highest",
                 n_active_edges=None):
        # precision of the row-major H/b assembly einsums.  "highest"
        # (default) = exact f32 — REQUIRED whenever the blocks feed a
        # Cholesky factorization (direct solvers, chunk preconditioners
        # near convergence) and for reaching reference chi2 fixed points
        # with f32 arithmetic.  "default" lets XLA pick the fast matmul
        # mode — TF32 on the GPU's tensor cores (~1e-3 relative) — safe
        # for loose-tolerance iterative phases whose own carry/tol floor
        # dominates.
        if assembly_precision not in ("highest", "default"):
            raise ValueError(
                f"unknown assembly_precision {assembly_precision!r}")
        self.assembly_precision = assembly_precision
        self.bucket_specs: dict = bucket_specs or {}
        # edge name -> static robust-kernel id when every edge of the batch
        # shares one kernel (the usual case), else None.  A batched
        # ``vmap(lax.switch)`` evaluates ALL kernel branches and selects;
        # the static dispatch evaluates one.
        self.uniform_kernel: dict = uniform_kernel or {}
        self.assembly_onehot_max = int(assembly_onehot_max)
        # true (active, unpadded) edge count, computed host-side at build
        # — vidx.shape[0] includes padding/bucket/capacity rows and would
        # misreport the verbose 'edges=' line and BatchStatistics
        self.n_active_edges = n_active_edges
        self.vertex_types: dict[str, VertexType] = vertex_types
        self.counts: dict[str, int] = counts
        self.edge_types: dict[str, EdgeType] = edge_types
        self.data = data
        self.estimates = estimates            # dict name -> (N_t, rep)
        self.marginalized = marginalized      # dict name -> np.bool_ (N_t,)  (static)
        self.vid_index = vid_index            # vid -> (type name, local idx)
        self.type_bases = type_bases          # name -> flat tangent base offset
        self.total_dim = int(total_dim)
        self.dtype = dtype
        # MIXED-PRECISION trajectory accuracy: the whole linearization —
        # estimates, measurements, residuals, Jacobians, robust weights,
        # H/b assembly, chi2, oplus — runs at ``state_dtype`` (f64); the
        # LinearizedSystem leaves are rounded to ``dtype`` (f32) once at
        # the end, so the SOLVERS stay on the fast narrow path.  f32 pose
        # coordinates quantize at ~3e-6 relative and f32 b-assembly leaves
        # absolute summation noise; both floor manhattan3500 above the
        # reference gn_var fixed point (9134+ vs 9116.756).  Rounding the
        # wide-assembled b/J is only a RELATIVE error, so GN + a direct
        # f32 solve reaches 9116.76 exactly (measured, round 4).  Solve
        # errors perturb the convergence rate, not the fixed point.
        self.state_dtype = state_dtype if state_dtype is not None else dtype
        self._edge_jac_fns = {
            name: self._make_jac_fn(et) for name, et in edge_types.items()
        }
        self._edge_res_jac_fns = {
            name: self._make_res_jac_fn(et)
            for name, et in edge_types.items()
        }
        # jitted entry points (data passed as args — nothing baked as constants)
        self.chi2_jit = jax.jit(self.chi2_fn)
        self.linearize_jit = jax.jit(self.linearize_fn)
        self.apply_jit = jax.jit(self.apply_update_fn)
        self.hvp_jit = jax.jit(self.hvp_fn)
        self.dense_h_jit = jax.jit(self.dense_hessian_fn)

    # ------------------------------------------------------------------ #
    # host-side helpers
    # ------------------------------------------------------------------ #

    @property
    def num_edges(self):
        if self.n_active_edges is not None:
            return self.n_active_edges
        return sum(int(b.vidx.shape[0]) for b in self.data.edges.values())

    def get_estimate(self, vid):
        t, i = self.vid_index[vid]
        return np.asarray(self.estimates[t][i])

    def set_estimates(self, estimates):
        self.estimates = estimates

    def estimates_by_vid(self):
        out = {}
        host = {t: np.asarray(e) for t, e in self.estimates.items()}
        for vid, (t, i) in self.vid_index.items():
            out[vid] = host[t][i]
        return out

    def _make_jac_fn(self, et: EdgeType) -> Callable:
        if et.jacobian is not None:
            return et.jacobian
        vts = tuple(et.vertex_types)
        # reverse mode when the residual is SHORTER than the total tangent
        # perturbation: r VJP passes beat Σd JVP passes (BAL reprojection:
        # 2 vs 12; SE3 pose graph: 6 vs 12).  Both are exact autodiff —
        # only the floating-point summation order differs (~1 ulp).
        # G2O_TPU_JACREV=0 forces forward mode (escape hatch).
        import os as _os
        use_rev = (et.residual_dim < sum(vt.tangent_dim for vt in vts)
                   and _os.environ.get("G2O_TPU_JACREV", "1") != "0")
        jac_of = jax.jacrev if use_rev else jax.jacfwd

        def jac_one(states, meas, par):
            def f(*deltas):
                news = tuple(
                    vt.oplus(x, d) for vt, x, d in zip(vts, states, deltas)
                )
                return et.residual(news, meas, par)

            zeros = tuple(
                jnp.zeros((vt.tangent_dim,), dtype=states[0].dtype) for vt in vts
            )
            return jac_of(f, argnums=tuple(range(len(vts))))(*zeros)

        return jac_one

    def _make_res_jac_fn(self, et: EdgeType) -> Optional[Callable]:
        """Per-edge FUSED (residual, Jacobian) in one primal pass.

        Reverse mode shares the forward evaluation between the error and
        its pullback, eliminating the duplicate residual computation the
        separate ``_edge_residuals`` + ``jacfwd`` pipeline pays (the
        reference pays it too: ``computeError`` then ``linearizeOplus``,
        ``g2o/core/block_solver.hpp:463-476``).  Only built when reverse
        mode is the cheaper direction (``r < Σd``) and the edge has no
        analytic Jacobian."""
        if et.jacobian is not None:
            return None
        import os as _os
        if _os.environ.get("G2O_TPU_JACREV", "1") == "0":
            return None
        vts = tuple(et.vertex_types)
        r = et.residual_dim
        if r >= sum(vt.tangent_dim for vt in vts):
            return None

        def res_jac_one(states, meas, par):
            def f(*deltas):
                news = tuple(
                    vt.oplus(x, d) for vt, x, d in zip(vts, states, deltas)
                )
                return et.residual(news, meas, par)

            zeros = tuple(
                jnp.zeros((vt.tangent_dim,), dtype=states[0].dtype)
                for vt in vts
            )
            e, pull = jax.vjp(f, *zeros)
            rows = jax.vmap(pull)(jnp.eye(r, dtype=e.dtype))
            return e, tuple(rows)

        return res_jac_one

    # ------------------------------------------------------------------ #
    # pure functions (jitted in __init__)
    # ------------------------------------------------------------------ #

    def _edge_residuals(self, et: EdgeType, batch: EdgeBatchData, estimates,
                        name: str | None = None, plans: dict | None = None):
        """Per-edge vertex states + residuals.

        For compile-time landmark-bucketed batches the landmark states are
        produced by ONE (S_used,)-row gather + per-slab broadcasts and the
        camera states by an exact one-hot matmul gather — bit-identical to
        the (E,)-row gathers they replace (padding rows replicate their
        slab segment's first row, see :func:`build_problem`), without an
        indexed gather over the full observation axis."""
        spec = self.bucket_specs.get(name) if name is not None else None
        states = []
        for s, vt in enumerate(et.vertex_types):
            t = vt.name
            if spec is not None and s == spec.lm_slot and plans is not None:
                n_used = sum(spec.counts)
                if spec.seg_identity:
                    # bucket order == vertex order: a static slice
                    est_used = estimates[t][:n_used]
                else:
                    est_used = estimates[t][plans[name]["segp"]]
                rows, off = [], 0
                for nseg, dg in zip(spec.counts, spec.degrees):
                    v = est_used[off:off + nseg]
                    # slabs are DEGREE-MAJOR (segment axis minormost)
                    rows.append(jnp.broadcast_to(
                        v[None], (dg, nseg) + v.shape[1:]).reshape(
                        (nseg * dg,) + v.shape[1:]))
                    off += nseg
                tail = batch.vidx.shape[0] - spec.n_rows
                if tail:
                    # trailing pad_edges_to_multiple rows replicate batch
                    # row 0 = first segment's first row
                    rows.append(jnp.broadcast_to(
                        est_used[:1], (tail,) + est_used.shape[1:]))
                states.append(jnp.concatenate(rows, axis=0))
            elif (spec is not None and s == spec.pose_slot
                    and 0 < self.counts[t] <= self.assembly_onehot_max):
                from g2o_tpu.ops.onehot import onehot_gather

                states.append(onehot_gather(batch.vidx[:, s], estimates[t]))
            else:
                states.append(estimates[t][batch.vidx[:, s]])
        states = tuple(states)
        res = jax.vmap(lambda *a: et.residual(a[:-2], a[-2], a[-1]))(
            *states, batch.meas, batch.param
        )
        return states, res

    def _states_t(self, et: EdgeType, batch: EdgeBatchData, estimates,
                  name: str, plans: dict, spec: "BucketedEdgeSpec"):
        """DIMS-MAJOR per-edge vertex states — tuple of ``(rep, E)`` arrays
        (edge axis minormost) for compile-time bucketed batches.

        The twin of :meth:`_edge_residuals`'s state production, emitting the
        transposed layout at SOURCE so the whole residual/Jacobian chain and
        the slab assembly run with the edge axis on vector lanes — no
        ``(E, r, d) -> (r, d, E)`` relayout copies of the Jacobians (the
        round-2 assembly paid one per slot per linearize)."""
        from g2o_tpu.ops.onehot import onehot_gather_t

        states_t = []
        for s, vt in enumerate(et.vertex_types):
            t = vt.name
            if s == spec.lm_slot:
                n_used = sum(spec.counts)
                if spec.seg_identity:
                    est_used = estimates[t][:n_used]
                else:
                    est_used = estimates[t][plans[name]["segp"]]
                est_t = est_used.T                       # (rep, S_used)
                rows, off = [], 0
                for nseg, dg in zip(spec.counts, spec.degrees):
                    v = est_t[:, off:off + nseg]
                    # degree-major slabs: row = deg * nseg + seg (matches
                    # the row-major producer in _edge_residuals)
                    rows.append(jnp.broadcast_to(
                        v[:, None, :], (v.shape[0], dg, nseg)).reshape(
                        v.shape[0], nseg * dg))
                    off += nseg
                tail = batch.vidx.shape[0] - spec.n_rows
                if tail:
                    rows.append(jnp.broadcast_to(
                        est_t[:, :1], (est_t.shape[0], tail)))
                states_t.append(jnp.concatenate(rows, axis=1))
            elif (s == spec.pose_slot
                    and 0 < self.counts[t] <= self.assembly_onehot_max):
                states_t.append(
                    onehot_gather_t(batch.vidx[:, s], estimates[t]))
            else:
                states_t.append(estimates[t][batch.vidx[:, s]].T)
        return tuple(states_t)

    def _robustify(self, name, batch, e2):
        """(E, 3) robustification — static single-kernel dispatch when the
        batch's kernel id is compile-time uniform (see ``uniform_kernel``)."""
        uk = self.uniform_kernel.get(name)
        if uk is not None:
            return robust_mod.robustify(uk, e2, batch.delta)
        return robust_mod.robustify_batch(batch.kernel, e2, batch.delta)

    # ------------------------------------------------------------------ #
    # layout accessors: bucketed batches store DIMS-MAJOR Jacobian leaves
    # ``(r, d, E)`` (weights ``(r, s, E)``, errors ``(r, E)``) in the
    # LinearizedSystem — while-carried row-major compat transposes are
    # small-minor-dim relayout copies that XLA's while-loop DCE does not
    # remove.  Consumers that need
    # row-major call these and pay the relayout only when actually used.
    # ------------------------------------------------------------------ #

    def edge_jacs(self, lin, name):
        """Row-major ``(E, r, d_s)`` Jacobian slot tuple for edge batch
        ``name`` (lazy transpose of dims-major bucketed leaves)."""
        Js = lin.jacs[name]
        if not isinstance(Js, (tuple, list)):
            Js = (Js,)
        if name in self.bucket_specs:
            return tuple(J.transpose(2, 0, 1) for J in Js)
        return Js

    def edge_weights(self, lin, name):
        """Row-major ``(E, r, r)`` robust information for ``name``."""
        W = lin.weights[name]
        return W.transpose(2, 0, 1) if name in self.bucket_specs else W

    def edge_errors(self, lin, name):
        """Row-major ``(E, r)`` residuals for ``name``."""
        e = lin.errors[name]
        return e.T if name in self.bucket_specs else e

    def split_tangent(self, v):
        """Flat ``(T,)`` tangent vector → ``{type: (N_t, d_t)}`` blocks.

        Per-type ranges are contiguous (``offsets[t] = base_t + i*d_t``), so
        this lowers to static slices + reshapes — never a gather.  Solvers
        should iterate in this layout: ``v[idx]`` with ``(E, k*d)`` element
        indices moves k*d× more index traffic than the row-level
        ``vb[t][vidx]`` gather."""
        out = {}
        for t, vt in self.vertex_types.items():
            base, n, d = self.type_bases[t], self.counts[t], vt.tangent_dim
            out[t] = v[base:base + n * d].reshape(n, d)
        return out

    def join_tangent(self, blocks) -> jax.Array:
        """Inverse of :meth:`split_tangent` (contiguous concat, no scatter)."""
        return jnp.concatenate(
            [blocks[t].reshape(-1) for t in self.vertex_types])

    def tree_dot(self, a, b):
        """Dot product over block-layout tangent vectors.

        Written as multiply+sum (elementwise work, exact f32) rather than
        ``vdot``: at DEFAULT precision a dot may run in a reduced-precision
        matmul mode (TF32 on the GPU), and ~1e-3-relative noise in the CG
        alpha/beta/residual scalars stalls convergence (it floored the
        manhattan f32 chi2 well above the exact-f32 result)."""
        return sum(jnp.sum(a[t] * b[t]) for t in self.vertex_types)

    def hvp_blocks_fn(self, data: ProblemData, lin: LinearizedSystem, vb):
        """Block-layout matrix-free H·v = Σ_edges Jᵀ(W(J v)).

        One ROW-level gather and one row-level scatter-add per edge type
        (when all slots share a vertex type), plus a handful of batched
        einsums — the latency-optimal formulation for ``lax.while_loop``
        CG bodies.  Replaces the reference's explicit SparseBlockMatrix
        multiply (``sparse_block_matrix.hpp``)."""
        out = {t: jnp.zeros_like(vb[t]) for t in self.vertex_types}
        for name, et in self.edge_types.items():
            batch = data.edges[name]
            Js = self.edge_jacs(lin, name)
            W = self.edge_weights(lin, name)
            tnames = [vt.name for vt in et.vertex_types]
            if len(set(tnames)) == 1:
                t = tnames[0]
                rows = vb[t][batch.vidx]                      # (E, k, d)
                y = None
                for s, J in enumerate(Js):
                    ys = jnp.einsum("erd,ed->er", J, rows[:, s])
                    y = ys if y is None else y + ys
                z = jnp.einsum("ers,es->er", W, y)
                contrib = jnp.stack(
                    [jnp.einsum("erd,er->ed", J, z) for J in Js], axis=1)
                out[t] = out[t].at[batch.vidx].add(contrib)
            else:
                y = None
                for s, (J, vt) in enumerate(zip(Js, et.vertex_types)):
                    ys = jnp.einsum("erd,ed->er", J,
                                    vb[vt.name][batch.vidx[:, s]])
                    y = ys if y is None else y + ys
                z = jnp.einsum("ers,es->er", W, y)
                for s, (J, vt) in enumerate(zip(Js, et.vertex_types)):
                    out[vt.name] = out[vt.name].at[batch.vidx[:, s]].add(
                        jnp.einsum("erd,er->ed", J, z))
        return out

    def chi2_fn(self, data: ProblemData, estimates):
        """(robust chi2, plain chi2) — reference ``activeRobustChi2`` /
        ``activeChi2`` (``g2o/core/sparse_optimizer.cpp:94-116``)."""
        total_r = jnp.zeros((), dtype=self.state_dtype)
        total_p = jnp.zeros((), dtype=self.state_dtype)
        for name, et in self.edge_types.items():
            batch = data.edges[name]
            _, e = self._edge_residuals(et, batch, estimates, name, data.plans)
            e2 = jnp.einsum("er,ers,es->e", e, batch.info, e,
                            precision=jax.lax.Precision.HIGHEST)
            rho = self._robustify(name, batch, e2)
            act = batch.active.astype(self.state_dtype)
            total_r = total_r + jnp.sum(rho[:, 0] * act)
            total_p = total_p + jnp.sum(e2 * act)
        return total_r, total_p

    def edge_chi2_fn(self, data: ProblemData, estimates):
        """Per-edge robust chi2 — ``{etype: (E,)}`` arrays (inactive/padded
        rows are zero).  The per-edge analogue of the reference's
        ``Edge::chi2()`` after ``robustifyError`` as used by tools ranking
        or selecting edges by error (``examples/g2o_unfold/g2o-unfold.cpp:66-79``,
        ``tools.cpp`` gnudump)."""
        out = {}
        for name, et in self.edge_types.items():
            batch = data.edges[name]
            _, e = self._edge_residuals(et, batch, estimates, name, data.plans)
            e2 = jnp.einsum("er,ers,es->e", e, batch.info, e,
                            precision=jax.lax.Precision.HIGHEST)
            rho = self._robustify(name, batch, e2)
            out[name] = rho[:, 0] * batch.active.astype(self.dtype)
        return out

    def linearize_fn(self, data: ProblemData, estimates) -> LinearizedSystem:
        # MIXED mode (state_dtype wider than dtype): the WHOLE linearization
        # — residual, Jacobians, robust weights, H/b assembly — runs WIDE,
        # and the LinearizedSystem leaves are rounded to the solver dtype
        # ONCE at the end.  Rounding the assembled b is a RELATIVE error
        # (vanishes with |b|), so the GN/LM fixed point is the wide-dtype
        # one; assembling b in f32 instead leaves ABSOLUTE summation noise
        # that floors manhattan3500 at chi2 ~9134 where the reference
        # gn_var fixed point is 9116.756 (measured, round 4).  Solvers see
        # only narrow leaves and stay on the fast f32 path.
        mixed = self.state_dtype != self.dtype
        b_blocks = {
            t: jnp.zeros((self.counts[t], vt.tangent_dim),
                         dtype=self.state_dtype)
            for t, vt in self.vertex_types.items()
        }
        diag = {
            t: jnp.zeros((self.counts[t], vt.tangent_dim, vt.tangent_dim),
                         dtype=self.state_dtype)
            for t, vt in self.vertex_types.items()
        }
        jacs, weights, errors, extras = {}, {}, {}, {}
        chi2_r = jnp.zeros((), dtype=self.state_dtype)
        chi2_p = jnp.zeros((), dtype=self.state_dtype)

        for name, et in self.edge_types.items():
            batch = data.edges[name]
            spec = self.bucket_specs.get(name)
            if spec is not None:
                # ---- DIMS-MAJOR linearization at SOURCE (bucketed/BA) --- #
                # States, residual, Jacobians, robust weights and the slab
                # assembly all run with the edge axis minormost (on vector
                # lanes): no (E, r, d) -> (r, d, E) relayout copies at all.
                # Reverse-mode ``vjp`` shares ONE primal pass between the
                # residual and its r pullbacks (vs Σd JVPs + a separate
                # residual evaluation).  ``meas_t``/``info_t`` are
                # precomputed host-side constants (data.plans).
                plan = data.plans.get(name) or {}
                states_t = self._states_t(et, batch, estimates, name,
                                          data.plans, spec)
                meas_t = plan.get("meas_t")
                if meas_t is None:
                    meas_t = batch.meas.T
                info_t = plan.get("info_t")
                if info_t is None:
                    info_t = batch.info.transpose(1, 2, 0)
                param_t = batch.param.T
                rj = self._edge_res_jac_fns[name]
                if rj is not None:
                    e_t, Jt = jax.vmap(rj, in_axes=-1, out_axes=-1)(
                        states_t, meas_t, param_t)
                else:
                    e_t = jax.vmap(
                        lambda *a: et.residual(a[:-2], a[-2], a[-1]),
                        in_axes=-1, out_axes=-1)(*states_t, meas_t, param_t)
                    Jt = jax.vmap(self._edge_jac_fns[name], in_axes=-1,
                                  out_axes=-1)(states_t, meas_t, param_t)
                if not isinstance(Jt, (tuple, list)):
                    Jt = (Jt,)
                fm_t = plan.get("free_mask_t")
                if fm_t is not None:
                    Jt = tuple(J * fm_t[s][None, None, :]
                               for s, J in enumerate(Jt))
                elif plan.get("free_mask") is not None:
                    fm = plan["free_mask"]
                    Jt = tuple(J * fm[:, s][None, None, :]
                               for s, J in enumerate(Jt))
                else:
                    Jt = tuple(
                        J * (1.0 - data.fixed[vt.name][batch.vidx[:, s]]
                             .astype(self.dtype))[None, None, :]
                        for s, (J, vt) in enumerate(
                            zip(Jt, et.vertex_types)))
                # e2 = eᵀΩe as exact lane-parallel multiply+sum (the
                # E-major einsum at HIGHEST is its matmul twin)
                e2 = jnp.sum(e_t[:, None, :] * info_t * e_t[None, :, :],
                             axis=(0, 1))
                rho = self._robustify(name, batch, e2)
                act_s = batch.active.astype(self.state_dtype)
                chi2_r = chi2_r + jnp.sum(rho[:, 0] * act_s)
                chi2_p = chi2_p + jnp.sum(e2 * act_s)
                e_c = e_t
                Wt = info_t * (rho[:, 1] * act_s)[None, None, :]
                Wet = jnp.sum(Wt * e_c[None, :, :], axis=1)      # (r, E)

                segp = data.plans[name]["segp"]
                nb = spec.n_rows
                WJ_ts = []
                for s, vt in enumerate(et.vertex_types):
                    t = vt.name
                    d = vt.tangent_dim
                    # WJ[r,f,e] = Σ_s W[r,s,e] J[s,f,e]
                    WJ_t = jnp.sum(Wt[:, :, None, :] * Jt[s][None, :, :, :],
                                   axis=1)
                    WJ_ts.append(WJ_t)
                    # Hss[d,f,e] = Σ_r J[r,d,e] WJ[r,f,e]
                    Hss_t = jnp.sum(Jt[s][:, :, None, :] * WJ_t[:, None, :, :],
                                    axis=0).reshape(d * d, -1)   # (dd, E)
                    brows_t = -jnp.sum(Jt[s] * Wet[:, None, :], axis=0)
                    if s == spec.lm_slot:
                        def slab_sum(z):
                            # (dd, deg, n) view keeps the large segment
                            # axis on lanes (degree-major slab layout)
                            out, off = [], 0
                            for n, dg in zip(spec.counts, spec.degrees):
                                blk = z[:, off:off + n * dg]
                                out.append(blk.reshape(
                                    z.shape[0], dg, n).sum(axis=1))
                                off += n * dg
                            return jnp.concatenate(out, axis=1)
                        bl_t = slab_sum(brows_t[:, :nb])         # (d, S_used)
                        Hll_t = slab_sum(Hss_t[:, :nb])          # (dd, S_used)
                        bl_bucket = bl_t.T                       # (S_used, d)
                        Hll_bucket = Hll_t.T.reshape(-1, d, d)
                        extras.setdefault(name, {})
                        extras[name]["bl_bucket"] = bl_bucket
                        extras[name]["Hll_bucket"] = Hll_bucket
                        # dims-major twins: the implicit Schur solver's
                        # bucket-order landmark system consumes these
                        # directly (no (S, d, d) <-> (d, d, S) relayouts
                        # per λ-trial)
                        extras[name]["bl_bucket_t"] = bl_t
                        extras[name]["Hll_bucket_t"] = Hll_t
                        if spec.seg_identity:
                            ns = bl_bucket.shape[0]
                            b_blocks[t] = b_blocks[t].at[:ns].add(bl_bucket)
                            diag[t] = diag[t].at[:ns].add(Hll_bucket)
                        else:
                            b_blocks[t] = b_blocks[t].at[segp].add(
                                bl_bucket, unique_indices=True)
                            diag[t] = diag[t].at[segp].add(
                                Hll_bucket, unique_indices=True)
                    elif self.counts[t] <= self.assembly_onehot_max:
                        from g2o_tpu.ops.onehot import onehot_scatter_add_t

                        idx = batch.vidx[:, s]
                        b_blocks[t] = b_blocks[t] + onehot_scatter_add_t(
                            idx, brows_t, self.counts[t])
                        diag[t] = diag[t] + onehot_scatter_add_t(
                            idx, Hss_t, self.counts[t]).reshape(-1, d, d)
                    else:
                        b_blocks[t] = b_blocks[t].at[batch.vidx[:, s]].add(
                            brows_t.T)
                        diag[t] = diag[t].at[batch.vidx[:, s]].add(
                            Hss_t.T.reshape(-1, d, d))
                # off-diagonal B = Jpᵀ W Jl, dims-major, reusing W·Jl from
                # the landmark Hss above, so the implicit Schur solver does
                # not re-derive it from lin.jacs on every λ-trial
                ps, ls = spec.pose_slot, spec.lm_slot
                extras.setdefault(name, {})
                extras[name]["Bt"] = jnp.sum(
                    Jt[ps][:, :, None, :] * WJ_ts[ls][:, None, :, :],
                    axis=0)                                      # (dp, dl, E)
                # DIMS-MAJOR leaves stored as-is: the row-major compat
                # transposes were NOT removed by XLA's while-loop DCE.
                # Consumers needing
                # row-major go through edge_jacs/edge_weights/edge_errors.
                jacs[name] = Jt
                weights[name] = Wt
                errors[name] = e_c
                continue

            states, e = self._edge_residuals(et, batch, estimates, name, data.plans)
            Js = jax.vmap(self._edge_jac_fns[name])(states, batch.meas,
                                                    batch.param)
            if not isinstance(Js, (tuple, list)):
                Js = (Js,)
            # zero Jacobian columns of fixed vertices — the masking analogue
            # of hessianIndex == -1 (``g2o/core/sparse_optimizer.cpp:179-188``).
            # The multiplier is precomputed host-side (plans "free_mask");
            # it replaces a device bool gather.
            fm = (data.plans.get(name) or {}).get("free_mask")
            if fm is not None:
                Js = tuple(J * fm[:, s][:, None, None]
                           for s, J in enumerate(Js))
            else:
                Js = tuple(
                    J * (1.0 - data.fixed[vt.name][batch.vidx[:, s]]
                         .astype(self.dtype))[:, None, None]
                    for s, (J, vt) in enumerate(zip(Js, et.vertex_types))
                )
            e2 = jnp.einsum("er,ers,es->e", e, batch.info, e,
                            precision=jax.lax.Precision.HIGHEST)
            rho = self._robustify(name, batch, e2)
            act_s = batch.active.astype(self.state_dtype)
            chi2_r = chi2_r + jnp.sum(rho[:, 0] * act_s)
            chi2_p = chi2_p + jnp.sum(e2 * act_s)
            # robust information: rho' * Omega (reference
            # ``BaseEdge::robustInformation``; the rho'' term is disabled
            # there as well).
            W = batch.info * (rho[:, 1] * act_s)[:, None, None]
            # see assembly_precision in __init__ (HIGHEST unless the
            # caller opted into the TF32 fast path)
            hi = (jax.lax.Precision.HIGHEST
                  if self.assembly_precision == "highest" else None)
            We = jnp.einsum("ers,es->er", W, e, precision=hi)

            for s, (J, vt) in enumerate(zip(Js, et.vertex_types)):
                t = vt.name
                brows = -jnp.einsum("erd,er->ed", J, We, precision=hi)
                Hss = jnp.einsum("erd,ers,esf->edf", J, W, J, precision=hi)
                b_blocks[t] = b_blocks[t].at[batch.vidx[:, s]].add(brows)
                diag[t] = diag[t].at[batch.vidx[:, s]].add(Hss)

            jacs[name], weights[name], errors[name] = Js, W, e

        b = self.join_tangent(b_blocks)
        if mixed:
            # round the solver-facing leaves to the narrow dtype ONCE (see
            # note at the top); chi2 stays wide
            def _narrow(x):
                return x.astype(self.dtype)

            tm = jax.tree_util.tree_map
            jacs, weights, errors, extras = (
                tm(_narrow, jacs), tm(_narrow, weights),
                tm(_narrow, errors), tm(_narrow, extras))
            b = _narrow(b)
            diag = tm(_narrow, diag)
        return LinearizedSystem(jacs, weights, errors, b, diag, chi2_r,
                                chi2_p, extras)

    def hvp_fn(self, data: ProblemData, lin: LinearizedSystem, v):
        """Flat-vector H·v — thin wrapper over :meth:`hvp_blocks_fn` (the
        split/join round-trip is slices + a concat, not gathers)."""
        return self.join_tangent(
            self.hvp_blocks_fn(data, lin, self.split_tangent(v)))

    def hvp_operator(self, data: ProblemData, lin: LinearizedSystem,
                     *, onehot_max_segments: int = 0, precision=None):
        """Build the latency-optimal H·v closure for CG loops.

        Precomputes, once per linearization (loop-invariant, so it is
        hoisted out of ``lax.while_loop`` bodies): the slot-concatenated
        Jacobian ``Jcat = [J_1 … J_k] : (E, r, K)`` and the weighted
        ``WJ = W·Jcat``, exploiting ``(W J) v = W (J v)``.  Each CG
        iteration then costs per edge type: ONE row gather, TWO batched
        einsums (``z = (WJ)·v_rows``, ``out = Jcatᵀ·z``), and ONE
        row scatter-add — versus five einsums through
        :meth:`hvp_blocks_fn`.

        ``onehot_max_segments`` > 0 replaces the row gather/scatter of any
        vertex type with at most that many vertices by one-hot matmuls at
        ``Precision.HIGHEST`` (exact in f32): the dense ``onehot(vidx) @ v``
        / ``onehot(vidx)^T @ contrib`` formulation trades indexed memory
        access for matmul work, which can win for small-to-medium vertex
        counts."""
        pre = {}
        f64 = jnp.dtype(self.dtype) == jnp.dtype(jnp.float64)
        for name in self.edge_types:
            Js = self.edge_jacs(lin, name)
            Jcat = jnp.concatenate(Js, axis=2)                 # (E, r, K)
            if f64:
                # the tiny batched f64 contractions are written as
                # broadcast-multiply-reduce elementwise work, which XLA
                # fuses instead of issuing one small f64 dot per edge
                WJ = (self.edge_weights(lin, name)[:, :, :, None]
                      * Jcat[:, None, :, :]).sum(axis=2)
            else:
                WJ = jnp.einsum("ers,esk->erk",
                                self.edge_weights(lin, name),
                                Jcat, precision=precision)
            pre[name] = (Jcat, WJ)

        def _mv(A, v):
            # "erk,ek->er" — bcast form when f64 (see note above)
            if f64:
                return (A * v[:, None, :]).sum(axis=2)
            return jnp.einsum("erk,ek->er", A, v, precision=precision)

        def _mtv(A, z):
            # "erk,er->ek"
            if f64:
                return (A * z[:, :, None]).sum(axis=1)
            return jnp.einsum("erk,er->ek", A, z, precision=precision)

        hi = jax.lax.Precision.HIGHEST

        def gather_rows(vb, vt_name, idx):
            v = vb[vt_name]
            n = self.counts[vt_name]
            if 0 < n <= onehot_max_segments:
                oh = jax.nn.one_hot(idx, n, dtype=v.dtype)
                return jax.lax.dot_general(
                    oh, v, (((1,), (0,)), ((), ())), precision=hi,
                    preferred_element_type=v.dtype)
            return v[idx]

        def scatter_rows(out_t, vt_name, idx, rows):
            n = self.counts[vt_name]
            if 0 < n <= onehot_max_segments:
                oh = jax.nn.one_hot(idx, n, dtype=rows.dtype)
                return out_t + jax.lax.dot_general(
                    oh, rows, (((0,), (0,)), ((), ())), precision=hi,
                    preferred_element_type=rows.dtype)
            return out_t.at[idx].add(rows)

        def hvp(vb):
            out = {t: jnp.zeros_like(vb[t]) for t in self.vertex_types}
            for name, et in self.edge_types.items():
                vidx = data.edges[name].vidx
                Jcat, WJ = pre[name]
                E = vidx.shape[0]
                tnames = [vt.name for vt in et.vertex_types]
                dims = [vt.tangent_dim for vt in et.vertex_types]
                if len(set(tnames)) == 1:
                    t, d, k = tnames[0], dims[0], len(dims)
                    rows = gather_rows(vb, t, vidx.reshape(E * k)).reshape(
                        E, k * d)
                    z = _mv(WJ, rows)
                    contrib = _mtv(Jcat, z)
                    out[t] = scatter_rows(
                        out[t], t, vidx.reshape(E * k),
                        contrib.reshape(E * k, d))
                else:
                    rows = jnp.concatenate(
                        [gather_rows(vb, t, vidx[:, s])
                         for s, t in enumerate(tnames)], axis=1)
                    z = _mv(WJ, rows)
                    contrib = _mtv(Jcat, z)
                    off = 0
                    for s, (t, d) in enumerate(zip(tnames, dims)):
                        out[t] = scatter_rows(out[t], t, vidx[:, s],
                                              contrib[:, off:off + d])
                        off += d
            return out

        return hvp

    def dense_hessian_fn(self, data: ProblemData, lin: LinearizedSystem):
        """Scatter-assemble the full dense tangent-space Hessian (small
        problems / the dense linear solver backend)."""
        T = self.total_dim
        H = jnp.zeros((T, T), dtype=self.dtype)
        for name, et in self.edge_types.items():
            batch = data.edges[name]
            Js = self.edge_jacs(lin, name)
            W = self.edge_weights(lin, name)
            idxs = [
                _seg_ids(data.offsets[vt.name], batch.vidx[:, s], vt.tangent_dim)
                for s, vt in enumerate(et.vertex_types)
            ]
            k = len(Js)
            for i in range(k):
                # HIGHEST: this H feeds direct factorizations (DenseSolver
                # cho_factor, marginals) — a reduced-precision einsum (TF32
                # at DEFAULT on the GPU) makes near-indefinite blocks NaN
                # there
                WJi = jnp.einsum("ers,erd->esd", W, Js[i],
                                 precision=jax.lax.Precision.HIGHEST)
                for j in range(i, k):
                    Hij = jnp.einsum("esd,esf->edf", WJi, Js[j],
                                     precision=jax.lax.Precision.HIGHEST)
                    rows = idxs[i][:, :, None]
                    cols = idxs[j][:, None, :]
                    H = H.at[rows, cols].add(Hij)
                    if j != i:
                        H = H.at[cols.transpose(0, 2, 1),
                                 rows.transpose(0, 2, 1)].add(
                            Hij.transpose(0, 2, 1)
                        )
        # unit diagonal on fixed slots keeps the system PD with dx=0 there
        H = H + jnp.diag(data.fixed_flat)
        return H

    def apply_update_fn(self, data: ProblemData, estimates, dx):
        """x ⊞ dx per vertex type; fixed vertices pinned — reference
        ``SparseOptimizer::update`` (``g2o/core/sparse_optimizer.cpp:441``)."""
        out = {}
        blocks = self.split_tangent(dx)
        for t, vt in self.vertex_types.items():
            delta = (blocks[t].astype(self.state_dtype)
                     * (1.0 - data.fixed[t]
                        .astype(self.state_dtype))[:, None])
            out[t] = jax.vmap(vt.oplus)(estimates[t], delta)
        return out

    def gauge_freedom(self) -> bool:
        """True when no vertex is fixed (reference ``gaugeFreedom``,
        ``g2o/core/sparse_optimizer.cpp:139``)."""
        return not any(bool(np.asarray(f).any()) for f in
                       (self.data.fixed.values()))


def build_problem(vertex_blocks, edge_blocks, *, dtype=None,
                  pad_edges_to_multiple: int = 1,
                  bucket_landmarks: bool = False,
                  static_kernels: bool = True,
                  state_dtype=None,
                  assembly_precision: str = "highest") -> Problem:
    """Build a :class:`Problem` from raw numpy blocks.

    ``vertex_blocks``: ``{VertexType: (vids (N,), estimates (N, rep),
    fixed (N,), marginalized (N,))}``;
    ``edge_blocks``: ``{EdgeType: (vids (E, k) raw ids, meas (E, m),
    info (E, r, r), kernel (E,), delta (E,), active (E,), param (E, p))}``.

    This is the array-direct compilation path (used by the fast native
    loader); :func:`compile_graph` reduces a host ``Graph`` to these blocks.
    Vertices are sorted by id within each type — the deterministic index
    mapping of the reference (``sparse_optimizer.cpp:168,504``)."""
    if dtype is None:
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    if state_dtype is None:
        state_dtype = dtype

    counts, vid_index, estimates, fixed, marginalized = {}, {}, {}, {}, {}
    fixed_np = {}
    offsets_np, type_bases, vertex_types = {}, {}, {}
    sorted_vids = {}
    base = 0
    for vt, (vids, est, fx, mg) in vertex_blocks.items():
        t = vt.name
        vertex_types[t] = vt
        order = np.argsort(vids, kind="stable")
        vids = np.asarray(vids)[order]
        est = np.asarray(est, dtype=np.float64)[order]
        fx = np.asarray(fx, dtype=bool)[order]
        mg = np.asarray(mg, dtype=bool)[order]
        n = len(vids)
        counts[t] = n
        # host-side until the single batched device_put below: the build
        # stages everything in numpy and ships ONE pytree, so the transfer
        # cost is paid once
        estimates[t] = est.astype(_np_dtype(state_dtype))
        fixed_np[t] = fx
        fixed[t] = fx
        marginalized[t] = mg
        sorted_vids[t] = vids
        # (vid_index is built ONCE after the bucket reorder pass below —
        # a 150k-entry Python dict loop costs ~0.3 s at Venice scale)
        type_bases[t] = base
        offsets_np[t] = base + np.arange(n, dtype=np.int32) * vt.tangent_dim
        base += n * vt.tangent_dim
    total_dim = base

    offsets = dict(offsets_np)

    edges = {}
    edge_types = {}
    bucket_specs = {}
    plans = {}
    expand_specs = {}
    uniform_kernel = {}
    m = max(int(pad_edges_to_multiple), 1)

    # ---- pass 1: raw per-edge arrays (vertex-id -> local-index) -------- #
    raw = {}
    for et, (vids, meas, info, kern, delt, act, par) in edge_blocks.items():
        name = et.name
        edge_types[name] = et

        vidx_raw = np.asarray(vids, dtype=np.int64)
        vidx = np.empty_like(vidx_raw, dtype=np.int32)
        for s, svt in enumerate(et.vertex_types):
            sv = sorted_vids.get(svt.name)
            if sv is None:
                raise ValueError(
                    f"{name}: no vertices of type {svt.name} present")
            loc = np.searchsorted(sv, vidx_raw[:, s])
            bad = (loc >= len(sv)) | (sv[np.minimum(loc, len(sv) - 1)]
                                      != vidx_raw[:, s])
            if bad.any():
                vid = int(vidx_raw[:, s][bad][0])
                raise ValueError(f"{name}: unknown vertex id {vid}")
            vidx[:, s] = loc
        act = np.asarray(act, dtype=bool).copy()
        par = np.asarray(par, dtype=np.float64)
        if par.ndim != 2 or par.shape[1] != et.param_dim:
            raise ValueError(
                f"{name}: parameter values have dim "
                f"{par.shape[1] if par.ndim == 2 else '?'}, "
                f"expected {et.param_dim}")
        raw[name] = {
            "vidx": vidx,
            "meas": np.asarray(meas, dtype=np.float64),
            "info": np.asarray(info, dtype=np.float64),
            "kernel": np.asarray(kern, dtype=np.int32),
            "delta": np.asarray(delt, dtype=np.float64),
            "active": act,
            "param": par,
        }

    def _bucket_lm_slot(et, E):
        """Slot index of the single fully-marginalized endpoint of a
        bucketable binary edge batch, or None."""
        if not (bucket_landmarks and E > 0 and len(et.vertex_types) == 2):
            return None
        marg_slots = [
            s for s, svt in enumerate(et.vertex_types)
            if counts[svt.name] > 0 and bool(
                np.asarray(marginalized[svt.name]).all())
        ]
        return marg_slots[0] if len(marg_slots) == 1 else None

    # ---- pass 2: landmark types bucketed by exactly ONE edge type are
    # REORDERED into bucket-segment order, so pass 3's plan comes out with
    # ``segp == arange`` (seg_identity): every segment gather/scatter in
    # linearize and the solvers becomes a static slice.  (Within-type
    # vertex order is an internal layout choice; ``vid_index`` keeps the
    # external id mapping.)
    if bucket_landmarks:
        from g2o_tpu.ops.bucketed import bucket_by_segment

        lm_users: dict = {}
        for name, et in edge_types.items():
            ls = _bucket_lm_slot(et, len(raw[name]["vidx"]))
            if ls is not None:
                lm_users.setdefault(et.vertex_types[ls].name, []).append(
                    (name, ls))
        for lt, users in lm_users.items():
            if len(users) != 1:
                continue
            name, ls = users[0]
            plan = bucket_by_segment(raw[name]["vidx"][:, ls], counts[lt])
            perm_v = plan.seg_perm_full            # new position -> old idx
            inv = np.empty_like(perm_v)
            inv[perm_v] = np.arange(len(perm_v), dtype=perm_v.dtype)
            estimates[lt] = np.asarray(estimates[lt])[perm_v]
            fixed_np[lt] = fixed_np[lt][perm_v]
            fixed[lt] = fixed_np[lt]
            marginalized[lt] = marginalized[lt][perm_v]
            sorted_vids[lt] = sorted_vids[lt][perm_v]
            for name2, et2 in edge_types.items():
                for s2, svt2 in enumerate(et2.vertex_types):
                    if svt2.name == lt:
                        raw[name2]["vidx"][:, s2] = inv[
                            raw[name2]["vidx"][:, s2]]

    for t, svids in sorted_vids.items():
        vid_index.update(
            zip(svids.tolist(), ((t, i) for i in range(counts[t]))))

    # fixed_flat MUST be built AFTER the bucket reorder pass: the pass
    # permutes fixed[t] within the type, and a stale flat mask would put
    # unit diagonals on the wrong tangent slots (singular H on the truly
    # fixed slot, spurious damping on a free one)
    fixed_flat = np.zeros((total_dim,), dtype=np.float64)
    for t in vertex_types:
        d = vertex_types[t].tangent_dim
        fx = np.asarray(fixed[t])
        offs = offsets_np[t][fx]
        for o in offs:
            fixed_flat[o:o + d] = 1.0

    # ---- pass 3: bucket edge rows, pad, freeze to device arrays -------- #
    for name, et in edge_types.items():
        arrays = raw[name]
        E = len(arrays["vidx"])

        # ---- compile-time landmark-bucketed layout --------------------- #
        # Binary edges with exactly one fully-marginalized slot get their
        # rows permuted into the degree-bucketed layout of
        # ``g2o_tpu/ops/bucketed.py``: H/b assembly and the implicit Schur
        # CG body then reduce the landmark axis with dense per-slab
        # reshapes + one-hot camera matmuls instead of scatters (the array
        # analogue of the reference's per-landmark Schur column loop,
        # ``g2o/core/block_solver.hpp:342``).  Padding rows
        # replicate row 0 with active=False (W == 0 kills contributions).
        ls = _bucket_lm_slot(et, E)
        if ls is not None:
            from g2o_tpu.ops.bucketed import bucket_by_segment

            lt = et.vertex_types[ls].name
            plan = bucket_by_segment(arrays["vidx"][:, ls], counts[lt])
            # padding slots replicate the FIRST ROW OF THEIR OWN SLAB
            # SEGMENT (not batch row 0): the padded row then shares its
            # segment's landmark id, so per-slab broadcasts of landmark
            # STATES are bit-identical to the row gather (inactive
            # padding keeps W == 0 so no contribution changes)
            perm = plan.perm_src.copy()
            sentinel = plan.perm_src == E
            off = 0
            for nseg, dg in zip(plan.counts, plan.degrees):
                # degree-major slabs: (dg, nseg); a segment's first row
                # is its degree-0 slot
                blk = perm[off:off + nseg * dg].reshape(dg, nseg)
                blk[:] = np.where(blk == E, blk[:1, :], blk)
                off += nseg * dg
            for k, a in arrays.items():
                a2 = a[perm]               # fancy indexing: fresh array
                if k == "active":
                    a2[sentinel] = False
                arrays[k] = a2
            seg_ident = bool(np.array_equal(
                plan.seg_perm, np.arange(len(plan.seg_perm),
                                         dtype=plan.seg_perm.dtype)))
            bucket_specs[name] = BucketedEdgeSpec(
                pose_slot=1 - ls, lm_slot=ls,
                counts=plan.counts, degrees=plan.degrees,
                n_rows=int(len(plan.perm_src)),
                seg_identity=seg_ident)
            plans[name] = {"segp": plan.seg_perm}
            E = int(len(plan.perm_src))

        n_pad = (-E) % m

        def pad(a, n_pad=n_pad):
            a = np.asarray(a)
            if n_pad == 0 or len(a) == 0:
                return a
            return np.concatenate([a, np.repeat(a[:1], n_pad, axis=0)], axis=0)

        act_full = np.asarray(arrays["active"], dtype=bool)
        if static_kernels:
            uks = np.unique(arrays["kernel"])
            uniform_kernel[name] = int(uks[0]) if len(uks) == 1 else None
        vidx_pad = pad(arrays["vidx"])
        # measurements/information/params define the problem CONSTANTS of
        # the state-dtype residual path — quantizing them at f32 would
        # shift the chi2 fixed point just like state quantization
        nd = _np_dtype(state_dtype)
        inf = np.asarray(arrays["info"])
        kr = np.asarray(arrays["kernel"], dtype=np.int32)
        dl = np.asarray(arrays["delta"])
        # UNIFORM-CONSTANT ELISION: batches whose info/kernel/delta/active
        # are constant across edges (every BAL batch: identity info, one
        # kernel, all active) ship ONE row and are expanded on device after
        # the batched transfer below (the uniform identity info alone is
        # 14.4 MB at Venice scale).  The fixed-vertex free mask is likewise
        # DERIVED on device (one-time gather) instead of shipped.
        info_u = E > 0 and bool((inf == inf[:1]).all())
        kern_u = E > 0 and bool((kr == kr[0]).all())
        delta_u = E > 0 and bool((dl == dl[0]).all())
        act_u = bool(act_full.all())
        if act_u:
            act_ship = act_full[:1]
        else:
            act_ship = pad(act_full)
            if n_pad:
                act_ship = act_ship.copy()
                act_ship[E:] = False
        expand_specs[name] = {
            "n": E + n_pad, "n_used": E,
            "info_u": info_u, "kern_u": kern_u, "delta_u": delta_u,
            "act_u": act_u,
            "kern0": int(kr[0]) if kern_u else None,
            "delta0": float(dl[0]) if delta_u else None,
        }
        edges[name] = EdgeBatchData(
            vidx=vidx_pad,
            meas=pad(arrays["meas"]).astype(nd),
            info=(inf[:1] if info_u else pad(inf)).astype(nd),
            kernel=(kr[:1] if kern_u else pad(kr)),
            delta=(dl[:1] if delta_u else pad(dl)).astype(nd),
            active=act_ship,
            param=pad(arrays["param"]).astype(nd),
        )

    data = ProblemData(
        edges=edges,
        fixed=fixed,
        offsets=offsets,
        fixed_flat=fixed_flat.astype(_np_dtype(dtype)),
        plans=plans,
    )
    # ONE batched transfer of the whole problem pytree: jax.device_put on
    # the full pytree batches the ~20 arrays instead of paying one
    # transfer per array
    data, estimates = jax.device_put((data, estimates))
    # device-side EXPANSION of the elided uniform constants + free-mask
    # derivation + dims-major bucketed constants, replacing ~30 MB of
    # host-to-device transfer at Venice scale.  ONE jitted call: as
    # separate eager ops each would compile on its own in every process
    # (sub-1 s compiles are not persisted in the compilation cache).
    np_dtype = _np_dtype(dtype)
    state_np = _np_dtype(state_dtype)

    def _expand_fn(dat):
        new_edges = {}
        plan_extra = {}
        for name, b in dat.edges.items():
            sp = expand_specs[name]
            n, et = sp["n"], edge_types[name]
            if sp["info_u"]:
                b = b._replace(info=jnp.tile(b.info, (n, 1, 1)))
            if sp["kern_u"]:
                b = b._replace(kernel=jnp.full((n,), sp["kern0"],
                                               jnp.int32))
            if sp["delta_u"]:
                b = b._replace(delta=jnp.full((n,), sp["delta0"],
                                              state_np))
            if sp["act_u"]:
                b = b._replace(
                    active=(jnp.arange(n, dtype=jnp.int32) < sp["n_used"]
                            if sp["n_used"] < n
                            else jnp.ones((n,), bool)))
            # per-edge fixed-vertex Jacobian multiplier (1.0 free / 0.0
            # fixed), gathered once at build instead of on every
            # linearize.  Incremental mode refreshes rows via ``add_edge``.
            cols = []
            for s, svt in enumerate(et.vertex_types):
                if fixed_np[svt.name].any():
                    cols.append(1.0 - dat.fixed[svt.name][b.vidx[:, s]]
                                .astype(np_dtype))
                else:
                    cols.append(jnp.ones((n,), np_dtype))
            fm = jnp.stack(cols, axis=1)
            extra = {"free_mask": fm}
            if name in bucket_specs:
                # dims-major constants (host duplication would double
                # the transfer)
                extra["meas_t"] = b.meas.T
                extra["info_t"] = b.info.transpose(1, 2, 0)
                extra["free_mask_t"] = fm.T
            new_edges[name] = b
            plan_extra[name] = extra
        return new_edges, plan_extra

    new_edges, plan_extra = jax.jit(_expand_fn)(data)
    new_plans = dict(data.plans)
    for name, extra in plan_extra.items():
        new_plans[name] = {**(new_plans.get(name) or {}), **extra}
    data = data._replace(edges=new_edges, plans=new_plans)
    n_active_edges = sum(int(np.asarray(r["active"]).sum())
                         for r in raw.values())
    return Problem(vertex_types, counts, edge_types, data, estimates,
                   marginalized, vid_index, type_bases, total_dim, dtype,
                   bucket_specs=bucket_specs, uniform_kernel=uniform_kernel,
                   state_dtype=state_dtype,
                   assembly_precision=assembly_precision,
                   n_active_edges=n_active_edges)


def compile_graph(graph, *, level: int = 0, dtype=None,
                  pad_edges_to_multiple: int = 1,
                  bucket_landmarks: bool = False,
                  static_kernels: bool = True,
                  state_dtype=None,
                  assembly_precision: str = "highest") -> Problem:
    """Freeze a host-side :class:`~g2o_tpu.core.graph.Graph` into a
    :class:`Problem` — the analogue of ``initializeOptimization`` +
    ``buildIndexMapping`` (``g2o/core/sparse_optimizer.cpp:201,168``)."""
    # ---- vertices: group by type ----
    vrecs = graph.vertices()
    by_type: dict[str, list] = {}
    vt_by_name = {}
    for vid in vrecs:
        rec = vrecs[vid]
        by_type.setdefault(rec.vtype.name, []).append(rec)
        vt_by_name[rec.vtype.name] = rec.vtype

    vertex_blocks = {}
    for t, recs in by_type.items():
        vertex_blocks[vt_by_name[t]] = (
            np.array([r.vid for r in recs], dtype=np.int64),
            np.stack([r.estimate for r in recs]).astype(np.float64),
            np.array([r.fixed for r in recs], dtype=bool),
            np.array([r.marginalized for r in recs], dtype=bool),
        )

    # ---- edges: group by type, filter level (reference level filter at
    # ``sparse_optimizer.cpp:232``) ----
    erecs_by_type: dict[str, list] = {}
    et_by_name = {}
    for e in graph.edges():
        if e.level != level:
            continue
        erecs_by_type.setdefault(e.etype.name, []).append(e)
        et_by_name[e.etype.name] = e.etype

    edge_blocks = {}
    for name, recs in erecs_by_type.items():
        et = et_by_name[name]
        if et.param_dim:
            par = np.stack([
                np.concatenate([graph.parameter(pid) for pid in e.param_id])
                for e in recs
            ])
        else:
            par = np.zeros((len(recs), 0), dtype=np.float64)
        edge_blocks[et] = (
            np.array([e.vids for e in recs], dtype=np.int64),
            np.stack([e.measurement for e in recs]),
            np.stack([e.information for e in recs]),
            np.array([e.kernel for e in recs], dtype=np.int32),
            np.array([e.delta for e in recs], dtype=np.float64),
            np.array([e.active for e in recs], dtype=bool),
            par,
        )

    return build_problem(vertex_blocks, edge_blocks, dtype=dtype,
                         pad_edges_to_multiple=pad_edges_to_multiple,
                         bucket_landmarks=bucket_landmarks,
                         static_kernels=static_kernels,
                         state_dtype=state_dtype,
                         assembly_precision=assembly_precision)
