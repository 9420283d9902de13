"""Matrix-free preconditioned conjugate gradient.

Array-program analogue of the reference ``LinearSolverPCG``
(``g2o/solvers/pcg/linear_solver_pcg.h:47``): instead of iterating a
``SparseBlockMatrix``, the Hessian-vector product is evaluated directly from
the cached per-edge Jacobian blocks as Σ Jᵀ(W(J v)) — batched small matmuls +
segment-sum scatter, which XLA fuses into a handful of kernels.

The entire CG recurrence runs in BLOCK LAYOUT (``{type: (N_t, d_t)}``): the
flat-vector formulation's ``v[idx]`` with ``(E, k·d)`` element indices
moves ~d× more index traffic per CG iteration than row-level gathers, and
the block-Jacobi preconditioner application becomes a pure batched einsum
with no gather at all.  Only the final update
vector is joined back to the flat ``(T,)`` layout.

Preconditioners:

* ``"jacobi"`` — per-vertex diagonal block inverses (the reference's
  block-Jacobi), one vmapped closed-form inverse per vertex type;
* ``"chunk"`` — chunked block-tridiagonal: consecutive poses are grouped
  into chunks of ``chunk_size`` and each chunk's diagonal + odometry-chain
  coupling is solved exactly with ONE batched dense Cholesky per
  application.  Pose-graph Hessians are dominated by the trajectory chain,
  so capturing it cuts CG iterations several-fold while costing a single
  batched dense factorization.  Falls back to Jacobi for problems
  without a single uniform vertex type.
* ``"chunk2"`` — two-level additive Schwarz: the chunk solves above are
  upgraded to capture ALL intra-chunk couplings (nearby loop closures, not
  just the odometry chain), and a COARSE correction solves the chunk-graph
  system ``(Rᵀ(H+λI)R)⁻¹`` exactly — ``R`` aggregates each chunk's vertices
  per tangent dim.  The coarse grid is what propagates information across
  loop closures between distant poses, which neither Jacobi nor the
  tridiagonal chunks can do; on loopy 2D pose graphs (manhattan worlds) it
  cuts CG iterations several-fold again.  Both levels are batched dense
  work (one ``(nc, cd, cd)`` Cholesky + one ``(nc·d)²`` coarse factor per
  λ-trial, pure einsums per CG application).

The CG recurrence runs entirely on device inside ``lax.while_loop``; only the
final update vector returns to the host."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from g2o_tpu.ops.smallblocks import inv_small


class PCGSolver:
    name = "pcg"

    def __init__(self, max_iter: int = 100, tol: float = 1e-6,
                 abs_tol: float = 0.0, precond: str = "jacobi",
                 chunk_size: int = 32, onehot_max_segments: int = 0,
                 absolute_tolerance: bool = True,
                 carry_factor: float = 0.5,
                 matvec_precision: str = "default",
                 precond_mode: str = "per_solve",
                 precond_refresh_every: int = 8,
                 precond_dtype=None):
        if precond_mode not in ("per_solve", "frozen", "every_k"):
            raise ValueError(f"unknown precond_mode {precond_mode!r}")
        # preconditioner dtype override: an f64 CG (needed when the solve
        # must resolve kappa ~1e9 small modes, e.g. the manhattan gn_var
        # fixed point) keeps its VECTORS and matvec in f64, while f64
        # factorizations/matmuls cost far more than f32 ones on an
        # accelerator.  The preconditioner only shifts the convergence
        # RATE, so both its BUILD (chunk Cholesky + coarse inverse) and
        # APPLY run at precond_dtype (f32) with boundary casts: application
        # rounding is a ~1e-7 relative perturbation of a fixed SPD
        # operator.
        self.precond_dtype = precond_dtype
        self.max_iter = int(max_iter)
        self.tol = float(tol)
        self.abs_tol = float(abs_tol)
        self.precond = precond
        self.chunk_size = int(chunk_size)
        # "frozen": the preconditioner is built by refresh_precond() and
        # travels via ``aux`` instead of being rebuilt inside every solve —
        # the device-side warm start for incremental/online optimization
        # (the reference's CHOLMOD update/downdate,
        # ``g2o_incremental/linear_solver_cholmod_online.h``, is a
        # sequential sparse-factor mutation with no SPMD formulation; a
        # slightly-stale preconditioner + CG achieves the same
        # reuse-across-updates economics)
        # "every_k": per-solve rebuild is replaced by a lax.cond-gated
        # rebuild every K-th solve INSIDE the fused loop — the chunk2
        # build (chunk Cholesky + coarse inverse) is ~half the manhattan
        # fast-phase iteration cost, and a K-solve-stale Schwarz
        # preconditioner only shifts CG counts, not correctness
        self.precond_mode = precond_mode
        self.precond_refresh_every = int(precond_refresh_every)
        # > 0: replace row gathers/scatters in the H·v product with exact
        # one-hot matmuls for vertex types of at most this many vertices
        # (see Problem.hvp_operator)
        self.onehot_max_segments = int(onehot_max_segments)
        # reference-PCG absoluteTolerance residual continuation: floor each
        # solve's stopping threshold by HALF the previous solve's final
        # residual (``solvers/pcg/linear_solver_pcg.hpp:124-127,149``) —
        # without it CG grinds the full iteration budget once LM has
        # converged and the relative criterion chases a vanishing rhs
        self.absolute_tolerance = bool(absolute_tolerance)
        # continuation strength: next solve's threshold floor =
        # carry_factor * this solve's final residual² (reference uses 0.5,
        # ``linear_solver_pcg.hpp:149``).  Smaller = deeper late solves;
        # 0.5 plateaus manhattan LM at chi2 ~9192 where near-exact solves
        # reach the reference 9146.5
        self.carry_factor = float(carry_factor)
        # precision of the H·v einsums inside the CG loop: at "default" the
        # GPU runs f32 matmuls in TF32 on the tensor cores (~1e-3
        # relative), which caps how far CG can reduce the true residual;
        # "highest" runs full f32 — required when the LM tail needs
        # near-exact solves (the manhattan reference-chi2 target)
        if matvec_precision not in ("default", "highest"):
            raise ValueError(f"unknown matvec_precision {matvec_precision!r}")
        self.matvec_precision = matvec_precision
        self._solve_jit = None
        self.aux = ()

    # ------------------------------------------------------------------ #

    def _setup_chunk_precond(self, problem):
        """Host-side index maps for the chunked preconditioners.

        Mixed vertex types are handled by PADDING every block to the max
        tangent dim ``d``: vertices get GLOBAL block ids (type base +
        local index, poses-then-landmarks order), padding slots carry a
        decoupled unit diagonal, and chunks group consecutive global ids
        — odometry chains stay consecutive within their type range, and
        the coarse chunk-graph level still couples pose chunks to
        landmark chunks through every binary edge.  Edges with >2 slots
        contribute only their diagonal (through ``lin.diag``)."""
        if self.precond not in ("chunk", "chunk2"):
            return None
        tnames = list(problem.vertex_types)
        dims = {t: problem.vertex_types[t].tangent_dim for t in tnames}
        d = max(dims.values())
        base = {}
        acc = 0
        for t in tnames:
            base[t] = acc
            acc += problem.counts[t]
        n = acc
        c = self.chunk_size
        nc = -(-n // c)          # chunks
        n_pad = nc * c

        binary = [name for name, et in problem.edge_types.items()
                  if et.num_slots == 2]
        return dict(tnames=tnames, dims=dims, base=base, d=d, n=n, c=c,
                    nc=nc, n_pad=n_pad, binary=binary)

    def _chunk_maps(self, problem, cfg):
        """Full-edge-length masked index maps for the chunk preconditioners
        — these travel through ``solver.aux`` as jit ARGUMENTS (never
        closure constants), so incremental drivers can refresh them after
        in-place edge mutations without retracing the solve program
        (:meth:`refresh_chunk_maps`; the capacity-padded incremental
        arrays keep all shapes constant)."""
        base, c, nc = cfg["base"], cfg["c"], cfg["nc"]
        dtype = (jnp.dtype(self.precond_dtype) if self.precond_dtype
                 else problem.dtype)
        maps = {}
        for name in cfg["binary"]:
            et = problem.edge_types[name]
            vidx = np.asarray(problem.data.edges[name].vidx)
            ga = base[et.vertex_types[0].name] + vidx[:, 0]
            gb = base[et.vertex_types[1].name] + vidx[:, 1]
            lo = np.minimum(ga, gb)
            hi = np.maximum(ga, gb)
            m = {}
            # chain: edges between consecutive GLOBAL ids within a chunk
            consecutive = (hi == lo + 1) & (lo // c == hi // c)
            m["cm"] = jnp.asarray(consecutive.astype(np.float64),
                                  dtype=dtype)
            m["fwd"] = jnp.asarray(ga < gb)
            m["lo"] = jnp.asarray(np.where(consecutive, lo, 0)
                                  .astype(np.int32))
            if self.precond == "chunk2":
                # intra: ALL same-chunk couplings (nearby loop closures)
                same = (ga // c) == (gb // c)
                m["im"] = jnp.asarray(same.astype(np.float64), dtype=dtype)
                m["ci"] = jnp.asarray(np.where(same, ga // c, 0)
                                      .astype(np.int32))
                m["l0"] = jnp.asarray(np.where(same, ga % c, 0)
                                      .astype(np.int32))
                m["l1"] = jnp.asarray(np.where(same, gb % c, 0)
                                      .astype(np.int32))
                # coarse chunk-graph scatter target for EVERY edge
                m["seg"] = jnp.asarray(((ga // c) * nc + (gb // c))
                                       .astype(np.int32))
            maps[name] = m
        # per-chunk slot coverage: slot s of chunk k is live when some
        # NON-FIXED vertex in the chunk has tangent dim > s; dead slots
        # (padding dims, fully-fixed or empty chunks) get a unit diagonal
        # in the coarse system so it stays SPD
        cover = np.zeros((nc, cfg["d"]), dtype=np.float64)
        for t in cfg["tnames"]:
            fx = np.asarray(problem.data.fixed[t])
            g = base[t] + np.arange(problem.counts[t])
            live = ~fx
            if live.any():
                cover[np.unique(g[live] // c), :cfg["dims"][t]] = 1.0
        maps["cover"] = jnp.asarray(cover, dtype=dtype)
        return maps

    def refresh_chunk_maps(self, problem):
        """Recompute the chunk index maps after in-place edge mutations
        (incremental adds).  No retrace: the maps are jit arguments and
        the capacity-padded arrays keep their shapes.  Falls back to a
        full ``setup(force=True)`` when shapes changed."""
        cfg = getattr(self, "_chunk_cfg", None)
        if cfg is None:
            return self
        if sum(problem.counts.values()) != cfg["n"]:
            return self.setup(problem, force=True)
        maps = self._chunk_maps(problem, cfg)
        old = self.aux.get("chunk") if isinstance(self.aux, dict) else None
        if old is not None:
            shapes_ok = all(
                old[k][f].shape == maps[k][f].shape
                for k in maps if k != "cover" for f in maps[k])
            if not shapes_ok:
                return self.setup(problem, force=True)
        self.aux = {**self.aux, "chunk": maps}
        return self

    def setup(self, problem, force: bool = False):
        # repeated setup on the SAME problem is a no-op: rebuilding the
        # closures re-creates jax.jit objects (fresh traces + compile-cache
        # loads) on every call when refresh-driven drivers call
        # optimize_fused in blocks.  Callers
        # that mutate edge index arrays (incremental adds) pass force=True.
        if getattr(self, "_setup_for", None) is problem and not force:
            return self
        # invalidate BEFORE building: an exception mid-setup must not leave
        # a half-built solver whose next setup() call no-ops
        self._setup_for = None
        max_iter, tol = self.max_iter, self.tol
        carry_factor = self.carry_factor
        chunk_cfg = self._setup_chunk_precond(problem)
        dtype = problem.dtype
        # all preconditioner build+apply work runs at pdtype (see __init__)
        pdtype = (jnp.dtype(self.precond_dtype) if self.precond_dtype
                  else dtype)
        p = problem

        def apply_precond_jacobi(data, minv, rb):
            # pure batched einsum per type — no gather/scatter
            return {t: jnp.einsum("nij,nj->ni", minv[t],
                                  rb[t].astype(pdtype)).astype(dtype)
                    for t in p.vertex_types}

        def build_precond_jacobi(data, lin, lam):
            lamp = lam.astype(pdtype) if hasattr(lam, "astype") \
                else jnp.asarray(lam, pdtype)
            minv = {}
            for t, vt in p.vertex_types.items():
                d = vt.tangent_dim
                eye = jnp.eye(d, dtype=pdtype)
                blocks = lin.diag[t].astype(pdtype) + lamp * eye
                # fixed vertices (zero rows in J) get a unit block -> dx = 0
                fx = data.fixed[t].astype(pdtype)[:, None, None]
                blocks = blocks * (1.0 - fx) + eye * fx
                minv[t] = inv_small(blocks)
            return minv

        if chunk_cfg is not None:
            tnames = chunk_cfg["tnames"]
            dims, tbase = chunk_cfg["dims"], chunk_cfg["base"]
            d, c = chunk_cfg["d"], chunk_cfg["c"]
            n, nc, n_pad = chunk_cfg["n"], chunk_cfg["nc"], chunk_cfg["n_pad"]
            cd = c * d
            binary = chunk_cfg["binary"]
            two_level = self.precond == "chunk2"
            counts = {t: p.counts[t] for t in tnames}

            def _pad_block(M):
                """(E, a, b) -> (E, d, d) zero-padded embedding."""
                a, b2 = M.shape[-2], M.shape[-1]
                if a == d and b2 == d:
                    return M
                return jnp.pad(M, ((0, 0), (0, d - a), (0, d - b2)))

            eye_d = jnp.eye(d, dtype=pdtype)

            def _jw(lin, name):
                """Edge Jacobians/weights cast to the precond dtype."""
                Js = [J.astype(pdtype) for J in p.edge_jacs(lin, name)]
                W = p.edge_weights(lin, name).astype(pdtype)
                return Js, W

            def stacked_diag(data, lin, lam):
                """Global (n, d, d) padded diagonal with damping, unit
                padding slots and identity on fixed vertices."""
                lamp = lam.astype(pdtype) if hasattr(lam, "astype") \
                    else jnp.asarray(lam, pdtype)
                D = jnp.zeros((n, d, d), dtype=pdtype)
                for t in tnames:
                    dt = dims[t]
                    blk = lin.diag[t].astype(pdtype) \
                        + lamp * jnp.eye(dt, dtype=pdtype)
                    fx = data.fixed[t].astype(pdtype)[:, None, None]
                    blk = blk * (1.0 - fx) + jnp.eye(dt, dtype=pdtype) * fx
                    blk = _pad_block(blk)
                    if dt < d:
                        pad_eye = jnp.diag(jnp.concatenate(
                            [jnp.zeros((dt,), pdtype), jnp.ones((d - dt,),
                                                                pdtype)]))
                        blk = blk + pad_eye[None]
                    D = D.at[tbase[t]:tbase[t] + counts[t]].set(blk)
                return D

            def stacked_vec(data, rb, mask_fixed=False):
                """{type: (N_t, d_t)} -> global (n, d) padded."""
                v = jnp.zeros((n, d), dtype=pdtype)
                for t in tnames:
                    r = rb[t].astype(pdtype)
                    if mask_fixed:
                        r = r * (1.0 - data.fixed[t].astype(pdtype)[:, None])
                    if dims[t] < d:
                        r = jnp.pad(r, ((0, 0), (0, d - dims[t])))
                    v = v.at[tbase[t]:tbase[t] + counts[t]].set(r)
                return v

            def unstacked_vec(z):
                return {t: z[tbase[t]:tbase[t] + counts[t], :dims[t]]
                        for t in tnames}
            ncd = nc * d                         # coarse system size

            def build_chunk_blocks(data, lin, lam, cmaps):
                eye = eye_d
                D = stacked_diag(data, lin, lam)
                if n_pad > n:
                    pad = jnp.tile(eye[None], (n_pad - n, 1, 1))
                    D = jnp.concatenate([D, pad], axis=0)
                # chunk diagonals: pure broadcast, no (n_pad,)-row scatter
                eye_c = jnp.eye(c, dtype=pdtype)
                M = (D.reshape(nc, c, 1, d, d)
                     * eye_c[None, :, :, None, None])
                if two_level:
                    # ALL intra-chunk couplings (subsumes the chain) as ONE
                    # one-hot matmul reduction: rows (both orientations)
                    # into the (chunk·c, c) grid — exact f32 at HIGHEST
                    for name in binary:
                        m = cmaps[name]
                        ci, l0, l1 = m["ci"], m["l0"], m["l1"]
                        Js, W = _jw(lin, name)
                        # HIGHEST: these blocks feed the chunk Cholesky —
                        # TF32 off-diagonal error (~1e-3 rel) can turn
                        # near-singular chunk blocks indefinite → NaN
                        # (full edge length, non-intra rows masked out —
                        # the maps travel via aux so incremental refresh
                        # never retraces)
                        Hab = _pad_block(jnp.einsum(
                            "erd,ers,esf->edf", Js[0], W, Js[1],
                            precision=jax.lax.Precision.HIGHEST))
                        Hab = Hab * m["im"][:, None, None]
                        Ei = Hab.shape[0]
                        rowid = jnp.concatenate([ci * c + l0, ci * c + l1])
                        colid = jnp.concatenate([l1, l0])
                        vals = jnp.concatenate(
                            [Hab, jnp.swapaxes(Hab, -1, -2)]
                        ).reshape(2 * Ei, d * d)
                        ohq = jax.nn.one_hot(colid, c, dtype=pdtype)
                        spread = (ohq[:, :, None]
                                  * vals[:, None, :]).reshape(2 * Ei,
                                                              c * d * d)
                        ohp = jax.nn.one_hot(rowid, nc * c, dtype=pdtype)
                        Mi = jax.lax.dot_general(
                            ohp, spread, (((0,), (0,)), ((), ())),
                            precision=jax.lax.Precision.HIGHEST,
                            preferred_element_type=pdtype)
                        M = M + Mi.reshape(nc, c, c, d, d)
                else:
                    # chain off-diagonals (both fixed-masked ends)
                    for name in binary:
                        m = cmaps[name]
                        Js, W = _jw(lin, name)
                        Hab = _pad_block(jnp.einsum(
                            "erd,ers,esf->edf", Js[0], W, Js[1],
                            precision=jax.lax.Precision.HIGHEST))
                        Hab = Hab * m["cm"][:, None, None]
                        # orient as block (lo, lo+1)
                        O = jnp.where(m["fwd"][:, None, None], Hab,
                                      jnp.swapaxes(Hab, -1, -2))
                        ci = m["lo"] // c
                        li = m["lo"] % c
                        M = M.at[ci, li, jnp.minimum(li + 1, c - 1)].add(O)
                        M = M.at[ci, jnp.minimum(li + 1, c - 1), li].add(
                            jnp.swapaxes(O, -1, -2))
                Md = M.transpose(0, 1, 3, 2, 4).reshape(nc, cd, cd)
                # invert ONCE per lambda-trial so each CG application is a
                # single batched einsum (a cho_solve per application costs
                # ~4x a CG iteration; the explicit inverse amortizes it)
                Lc = jnp.linalg.cholesky(Md)
                eye_c = jnp.broadcast_to(jnp.eye(cd, dtype=pdtype),
                                         (nc, cd, cd))
                return jax.scipy.linalg.cho_solve((Lc, True), eye_c)

            def assemble_coarse(data, lin, lam, cmaps):
                # Hc = Rᵀ(H+λI)R over non-fixed vertices: vertex diagonals
                # aggregate onto coarse diagonal blocks, every edge block
                # onto its (chunk_a, chunk_b) coarse entry + its transpose
                eye = eye_d
                # damped diagonal with fixed vertices ZEROED (restriction
                # ignores them) and no padding-slot identity yet
                lamp = lam.astype(pdtype) if hasattr(lam, "astype") \
                    else jnp.asarray(lam, pdtype)
                Dm = jnp.zeros((n, d, d), dtype=pdtype)
                for t in tnames:
                    dt = dims[t]
                    blk = lin.diag[t].astype(pdtype) \
                        + lamp * jnp.eye(dt, dtype=pdtype)
                    fxt = data.fixed[t].astype(pdtype)[:, None, None]
                    blk = _pad_block(blk * (1.0 - fxt))
                    Dm = Dm.at[tbase[t]:tbase[t] + counts[t]].set(blk)
                if n_pad > n:
                    Dm = jnp.concatenate(
                        [Dm, jnp.zeros((n_pad - n, d, d), dtype=pdtype)])
                Dc = Dm.reshape(nc, c, d, d).sum(axis=1)   # chunk aggregate
                # every edge block onto its (chunk_a, chunk_b) entry via a
                # TWO-SIDED one-hot product instead of an (nc²)-segment
                # scatter: S[a,b] = Σ_e 1[ca=a]·H_e·1[cb=b]
                S = jnp.zeros((nc, d * d, nc), dtype=pdtype)
                for name in binary:
                    seg = cmaps[name]["seg"]
                    Js, W = _jw(lin, name)
                    Hab = _pad_block(jnp.einsum(
                        "erd,ers,esf->edf", Js[0], W, Js[1],
                        precision=jax.lax.Precision.HIGHEST))
                    E = Hab.shape[0]
                    oha = jax.nn.one_hot(seg // nc, nc, dtype=pdtype)
                    ohb = jax.nn.one_hot(seg % nc, nc, dtype=pdtype)
                    spread = (oha[:, :, None]
                              * Hab.reshape(E, 1, d * d)).reshape(
                                  E, nc * d * d)
                    Si = jax.lax.dot_general(
                        spread, ohb, (((0,), (0,)), ((), ())),
                        precision=jax.lax.Precision.HIGHEST,
                        preferred_element_type=pdtype)
                    S = S + Si.reshape(nc, d * d, nc)
                S = jnp.moveaxis(S.reshape(nc, d, d, nc), 3, 1)
                Hc = S + jnp.swapaxes(S, 0, 1).transpose(0, 1, 3, 2)
                di = jnp.arange(nc)
                Hc = Hc.at[di, di].add(Dc)
                # dead coarse slots (padding dims of small-dim chunks,
                # fully-fixed/empty chunks) get a unit diagonal — their
                # rows/cols are zero otherwise and the factorization would
                # be singular
                cover = cmaps["cover"]                        # (nc, d)
                Hc = Hc.at[di, di].add(
                    jnp.einsum("cd,de->cde", 1.0 - cover, eye))
                return Hc.transpose(0, 2, 1, 3).reshape(ncd, ncd)

            def invert_coarse(Hd):
                # explicit inverse via Hc⁻¹ = L⁻ᵀ L⁻¹: one triangular solve
                # + one HIGHEST rank-k product (half the work of a
                # forward+backward solve pair against the identity)
                L = jnp.linalg.cholesky(Hd)
                Linv = jax.scipy.linalg.solve_triangular(
                    L, jnp.eye(ncd, dtype=pdtype), lower=True)
                return jnp.einsum("ki,kj->ij", Linv, Linv,
                                  precision=jax.lax.Precision.HIGHEST)

            def build_coarse_inverse(data, lin, lam, cmaps):
                return invert_coarse(assemble_coarse(data, lin, lam, cmaps))

            if two_level:
                def build_precond(data, lin, lam, cmaps):
                    return (build_chunk_blocks(data, lin, lam, cmaps),
                            build_coarse_inverse(data, lin, lam, cmaps))
            else:
                build_precond = build_chunk_blocks

            def apply_precond(data, Minv, rb):
                if two_level:
                    Minv, Cinv = Minv
                rv = stacked_vec(data, rb)                   # (n, d) padded
                if n_pad > n:
                    rv = jnp.concatenate(
                        [rv, jnp.zeros((n_pad - n, d), dtype=pdtype)], axis=0)
                rc = rv.reshape(nc, cd)
                y = jnp.einsum("cij,cj->ci", Minv, rc)
                z = y.reshape(n_pad, d)[:n]
                if two_level:
                    rm = stacked_vec(data, rb, mask_fixed=True)
                    if n_pad > n:
                        rm = jnp.concatenate(
                            [rm, jnp.zeros((n_pad - n, d), dtype=pdtype)],
                            axis=0)
                    rcoarse = rm.reshape(nc, c, d).sum(axis=1).reshape(ncd)
                    yc = jnp.einsum("ij,j->i", Cinv, rcoarse,
                                    precision=jax.lax.Precision.HIGHEST)
                    zc = yc.reshape(nc, d)
                    gfm = stacked_vec(
                        data, {t: 1.0 - data.fixed[t].astype(pdtype)[:, None]
                               * jnp.ones((1, dims[t]), pdtype)
                               for t in tnames})
                    z = z + gfm * jnp.repeat(zc, c, axis=0)[:n]
                return {t: v.astype(dtype)
                        for t, v in unstacked_vec(z).items()}

            self._dbg_parts = {
                "chunk_blocks": build_chunk_blocks,
                "coarse_assemble": assemble_coarse,
                "coarse_full": build_coarse_inverse,
            }

        else:
            def build_precond(data, lin, lam, cmaps):
                return build_precond_jacobi(data, lin, lam)
            apply_precond = apply_precond_jacobi

        self._dbg_build = build_precond
        self._dbg_apply = apply_precond

        tdot = p.tree_dot
        tmap = jax.tree_util.tree_map

        onehot_max = self.onehot_max_segments
        mv_prec = (jax.lax.Precision.HIGHEST
                   if self.matvec_precision == "highest" else None)

        frozen = self.precond_mode == "frozen"
        every_k = self.precond_mode == "every_k"
        refresh_k = self.precond_refresh_every

        def solve_full(data, lin, lam, aux=(), carry=None, pstate=None):
            # loop-invariant W·J precompute (hoisted out of the CG loop)
            hvp = p.hvp_operator(data, lin,
                                 onehot_max_segments=onehot_max,
                                 precision=mv_prec)

            def matvec(vb):
                # damped system + unit rows on fixed slots
                hv = hvp(vb)
                out = {}
                for t in p.vertex_types:
                    fm = data.fixed[t].astype(dtype)[:, None]
                    out[t] = hv[t] + lam * vb[t] + fm * (vb[t] - lam * vb[t])
                return out

            b = p.split_tangent(lin.b)
            cmaps = aux.get("chunk") if isinstance(aux, dict) else None
            if frozen:
                minv = aux["minv"]
            elif every_k:
                k, minv_old = pstate
                minv = jax.lax.cond(
                    k % refresh_k == 0,
                    lambda: build_precond(data, lin, lam, cmaps),
                    lambda: minv_old)
                pstate = (k + 1, minv)
            else:
                minv = build_precond(data, lin, lam, cmaps)
            x0 = tmap(jnp.zeros_like, b)
            r0 = b
            z0 = apply_precond(data, minv, r0)
            p0 = z0
            rz0 = tdot(r0, z0)
            thresh = tol * tol * tdot(b, b)
            if carry is not None:
                # residual continuation: successive LM solves only deepen
                # by one halving each (reference absoluteTolerance)
                thresh = jnp.maximum(thresh, carry.astype(thresh.dtype))

            def cond(c):
                _, r, _, _, rz, it = c
                return jnp.logical_and(it < max_iter, tdot(r, r) > thresh)

            def body(c):
                x, r, z, pv, rz, it = c
                Ap = matvec(pv)
                alpha = rz / tdot(pv, Ap)
                x = tmap(lambda a, b_: a + alpha * b_, x, pv)
                r = tmap(lambda a, b_: a - alpha * b_, r, Ap)
                z = apply_precond(data, minv, r)
                rz_new = tdot(r, z)
                beta = rz_new / rz
                pv = tmap(lambda a, b_: a + beta * b_, z, pv)
                return (x, r, z, pv, rz_new, it + 1)

            x, r_f, _, _, _, cg_iters = jax.lax.while_loop(
                cond, body, (x0, r0, z0, p0, rz0, 0))
            res2 = tdot(r_f, r_f)
            stats = {"cg_iterations": cg_iters, "residual2": res2,
                     "carry": carry_factor * res2}
            return p.join_tangent(x), stats, pstate

        abs_tol_on = self.absolute_tolerance

        def solve(data, lin, lam, aux=()):
            return solve_full(data, lin, lam, aux)[0]

        if every_k:
            def solve_state(data, lin, lam, aux, state):
                dx, st, (k, minv) = solve_full(
                    data, lin, lam, aux,
                    carry=state["carry"] if abs_tol_on else None,
                    pstate=(state["k"], state["minv"]))
                return dx, {"carry": st["carry"], "k": k, "minv": minv}, st
        else:
            def solve_state(data, lin, lam, aux, state):
                dx, st, _ = solve_full(data, lin, lam, aux, carry=state)
                return dx, st["carry"], st

        self._solve_fn = solve          # unjitted, for fusion into one step
        self._solve_jit = jax.jit(solve)
        if self.absolute_tolerance or every_k:
            self._solve_state_fn = solve_state
            self._solve_state_jit = jax.jit(solve_state)
            self.state0 = jnp.asarray(-1.0, dtype)
        self._host_state = None
        self._chunk_cfg = chunk_cfg
        if chunk_cfg is not None:
            self.aux = {"chunk": self._chunk_maps(problem, chunk_cfg)}
        else:
            self.aux = {}
        if every_k:
            # state0 carries a structurally-valid preconditioner (the
            # k%K==0 rebuild at the first solve replaces its values)
            lin0 = p.linearize_jit(p.data, p.estimates)
            cmaps0 = self.aux.get("chunk") \
                if isinstance(self.aux, dict) else None
            minv0 = jax.jit(build_precond)(
                p.data, lin0, jnp.asarray(0.0, dtype), cmaps0)
            self.state0 = {"carry": jnp.asarray(-1.0, dtype),
                           "k": jnp.asarray(0, jnp.int32),
                           "minv": minv0}
        if frozen:
            self._build_precond_jit = jax.jit(build_precond)
            self._problem_ref = problem
            self.refresh_precond(problem)
        self._setup_for = problem
        return self

    def refresh_precond(self, problem=None, lam: float | None = None):
        """Rebuild the frozen preconditioner from the problem's CURRENT
        linearization (``precond_mode="frozen"`` only).  Incremental
        drivers call this once per update; every λ-trial of every LM
        iteration in between reuses the stale (but spectrally close)
        preconditioner — the warm start that replaces per-solve builds."""
        if self.precond_mode != "frozen":
            raise RuntimeError("refresh_precond requires precond_mode="
                               "'frozen'")
        p = problem if problem is not None else self._problem_ref
        lin = p.linearize_jit(p.data, p.estimates)
        if lam is None:
            from g2o_tpu.core.optimizer import _max_abs_diag
            lam = float(1e-5 * _max_abs_diag(p, lin))
        cmaps = self.aux.get("chunk") if isinstance(self.aux, dict) \
            else None
        minv = self._build_precond_jit(p.data, lin,
                                       jnp.asarray(lam, p.dtype), cmaps)
        self.aux = {**({"chunk": cmaps} if cmaps is not None else {}),
                    "minv": minv}
        return self

    def solve(self, data, lin, lam=0.0):
        if self.absolute_tolerance or self.precond_mode == "every_k":
            if self._host_state is None:
                self._host_state = self.state0
            dx, self._host_state, _ = self._solve_state_jit(
                data, lin, lam, self.aux, self._host_state)
            return dx
        return self._solve_jit(data, lin, lam, self.aux)
