"""Host direct sparse-Cholesky solver — the hybrid device/host backend.

The reference's entire direct-solver value is a SEQUENTIAL f64 sparse
factorization on a host core (CSparse ``cs_chol``:
``g2o/solvers/csparse/linear_solver_csparse.h:107``; CHOLMOD:
``solvers/cholmod/linear_solver_cholmod.h:76``).  For LARGE batched systems
our level-scheduled device factorizations win, but a *small* ill-conditioned
f64 tail system (manhattan's gn_var fixed point: 10.5k dims, kappa ~2e9 —
f32 floors) is latency-bound
sequential work where a host core is the speed-of-light unit.  This solver
splits the step accordingly:

* **device**: linearization + H/b block assembly (one jit, exact
  precision), shipping ~0.5 MB of block values;
* **host**: scalar up-looking sparse Cholesky in native C++
  (``native/hostchol.cpp``) over a block-fill-reducing nested-dissection
  ordering (``native/symchol.cpp``), then dx back to device.

Generality: n-ary edges (all vertex-pair blocks enter the pattern — the
reference builds its pattern the same way from whatever H blocks exist,
``g2o/core/block_solver.hpp:142-214``) and mixed vertex types (true block
dims, no padding) are supported.

Failure semantics: a non-PD factorization returns a NaN step, which the
LM driver rejects (λ escalation) and ``writeDebug`` can dump — the
reference's csparse failure branch (``linear_solver_csparse.h:128``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from g2o_tpu.core.solvers.sparse_chol import symbolic_factorization


class HostCholSolver:
    """Direct f64 sparse Cholesky on the host CPU (native C++ numeric
    phase), with device-side H/b assembly.  Host-loop drivers only (the
    factorization cannot live inside a fused device program)."""

    name = "host_chol"

    def __init__(self, min_separator_size: int = 32):
        self.min_size = int(min_separator_size)
        self.aux = ()
        self._base_cache = (None, None)   # (id(lin), base Ax)

    def setup(self, problem):
        p = problem
        self._p = p
        tnames = list(p.vertex_types)
        dims = {t: p.vertex_types[t].tangent_dim for t in tnames}
        base = {}
        acc = 0
        for t in tnames:
            base[t] = acc
            acc += p.counts[t]
        n = acc

        # block pattern: ALL vertex pairs of every edge (n-ary included)
        pair_set = set()
        edge_pairs = {}                   # name -> list of (sa, sb) slots
        for name, et in p.edge_types.items():
            vidx = np.asarray(p.data.edges[name].vidx)
            k = et.num_slots
            edge_pairs[name] = [(a, b) for a in range(k)
                                for b in range(a + 1, k)]
            for a, b in edge_pairs[name]:
                ga = base[et.vertex_types[a].name] + vidx[:, a]
                gb = base[et.vertex_types[b].name] + vidx[:, b]
                lo = np.minimum(ga, gb)
                hi = np.maximum(ga, gb)
                m = lo != hi
                pair_set.update(zip(lo[m].tolist(), hi[m].tolist()))
        pairs = np.asarray(sorted(pair_set), dtype=np.int64).reshape(-1, 2)

        sym = symbolic_factorization(n, pairs, min_size=self.min_size)
        perm = sym["perm"].astype(np.int64)      # new k -> old block id
        inv = sym["inv"].astype(np.int64)        # old block id -> new k

        # scalar layout of the PERMUTED system (true block dims)
        bdim = np.empty(n, dtype=np.int64)
        btype = np.empty(n, dtype=object)
        blocal = np.empty(n, dtype=np.int64)
        for t in tnames:
            bdim[base[t]:base[t] + p.counts[t]] = dims[t]
            btype[base[t]:base[t] + p.counts[t]] = t
            blocal[base[t]:base[t] + p.counts[t]] = np.arange(p.counts[t])
        pdim = bdim[perm]                         # dim per permuted block
        soff = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(pdim, out=soff[1:])
        N = int(soff[-1])                         # total scalar dim

        # flat-tangent index per permuted scalar (for b / dx permutation)
        scal_from_flat = np.empty(N, dtype=np.int64)
        for k in range(n):
            g = perm[k]
            t = btype[g]
            flat0 = p.type_bases[t] + blocal[g] * dims[t]
            scal_from_flat[soff[k]:soff[k + 1]] = flat0 + np.arange(dims[t])

        # --- upper-CSC scalar pattern --------------------------------- #
        rows_l, cols_l = [], []
        # diagonal blocks: upper triangle within each block
        for d in np.unique(pdim):
            ks = np.nonzero(pdim == d)[0]
            iu, ju = np.triu_indices(int(d))
            rows_l.append((soff[ks][:, None] + iu[None, :]).ravel())
            cols_l.append((soff[ks][:, None] + ju[None, :]).ravel())
        # off-diagonal block pairs (permuted lo < hi): full d_lo × d_hi
        if len(pairs):
            plo = inv[pairs[:, 0]]
            phi = inv[pairs[:, 1]]
            swap = plo > phi
            plo2 = np.where(swap, phi, plo)
            phi2 = np.where(swap, plo, phi)
            for dl in np.unique(pdim[plo2]):
                for dh in np.unique(pdim[phi2]):
                    m = (pdim[plo2] == dl) & (pdim[phi2] == dh)
                    if not m.any():
                        continue
                    r, c = [x.ravel() for x in
                            np.indices((int(dl), int(dh)))]
                    rows_l.append((soff[plo2[m]][:, None]
                                   + r[None, :]).ravel())
                    cols_l.append((soff[phi2[m]][:, None]
                                   + c[None, :]).ravel())
        rows = np.concatenate(rows_l)
        cols = np.concatenate(cols_l)
        order = np.lexsort((rows, cols))
        rows, cols = rows[order], cols[order]
        key_all = cols * N + rows                 # globally ascending
        nnz = rows.shape[0]
        Ap = np.zeros(N + 1, dtype=np.int64)
        np.add.at(Ap, cols + 1, 1)
        Ap = np.cumsum(Ap)
        Ai = rows.astype(np.int32)

        def pos_of(r, c):
            return np.searchsorted(key_all, c * N + r)

        # --- value scatter maps --------------------------------------- #
        # diag blocks per type: (N_t, d, d) -> upper-triangle positions
        diag_maps = {}
        for t in tnames:
            d = dims[t]
            iu, ju = np.triu_indices(d)
            ks = inv[base[t] + np.arange(p.counts[t])]
            r = soff[ks][:, None] + iu[None, :]
            c = soff[ks][:, None] + ju[None, :]
            # (N_t, n_triu) positions + the (iu, ju) source picks
            diag_maps[t] = (pos_of(r, c), iu, ju)

        # per edge type / slot pair: (E, da, db) H_ab blocks
        off_maps = {}
        self_maps = {}
        for name, et in p.edge_types.items():
            vidx = np.asarray(p.data.edges[name].vidx)
            for a, b in edge_pairs[name]:
                ta = et.vertex_types[a].name
                tb = et.vertex_types[b].name
                da, db = dims[ta], dims[tb]
                pa = inv[base[ta] + vidx[:, a]]
                pb = inv[base[tb] + vidx[:, b]]
                valid = pa != pb
                i, j = [x.ravel() for x in np.indices((da, db))]
                # H_ab[i, j] lands at (row=soff[pa]+i, col=soff[pb]+j) when
                # pa < pb, transposed otherwise
                ra = soff[pa][:, None] + i[None, :]
                cb = soff[pb][:, None] + j[None, :]
                r = np.where((pa < pb)[:, None], ra, cb)
                c = np.where((pa < pb)[:, None], cb, ra)
                posm = pos_of(r, c)
                posm[~valid] = 0          # masked below
                off_maps[(name, a, b)] = (posm, valid)
                # both slots bind the SAME vertex: H_ab + H_abᵀ belongs to
                # that vertex's DIAGONAL block (dense_hessian_fn and the
                # reference accumulate it there; dropping it silently
                # factors a different matrix)
                if (~valid).any():
                    sel = np.nonzero(~valid)[0]
                    iu, ju = np.triu_indices(da)
                    rs = soff[pa[sel]][:, None] + iu[None, :]
                    cs = soff[pa[sel]][:, None] + ju[None, :]
                    self_maps[(name, a, b)] = (pos_of(rs, cs), sel, iu, ju)

        # diagonal scalar positions (for λ damping / fixed identity)
        alld = np.arange(N, dtype=np.int64)
        diag_pos = pos_of(alld, alld)
        fixed_scal = np.zeros(N, dtype=bool)
        for t in tnames:
            fx = np.asarray(p.data.fixed[t]).astype(bool)
            ks = inv[base[t] + np.nonzero(fx)[0]]
            for k in ks:
                fixed_scal[soff[k]:soff[k + 1]] = True
        self._lam_pos = diag_pos[~fixed_scal]
        self._fix_pos = diag_pos[fixed_scal]

        from g2o_tpu.native import HostCholesky

        self._hc = HostCholesky(N, Ap, Ai)
        self._nnz = nnz
        self._N = N
        self._scal_from_flat = scal_from_flat
        self._diag_maps = diag_maps
        self._off_maps = off_maps
        self._self_maps = self_maps
        self._edge_pairs = edge_pairs
        self._dims = dims

        hi = jax.lax.Precision.HIGHEST

        def off_blocks(lin):
            """Off-diagonal H_ab blocks, one exact einsum per slot pair."""
            out_off = {}
            for name, et in p.edge_types.items():
                if not edge_pairs[name]:
                    continue
                Js = p.edge_jacs(lin, name)
                W = p.edge_weights(lin, name)
                for a, b in edge_pairs[name]:
                    out_off[(name, a, b)] = jnp.einsum(
                        "erd,ers,esf->edf", Js[a], W, Js[b], precision=hi)
            return out_off

        def assemble(data, lin):
            """Device-side H block production (diag blocks come free from
            lin.diag)."""
            return lin.diag, off_blocks(lin), lin.b

        self._off_blocks = off_blocks
        self._assemble_jit = jax.jit(assemble)

        def step1(data, est):
            """Fused linearize + H/b assembly (the host-GN driver's single
            fetch per iteration — see :func:`optimize_gn_host`)."""
            lin = p.linearize_fn(data, est)
            return lin.diag, off_blocks(lin), lin.b, lin.chi2_robust

        # built ONCE here: a fresh jax.jit wrapper per driver call would
        # re-trace every run
        self._step1_jit = jax.jit(step1)
        return self

    def _scatter_ax(self, diag, off):
        """Scatter fetched block values into the upper-CSC value array
        (shared by the cached-base and per-call paths)."""
        idx_l, val_l = [], []
        for t, (posm, iu, ju) in self._diag_maps.items():
            idx_l.append(posm.ravel())
            val_l.append(np.asarray(diag[t], dtype=np.float64)
                         [:, iu, ju].ravel())
        for key, (posm, valid) in self._off_maps.items():
            H = np.asarray(off[key], dtype=np.float64)
            E, da, db = H.shape
            idx_l.append(posm[valid].ravel())
            val_l.append(H.reshape(E, da * db)[valid].ravel())
        for key, (posm, sel, iu, ju) in self._self_maps.items():
            # same-vertex slot pairs: H_ab + H_abᵀ into the diagonal block
            H = np.asarray(off[key], dtype=np.float64)[sel]
            Hs = H + np.swapaxes(H, 1, 2)
            idx_l.append(posm.ravel())
            val_l.append(Hs[:, iu, ju].ravel())
        Ax = np.bincount(np.concatenate(idx_l),
                         weights=np.concatenate(val_l),
                         minlength=self._nnz)
        # fixed vertices: unit diagonal (their H contributions are
        # already zero — Jacobian slots masked at linearize)
        Ax[self._fix_pos] += 1.0
        return Ax

    def _factor_solve(self, Ax, bh, lam):
        """λ-damp, factor, solve, un-permute.  NaN dx on non-PD (the
        reference csparse failure branch, linear_solver_csparse.h:128)."""
        if lam:
            Ax[self._lam_pos] += float(lam)
        rc = self._hc.factor(Ax)
        if rc != 0:
            return np.full(self._N, np.nan), Ax
        x = self._hc.solve(bh)
        dx = np.zeros(self._N, dtype=np.float64)
        dx[self._scal_from_flat] = x
        return dx, Ax

    def _base_ax(self, data, lin):
        """Assemble the λ=0 value array (cached per linearization; the
        cache holds a strong ref to ``lin`` so identity can't be reused)."""
        if self._base_cache[0] is lin:
            return self._base_cache[1]
        diag, off, b = jax.device_get(self._assemble_jit(data, lin))
        Ax = self._scatter_ax(diag, off)
        bh = np.asarray(b, dtype=np.float64)[self._scal_from_flat]
        self._base_cache = (lin, (Ax, bh))
        return Ax, bh

    def _fill_and_solve(self, diag, off, b, lam):
        """Host-side: scatter fetched block values into Ax, factor, solve.
        Returns the flat-tangent dx as float64 numpy (NaN on non-PD)."""
        Ax = self._scatter_ax(diag, off)
        bh = np.asarray(b, dtype=np.float64)[self._scal_from_flat]
        return self._factor_solve(Ax, bh, lam)

    def solve(self, data, lin, lam=0.0):
        Ax0, bh = self._base_ax(data, lin)
        p = self._p
        dx, _ = self._factor_solve(Ax0.copy(), bh, lam)
        if not np.all(np.isfinite(dx)):
            return jnp.full((self._N,), jnp.nan, dtype=p.dtype)
        return jnp.asarray(dx, dtype=p.dtype)


def optimize_gn_host(problem, solver, n_iters, lam=0.0):
    """Minimum-round-trip host-GN driver for the hybrid solver.

    Per iteration exactly ONE device→host fetch (linearize + H/b assembly
    fused into a single jit) and ONE host→device push (dx into the fused
    apply jit) — per-transfer latency, not the factor time, dominates a
    10k-dim hybrid step.  ``lam`` adds constant Tikhonov
    damping (0 = pure GN, the reference gn_var,
    ``optimization_algorithm_gauss_newton.cpp:50``).

    Returns {"chi2_per_iteration", "chi2_final", "iter_walls", "wall_s"}.
    """
    import time

    p = problem
    if getattr(solver, "_p", None) is not p:
        solver.setup(p)
    step1_jit = solver._step1_jit
    apply_jit = p.apply_jit

    est = p.estimates
    chis = []
    iter_walls = []
    t0 = time.perf_counter()
    for _ in range(n_iters):
        t1 = time.perf_counter()
        diag, off, b, chi2 = jax.device_get(step1_jit(p.data, est))
        chis.append(float(chi2))
        dx, _ = solver._fill_and_solve(diag, off, b, lam)
        if not np.all(np.isfinite(dx)):
            iter_walls.append(time.perf_counter() - t1)
            break
        est = apply_jit(p.data, est, jnp.asarray(dx, dtype=p.dtype))
        iter_walls.append(time.perf_counter() - t1)
    wall = time.perf_counter() - t0
    chi2_final, _ = jax.device_get(p.chi2_jit(p.data, est))
    p.set_estimates(est)
    return {"chi2_per_iteration": chis, "chi2_final": float(chi2_final),
            "iter_walls": iter_walls, "wall_s": wall,
            "iterations": len(iter_walls)}
