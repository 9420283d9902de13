"""Supernodal multifrontal block-sparse Cholesky — the batched-array
formulation of the reference's CHOLMOD supernodal mode
(``g2o/solvers/cholmod``, ``linear_solver_cholmod.h:76``; SURVEY.md §7.3).

The plain level-scheduled solver (``sparse_chol.py``) factors one block
*column* at a time: the elimination tree of a pose graph is ~200+ levels
deep with a median of 2 columns per level — almost fully serial and every
step is a tiny (d, d) op.  Supernodal factorization amalgamates contiguous
columns with (nearly) identical structure into *supernodes* and processes
each as one dense panel.

**Multifrontal, frontal-form factor.**  A numeric phase that keeps the
factor in a global block-slot array and scatter-adds every supernode's
outer-product update to its ancestors' slots directly moves, at
sphere2500, ~231k (d, d) scatter rows plus ~134k set rows and ~120k gather
rows per factorization — all memory traffic, no arithmetic.  The
multifrontal formulation eliminates essentially all of it:

* **frontal matrices**: supernode S owns a dense frontal F_S over the index
  set cols(S) ++ R(S).  The closure ``propagate_rowsets`` already
  guarantees R(S) ⊆ cols(parent) ∪ R(parent) — the multifrontal invariant —
  so S's update matrix extend-adds into the PARENT's frontal only, never
  into arbitrary ancestors.
* **one flat assembly array**: H blocks scatter ONCE per edge-type into a
  single flat (T, d, d) frontal-slot array (host-precomputed flat ids);
  per-group frontal panels are then STATIC slices + reshapes, not gathers.
* **extend-add as matmuls**: the child→parent index mapping is a
  block-level one-hot E (built on device from a small int array), and the
  update flows as E·U·Eᵀ — two batched HIGHEST matmuls; the only remaining
  scatter places whole (fp·d, fp·d) slabs at one index per CHILD
  (~#supernodes serialized steps instead of ~Σ mp² — 154 vs 231,350 at
  sphere2500).
* **frontal-form solve**: the triangular sweeps consume the per-group dense
  (L_D, P) factors directly; only the (n, d) rhs is gathered/scattered by
  block row (Σ sp + Σ mp ≈ 7.5k rows, vs ~80k block-panel gather rows
  before).

* **host symbolic phase** (numpy, once per graph pattern): fill-reducing
  ordering + elimination tree + exact column structure (reused from
  ``sparse_chol.symbolic_factorization``, native C++ path); fundamental
  supernode detection; CHOLMOD-style relaxed amalgamation; quotient-etree
  rowset closure; level schedule bucketed by padded panel shape; flat
  frontal-slot layout + per-edge assembly ids + child→parent extend-add
  maps.

The LM damping contract (``g2o/core/solver.h:80-93``) is the same as the
plain solver: the numeric phase re-runs with ``lam`` on the diagonal; the
symbolic phase is reused across iterations (the analogue of the
reference's symbolic-analysis reuse, ``linear_solver_cholmod.h:248+``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from g2o_tpu.core.solvers.sparse_chol import symbolic_factorization


# --------------------------------------------------------------------- #
# host symbolic machinery
# --------------------------------------------------------------------- #

def supernode_partition(sym, *, smax: int = 24, zeta: float = 0.35):
    """Partition the (permuted) columns into supernodes.

    1. fundamental supernodes: maximal chains where column j extends the
       dense diagonal of j-1 (``parent[j-1] == j`` and
       ``struct(j) == struct(j-1) \\ {j}``);
    2. relaxed amalgamation: merge supernode s into the NEXT supernode p
       when p is its quotient-etree parent (``parent[last(s)] == first(p)``),
       the merged width stays <= ``smax`` and the fraction of explicit
       zeros introduced stays <= ``zeta`` (CHOLMOD's relaxation rule).

    Returns ``(starts, rowsets)`` — supernode k spans permuted columns
    ``[starts[k], starts[k+1])`` and has below-panel block rows
    ``rowsets[k]`` (sorted np.int64, all > last member column; closure
    under the quotient etree is applied by the caller)."""
    n = len(sym["rows"])
    if n == 0:
        return np.zeros(1, dtype=np.int64), []
    parent = sym["parent"]
    rows = sym["rows"]

    # --- fundamental partition ---
    starts = [0]
    for j in range(1, n):
        prev = rows[j - 1]
        fund = (parent[j - 1] == j
                and len(rows[j]) == len(prev) - 1
                and (j - starts[-1]) < smax
                and np.array_equal(rows[j], prev[prev != j]))
        if not fund:
            starts.append(j)
    starts.append(n)
    starts = np.asarray(starts, dtype=np.int64)

    # member rowsets (union of original structs minus members)
    def sn_rows(c0, c1):
        u = np.unique(np.concatenate([rows[j] for j in range(c0, c1)])) \
            if c1 > c0 else np.empty(0, dtype=np.int64)
        return u[u >= c1].astype(np.int64)

    sN = len(starts) - 1
    c0s = starts[:-1]
    c1s = starts[1:]
    rsets = [sn_rows(int(a), int(b)) for a, b in zip(c0s, c1s)]

    # --- relaxed amalgamation (greedy, left to right) ---
    # merge supernode k into k+1 when k+1 is the etree parent and the
    # padding cost is acceptable
    out_starts = [0]
    out_rows = []
    k = 0
    cur0, cur1 = int(c0s[0]), int(c1s[0])
    curR = rsets[0]
    while k + 1 < sN:
        n0, n1 = int(c0s[k + 1]), int(c1s[k + 1])
        nR = rsets[k + 1]
        is_parent = (len(curR) > 0 and n0 <= int(curR[0]) < n1)
        if is_parent:
            s_a, s_b = cur1 - cur0, n1 - n0
            m_a, m_b = len(curR), len(nR)
            mergedR = np.union1d(curR[curR >= n1], nR)
            s_m = s_a + s_b
            m_m = len(mergedR)
            nnz_before = (s_a * (s_a + 1) // 2 + s_a * m_a
                          + s_b * (s_b + 1) // 2 + s_b * m_b)
            nnz_after = s_m * (s_m + 1) // 2 + s_m * m_m
            ok_fill = (nnz_after - nnz_before) <= zeta * nnz_after
            if s_m <= smax and ok_fill:
                cur1 = n1
                curR = mergedR
                k += 1
                continue
        out_starts.append(cur1)
        out_rows.append(curR)
        cur0, cur1, curR = n0, n1, nR
        k += 1
    out_starts.append(cur1)
    out_rows.append(curR)
    return np.asarray(out_starts, dtype=np.int64), out_rows


def propagate_rowsets(starts: np.ndarray, rowsets: list):
    """Quotient-etree fill propagation: R(S) flows into the parent
    supernode P = supernode(min R(S)) as ``R(S) \\ cols(P)`` — after this
    the pattern is closed under the supernodal update rule (every pair of
    rows of a panel maps into the parent's frontal index set — the
    multifrontal extend-add invariant)."""
    sN = len(rowsets)
    if sN == 0:
        return rowsets, np.full(0, -1, dtype=np.int64)
    n = int(starts[-1])
    sn_of_col = np.empty(n, dtype=np.int64)
    for k in range(sN):
        sn_of_col[starts[k]:starts[k + 1]] = k
    parent_sn = np.full(sN, -1, dtype=np.int64)
    rowsets = [r.copy() for r in rowsets]
    for k in range(sN):
        R = rowsets[k]
        if len(R) == 0:
            continue
        p = int(sn_of_col[int(R[0])])
        parent_sn[k] = p
        passup = R[R >= int(starts[p + 1])]
        if len(passup):
            rowsets[p] = np.union1d(rowsets[p], passup)
    return rowsets, parent_sn


def _bucket(x: int, buckets):
    for b in buckets:
        if x <= b:
            return b
    return buckets[-1]


def build_supernodal_schedule(sym, *, d: int, smax: int = 24,
                              zeta: float = 0.35):
    """Full symbolic pipeline: partition, closure, level/bucket schedule,
    flat frontal-slot layout, extend-add maps.

    Returns ``(aux_sched, static, meta)``:

    * ``aux_sched`` — pytree of device index arrays (travels through
      ``solver.aux``): ``levels`` (list per level of list per group of
      ``{cols, rows}``) and ``pairs`` (list of ``{cidx, pidx, rel}``).
    * ``static`` — host-side schedule skeleton (python ints only, safe as
      closure constants): per-group shapes/offsets, level grouping, pair
      group ids, flat-slot total, and the ``fpos`` lookup used to map H
      blocks to frontal slots.
    * ``meta`` — facts for introspection/tests (n, nnz, level count …).
    """
    n = len(sym["rows"])
    starts, rowsets = supernode_partition(sym, smax=smax, zeta=zeta)
    rowsets, parent_sn = propagate_rowsets(starts, rowsets)
    sN = len(rowsets)
    sp = (starts[1:] - starts[:-1]).astype(np.int64)
    mp = np.asarray([len(r) for r in rowsets], dtype=np.int64)

    sn_of_col = np.empty(n, dtype=np.int64)
    for k in range(sN):
        sn_of_col[starts[k]:starts[k + 1]] = k

    # supernode depths over the quotient etree
    depth = np.zeros(sN, dtype=np.int64)
    for k in range(sN):
        p = parent_sn[k]
        if p >= 0:
            depth[p] = max(depth[p], depth[k] + 1)
    L = int(depth.max()) + 1 if sN else 0

    # (level, sp-bucket, mp-bucket) groups
    s_buckets = sorted({_bucket(int(x), [1, 2, 4, 8, 16, smax])
                        for x in sp}) if sN else []
    m_buckets = [0, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 4096, 1 << 20]
    groups: list[dict] = []
    levels_gi: list[list[int]] = []
    group_of = np.empty((sN, 2), dtype=np.int64)      # (gi, pos)
    for li in range(L):
        sns = np.nonzero(depth == li)[0]
        buckets: dict = {}
        for k in sns:
            key = (_bucket(int(sp[k]), s_buckets),
                   _bucket(int(mp[k]), m_buckets))
            buckets.setdefault(key, []).append(int(k))
        gis = []
        for (spb, mpb), ks in sorted(buckets.items()):
            gi = len(groups)
            for pos, k in enumerate(ks):
                group_of[k] = (gi, pos)
            groups.append(dict(level=li, spb=spb, mpb=mpb, S=len(ks),
                               ks=ks))
            gis.append(gi)
        levels_gi.append(gis)

    # flat frontal-slot offsets (block units): group slab is
    # (S, fp, fp) with fp = spb + mpb; slot (pos, fa, fb) lives at
    # off + (pos*fp + fa)*fp + fb
    acc_T = 0
    for g in groups:
        g["off"] = acc_T
        fp = g["spb"] + g["mpb"]
        acc_T += g["S"] * fp * fp

    # frontal-position lookup: key k*n + r -> fpos (cols first, R at the
    # PADDED offset spb so static region slicing works)
    keys = []
    fposs = []
    for k in range(sN):
        gi = int(group_of[k, 0])
        spb = groups[gi]["spb"]
        c0, c1 = int(starts[k]), int(starts[k + 1])
        cs = np.arange(c0, c1, dtype=np.int64)
        keys.append(k * n + cs)
        fposs.append(cs - c0)
        if mp[k]:
            keys.append(k * n + rowsets[k])
            fposs.append(spb + np.arange(mp[k], dtype=np.int64))
    keys = np.concatenate(keys) if keys else np.empty(0, np.int64)
    fposs = np.concatenate(fposs) if fposs else np.empty(0, np.int64)
    order = np.argsort(keys)
    keys = keys[order]
    fposs = fposs[order]

    g_off = np.asarray([g["off"] for g in groups], dtype=np.int64)
    g_fp = np.asarray([g["spb"] + g["mpb"] for g in groups], dtype=np.int64)
    g_pos = group_of[:, 1]
    g_gi = group_of[:, 0]

    def flat_slot(i, j):
        """Flat frontal-slot ids for lower H blocks (row i >= col j, both
        permuted block indices; vectorized)."""
        i = np.asarray(i, dtype=np.int64)
        j = np.asarray(j, dtype=np.int64)
        k = sn_of_col[j]
        fa = fposs[np.searchsorted(keys, k * n + i)]
        fb = j - starts[k]
        gi = g_gi[k]
        fp = g_fp[gi]
        return g_off[gi] + (g_pos[k] * fp + fa) * fp + fb

    # extend-add maps, grouped by (child group, parent group)
    pair_map: dict = {}
    for k in range(sN):
        p = int(parent_sn[k])
        if p < 0 or mp[k] == 0:
            continue
        cg, cpos = int(group_of[k, 0]), int(group_of[k, 1])
        pg, ppos = int(group_of[p, 0]), int(group_of[p, 1])
        R = rowsets[k]
        spb_p = groups[pg]["spb"]
        c1p = int(starts[p + 1])
        rel = np.where(
            R < c1p, R - int(starts[p]),
            spb_p + np.searchsorted(rowsets[p], R))
        mp_cb = groups[cg]["mpb"]
        rel_pad = np.full(mp_cb, -1, dtype=np.int64)
        rel_pad[:len(R)] = rel
        pair_map.setdefault((cg, pg), []).append((cpos, ppos, rel_pad))

    pairs_static = []
    pairs_aux = []
    for (cg, pg), entries in sorted(pair_map.items()):
        cidx = np.asarray([e[0] for e in entries], dtype=np.int64)
        pidx = np.asarray([e[1] for e in entries], dtype=np.int64)
        rel = np.stack([e[2] for e in entries])
        pairs_static.append(dict(cg=cg, pg=pg))
        pairs_aux.append(dict(cidx=jnp.asarray(cidx),
                              pidx=jnp.asarray(pidx),
                              rel=jnp.asarray(rel)))

    # per-group cols/rows arrays, nested per level (the structure the
    # solve sweeps walk; also reused as factor-time masks)
    levels_aux = []
    for gis in levels_gi:
        lv = []
        for gi in gis:
            g = groups[gi]
            S, spb, mpb = g["S"], g["spb"], g["mpb"]
            cols_g = np.full((S, spb), -1, dtype=np.int64)
            rows_g = np.full((S, mpb), -1, dtype=np.int64)
            for pos, k in enumerate(g["ks"]):
                c0, c1 = int(starts[k]), int(starts[k + 1])
                cols_g[pos, :c1 - c0] = np.arange(c0, c1)
                if mp[k]:
                    rows_g[pos, :mp[k]] = rowsets[k]
            lv.append(dict(cols=jnp.asarray(cols_g),
                           rows=jnp.asarray(rows_g)))
        levels_aux.append(lv)

    nnz = int(sum(int(sp[k]) * (int(sp[k]) - 1) // 2
                  + int(sp[k]) * int(mp[k]) for k in range(sN)))
    static = dict(groups=groups, levels=levels_gi, pairs=pairs_static,
                  acc_T=acc_T, flat_slot=flat_slot, n=n)
    meta = dict(n=n, d=d, nnz=nnz, n_levels=L, n_supernodes=sN,
                starts=starts, rowsets=rowsets)
    return dict(levels=levels_aux, pairs=pairs_aux), static, meta


# --------------------------------------------------------------------- #
# device numeric phase
# --------------------------------------------------------------------- #

def _strict_lower_block_mask(sp: int, d: int, dtype):
    """(sp*d, sp*d) scalar mask of the strictly-lower BLOCK triangle."""
    m = np.kron(np.tril(np.ones((sp, sp)), -1), np.ones((d, d)))
    return jnp.asarray(m, dtype=dtype)


_HI = jax.lax.Precision.HIGHEST


# Batched dense kernels of the numeric phase.  On the GPU XLA hands them to
# cuSOLVER / cuBLAS, which factor and solve in full f32 at every panel size
# (the supernodal fronts reach sd = smax·d = 144 at sphere2500, the chunk2
# coarse system a few thousand columns).

def _chol_batched(D):
    """Batched lower Cholesky of (S, sd, sd)."""
    return jnp.linalg.cholesky(D)


def _solve_lower_batched(L, B):
    """Solve L Y = B (L (S, sd, sd) lower, B (S, sd, m))."""
    return jax.scipy.linalg.solve_triangular(L, B, lower=True)


def _solve_upper_batched(L, B):
    """Solve L^T Y = B with L lower — the backward sweep."""
    return jax.scipy.linalg.solve_triangular(L, B, lower=True, trans=1)


def factorize_frontal(ACC, aux, static, d: int, lam, gfixed_p, gvalid_p):
    """Multifrontal numeric factorization.

    ``ACC``: flat (acc_T, d, d) frontal-slot array holding the assembled
    LOWER H blocks (diagonal blocks full).  ``gfixed_p``/``gvalid_p``:
    per-permuted-block fixed flags (n,) and valid-dim masks (n, d).
    Returns ``factors`` — per level, per group ``(Ld, Pm)`` dense panels
    matching ``aux['levels']``'s structure."""
    dtype = ACC.dtype
    groups = static["groups"]
    pairs_by_child: dict = {}
    for ps, pa in zip(static["pairs"], aux["pairs"]):
        pairs_by_child.setdefault(ps["cg"], []).append((ps, pa))

    pending: dict = {}
    factors = []
    for li, gis in enumerate(static["levels"]):
        lv_f = []
        for gj, gi in enumerate(gis):
            g = groups[gi]
            ga = aux["levels"][li][gj]
            S, spb, mpb = g["S"], g["spb"], g["mpb"]
            fp = spb + mpb
            spd, fpd = spb * d, fp * d
            # static slice of the flat assembly array -> dense frontals
            slab = ACC[g["off"]:g["off"] + S * fp * fp]
            slab = slab.reshape(S, fp, fp, d, d).transpose(0, 1, 3, 2, 4)
            slab = slab.reshape(S, fpd, fpd)
            pend = pending.pop(gi, None)

            # diagonal region: mirror H's strict-lower block triangle
            # (assembly wrote lower only), then add the FULL-symmetric
            # pending child updates
            D = slab[:, :spd, :spd]
            low = _strict_lower_block_mask(spb, d, dtype)
            D = D + (D * low).swapaxes(-1, -2)
            if pend is not None:
                D = D + pend[:, :spd, :spd]
            # λ on valid non-fixed tangent dims; unit diagonal on fixed
            # rows, padding dims and padded columns (H is zero there —
            # fixed slots are masked at linearize)
            cols = ga["cols"]
            safe = jnp.maximum(cols, 0)
            colmask = (cols >= 0)
            fx = gfixed_p[safe] & colmask                  # (S, spb)
            vm = gvalid_p[safe] * colmask[..., None].astype(dtype)
            dadd = jnp.where(fx[..., None], jnp.asarray(1.0, dtype),
                             lam * vm + (1.0 - vm))
            eye = jnp.eye(spd, dtype=dtype)
            D = D + eye[None] * dadd.reshape(S, spd)[:, :, None]
            Ld = jnp.tril(_chol_batched(D))

            if mpb == 0:
                lv_f.append((Ld, jnp.zeros((S, 0, spd), dtype=dtype)))
                continue

            P = slab[:, spd:, :spd]
            if pend is not None:
                P = P + pend[:, spd:, :spd]
            Pt = _solve_lower_batched(Ld, jnp.swapaxes(P, -1, -2))
            cm = jnp.repeat(colmask, d, axis=1).astype(dtype)   # (S, spd)
            rowmask = jnp.repeat(ga["rows"] >= 0, d,
                                 axis=1).astype(dtype)          # (S, mpd)
            Pm = jnp.swapaxes(Pt, -1, -2) * cm[:, None, :] \
                * rowmask[:, :, None]
            lv_f.append((Ld, Pm))

            # update matrix: panel outer product + inherited (R×R) part
            # (H never lands there — those blocks belong to ancestors)
            U = jnp.einsum("sik,sjk->sij", Pm, Pm, precision=_HI)
            if pend is not None:
                U = U - pend[:, spd:, spd:]

            # extend-add into parents: E U Eᵀ as two batched HIGHEST
            # matmuls + ONE whole-slab scatter index per child
            for ps, pa in pairs_by_child.get(gi, ()):
                pg = ps["pg"]
                gp = groups[pg]
                fpp = gp["spb"] + gp["mpb"]
                fppd = fpp * d
                Usub = U[pa["cidx"]]                  # (Sc, mpd, mpd)
                Sc = Usub.shape[0]
                E1 = (pa["rel"][..., None]
                      == jnp.arange(fpp)[None, None, :]).astype(dtype)
                Ub = Usub.reshape(Sc, mpb, d, mpb, d)
                T1 = jnp.einsum("sxf,sxiyj->sfiyj", E1, Ub, precision=_HI)
                T2 = jnp.einsum("syg,sfiyj->sfigj", E1, T1, precision=_HI)
                contrib = T2.reshape(Sc, fppd, fppd)
                acc = pending.get(pg)
                if acc is None:
                    acc = jnp.zeros((gp["S"], fppd, fppd), dtype=dtype)
                pending[pg] = acc.at[pa["pidx"]].add(-contrib)
        factors.append(lv_f)
    return factors


def solve_supernodal(factors, b, levels, d: int):
    """L L^T x = b with the frontal-form factor.  ``factors``: nested
    per-level/per-group ``(Ld, Pm)`` (the output of
    :func:`factorize_frontal`); ``levels``: matching nested
    ``{cols, rows}`` index arrays; ``b``: (n, d) permuted block rhs."""
    dtype = b.dtype
    n = b.shape[0]

    def gather_rhs(grid):                   # (S, P) block ids -> (S, P*d)
        S, P = grid.shape
        safe = jnp.maximum(grid, 0)
        g = b[safe.reshape(-1)].reshape(S, P, d)
        g = g * (grid >= 0).astype(dtype)[..., None]
        return g.reshape(S, P * d)

    def scatter_rhs(b, grid, dense, *, add=False):
        S, P = grid.shape
        vals = dense.reshape(-1, d)
        safe = jnp.where((grid >= 0).reshape(-1), grid.reshape(-1), n)
        return (b.at[safe].add(vals, mode="drop") if add
                else b.at[safe].set(vals, mode="drop"))

    # forward: per level ascending — y_S = L_SS^{-1} b_S; b_R -= P y_S
    for lv_f, lv_a in zip(factors, levels):
        for (Ld, Pm), ga in zip(lv_f, lv_a):
            cm = jnp.repeat(ga["cols"] >= 0, d, axis=1).astype(dtype)
            rhs = gather_rhs(ga["cols"])
            y = _solve_lower_batched(Ld, rhs[..., None])[..., 0] * cm
            b = scatter_rhs(b, ga["cols"], y)
            if Pm.shape[1]:
                contrib = jnp.einsum("smk,sk->sm", Pm, y, precision=_HI)
                b = scatter_rhs(b, ga["rows"], -contrib, add=True)

    # backward: per level descending — x_S = L_SS^{-T}(y_S - P^T x_R)
    for lv_f, lv_a in zip(reversed(factors), reversed(levels)):
        for (Ld, Pm), ga in zip(lv_f, lv_a):
            cm = jnp.repeat(ga["cols"] >= 0, d, axis=1).astype(dtype)
            rhs = gather_rhs(ga["cols"])
            if Pm.shape[1]:
                xr = gather_rhs(ga["rows"])
                rhs = rhs - jnp.einsum("smk,sm->sk", Pm, xr, precision=_HI)
            x = _solve_upper_batched(Ld, rhs[..., None])[..., 0] * cm
            b = scatter_rhs(b, ga["cols"], x)
    return b


# --------------------------------------------------------------------- #
# solver class
# --------------------------------------------------------------------- #

class SupernodalCholeskySolver:
    """Direct supernodal multifrontal block-Cholesky solver — the
    CHOLMOD-class direct solver.  Symbolic analysis + amalgamation run
    once at setup; each ``solve`` re-runs the batched dense numeric phase
    with the current lambda.  Mixed vertex types ride global block ids
    with top-left padding to the max tangent dim (CHOLMOD covers this with
    variable block sizes, ``linear_solver_cholmod.h:76``); n-ary edges
    contribute one H block per slot pair (``block_solver.hpp:142-214``)."""

    name = "supernodal"

    def __init__(self, *, smax: int = 24, zeta: float = 0.35,
                 min_separator_size: int = 32, refine: int = 1):
        self.smax = int(smax)
        self.zeta = float(zeta)
        self.min_size = int(min_separator_size)
        # mixed-precision iterative-refinement sweeps: in f32 (the usual
        # device dtype) the factorization of an ill-conditioned pose-graph
        # Hessian carries a ~1e-2 relative solve error; each sweep reuses
        # the factor plus one matrix-free H·v to shrink it (the classic
        # refinement loop; residual cost << factorization cost)
        self.refine = int(refine)
        self.aux = ()
        self._solve_fn = None
        self._solve_jit = None

    def setup(self, problem):
        p = problem
        tnames = list(p.vertex_types)
        dims = {t: p.vertex_types[t].tangent_dim for t in tnames}
        d = max(dims.values())               # padded uniform block dim
        base = {}
        acc = 0
        for t in tnames:
            base[t] = acc
            acc += p.counts[t]
        n = acc

        # block pattern: ALL vertex pairs of every edge (n-ary included) on
        # global block ids across types — mixed types ride the uniform
        # batched schedule via top-left padding (the same scheme
        # ``SparseCholeskySolver`` uses; the reference covers this with
        # CHOLMOD's variable block sizes, ``linear_solver_cholmod.h:76``)
        pair_set = set()
        slot_pairs = {name: [(a, b)
                             for a in range(et.num_slots)
                             for b in range(a + 1, et.num_slots)]
                      for name, et in p.edge_types.items()}
        for name, et in p.edge_types.items():
            vidx = np.asarray(p.data.edges[name].vidx)
            for a, b in slot_pairs[name]:
                ga = base[et.vertex_types[a].name] + vidx[:, a]
                gb = base[et.vertex_types[b].name] + vidx[:, b]
                lo = np.minimum(ga, gb)
                hi = np.maximum(ga, gb)
                m = lo != hi
                pair_set.update(zip(lo[m].tolist(), hi[m].tolist()))
        pairs = np.asarray(sorted(pair_set), dtype=np.int64).reshape(-1, 2)

        sym = symbolic_factorization(n, pairs, min_size=self.min_size)
        aux_sched, static, meta = build_supernodal_schedule(
            sym, d=d, smax=self.smax, zeta=self.zeta)
        self.meta = meta
        self._static = static
        inv = sym["inv"].astype(np.int64)
        acc_T = static["acc_T"]
        flat_slot = static["flat_slot"]

        # per-(edge type, slot) diagonal assembly ids and per-(edge type,
        # slot pair) off-diagonal assembly ids into the flat frontal-slot
        # array (ONE scatter per edge array — the reference assembles into
        # CHOLMOD's column-major slots the same once-per-block way,
        # ``block_solver.hpp:142-214``)
        asm_diag = {}
        asm_off = {}
        asm_self = {}
        for name, et in p.edge_types.items():
            vidx = np.asarray(p.data.edges[name].vidx)
            for s in range(et.num_slots):
                gi = base[et.vertex_types[s].name] + vidx[:, s]
                i = inv[gi]
                asm_diag[(name, s)] = jnp.asarray(flat_slot(i, i))
            for a, b in slot_pairs[name]:
                ga = base[et.vertex_types[a].name] + vidx[:, a]
                gb = base[et.vertex_types[b].name] + vidx[:, b]
                i = inv[ga]
                j = inv[gb]
                valid = ga != gb
                lo = np.where(valid, np.minimum(i, j), 0)
                hi = np.where(valid, np.maximum(i, j), 1)
                slots = np.where(valid, flat_slot(hi, lo), acc_T)  # OOB→drop
                transpose = i < j
                asm_off[(name, a, b)] = (jnp.asarray(slots),
                                         jnp.asarray(transpose))
                # both slots bind the SAME vertex: H_ab + H_abᵀ belongs to
                # its DIAGONAL frontal slot (rare; extra scatter only when
                # present — dense_hessian_fn accumulates it there too)
                if (~valid).any():
                    asm_self[(name, a, b)] = jnp.asarray(
                        np.where(valid, acc_T, flat_slot(i, i)))

        # global fixed mask + per-slot validity, PERMUTED block order
        fixed_np = np.zeros(n, dtype=bool)
        valid_np = np.zeros((n, d), dtype=np.float64)
        for t in tnames:
            fixed_np[base[t]:base[t] + p.counts[t]] = \
                np.asarray(p.data.fixed[t])
            valid_np[base[t]:base[t] + p.counts[t], :dims[t]] = 1.0
        perm = np.asarray(sym["perm"])
        dtype = p.dtype
        self.aux = dict(levels=aux_sched["levels"],
                        pairs=aux_sched["pairs"],
                        perm=jnp.asarray(perm),
                        asm_diag=asm_diag, asm_off=asm_off,
                        asm_self=asm_self,
                        gfixed=jnp.asarray(fixed_np[perm]),
                        gvalid=jnp.asarray(valid_np[perm], dtype=dtype))

        def _pad_block(M):
            a, b = M.shape[-2], M.shape[-1]
            if a == d and b == d:
                return M
            return jnp.pad(M, ((0, 0), (0, d - a), (0, d - b)))

        def assemble_and_factor(data, lin, lam, aux):
            # every H einsum at HIGHEST: the DEFAULT precision is TF32 on
            # the GPU (~1e-3 relative) — enough to make trailing blocks of
            # an ill-conditioned pose-graph Hessian indefinite after the
            # frontal updates (NaN factors)
            ACC = jnp.zeros((acc_T, d, d), dtype=dtype)
            for name, et in p.edge_types.items():
                Js = p.edge_jacs(lin, name)
                W = p.edge_weights(lin, name)
                for s in range(et.num_slots):
                    Hss = jnp.einsum("erd,ers,esf->edf", Js[s], W, Js[s],
                                     precision=_HI)
                    ACC = ACC.at[aux["asm_diag"][(name, s)]].add(
                        _pad_block(Hss))
                for a, b in slot_pairs[name]:
                    Hab = _pad_block(jnp.einsum("erd,ers,esf->edf", Js[a],
                                                W, Js[b], precision=_HI))
                    slots, transpose = aux["asm_off"][(name, a, b)]
                    HabT = jnp.swapaxes(Hab, -1, -2)
                    ACC = ACC.at[slots].add(
                        jnp.where(transpose[:, None, None], HabT, Hab),
                        mode="drop")
                    sids = aux["asm_self"].get((name, a, b))
                    if sids is not None:
                        # same-vertex slot pair -> diagonal frontal slot
                        ACC = ACC.at[sids].add(Hab + HabT, mode="drop")
            return factorize_frontal(ACC, aux, static, d, lam,
                                     aux["gfixed"], aux["gvalid"])

        n_refine = self.refine

        def solve(data, lin, lam, aux):
            factors = assemble_and_factor(data, lin, lam, aux)
            bb = p.split_tangent(lin.b)
            bfull = jnp.zeros((n, d), dtype=dtype)
            for t in tnames:
                bfull = bfull.at[base[t]:base[t] + p.counts[t],
                                 :dims[t]].set(bb[t])
            xperm = solve_supernodal(factors, bfull[aux["perm"]],
                                     aux["levels"], d)
            x = jnp.zeros_like(xperm).at[aux["perm"]].set(xperm)
            if n_refine:
                # exact-f32 H·v for the refinement residual: at DEFAULT
                # precision the GPU's einsums run in TF32 (~1e-3 relative),
                # turning the correction into rounding noise
                hvp = p.hvp_operator(data, lin, precision=_HI)
                for _ in range(n_refine):
                    xb = {t: x[base[t]:base[t] + p.counts[t], :dims[t]]
                          for t in tnames}
                    hv = hvp(xb)
                    # padding slots: unit diagonal, b = 0, x = 0 -> r = 0
                    rfull = jnp.zeros_like(bfull)
                    for t in tnames:
                        fxt = data.fixed[t].astype(dtype)[:, None]
                        # r = b - (H + lam I) x (identity rows on fixed)
                        Ax = hv[t] + lam * xb[t] * (1.0 - fxt) + xb[t] * fxt
                        rfull = rfull.at[base[t]:base[t] + p.counts[t],
                                         :dims[t]].set(bb[t] - Ax)
                    dperm = solve_supernodal(factors, rfull[aux["perm"]],
                                             aux["levels"], d)
                    x = x + jnp.zeros_like(x).at[aux["perm"]].set(dperm)
            return p.join_tangent(
                {t: x[base[t]:base[t] + p.counts[t], :dims[t]]
                 for t in tnames})

        self._factor_fn = assemble_and_factor
        self._solve_fn = solve
        self._solve_jit = jax.jit(solve)
        return self

    def solve(self, data, lin, lam=0.0):
        return self._solve_jit(data, lin, lam, self.aux)
