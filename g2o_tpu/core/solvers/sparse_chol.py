"""Block-sparse Cholesky solver — the batched-array formulation of the
reference's
CSparse/CHOLMOD direct solvers (``g2o/solvers/csparse``, ``solvers/cholmod``,
SURVEY.md §7.3 "the riskiest kernel").

Architecture (uniform block dimension d, e.g. SE2=3 / SE3=6 pose graphs):

* **host symbolic phase** (numpy, once per graph pattern — the analogue of
  the reference's symbolic AMD analysis reused across iterations,
  ``linear_solver_csparse.h:71``):
  - fill-reducing ordering: recursive BFS-separator nested dissection
    (band orderings like RCM degenerate the elimination tree to a path,
    serializing the level schedule);
  - symbolic factorization on the block pattern (elimination-tree based
    fill computation);
  - *level schedule*: columns grouped by elimination-tree height — columns
    in a level factor concurrently, their right-looking updates
    accumulate with segment-sums (replacing CSparse's sequential
    up-looking loop);
  - per-level padded index arrays (factor blocks, update triples
    (src_i, src_k, dst)) shipped to the device via ``solver.aux``.

* **device numeric phase** (one jitted program): `lax.fori_loop` over
  levels; per level batched ``cholesky`` of diagonal blocks, batched
  triangular solves of that level's column blocks, batched outer-product
  updates scattered by segment-sum.  Forward/backward substitution reuse
  the same schedule.

The reference's LM diagonal-damping contract (``solver.h:80-93``) maps to
re-running the numeric phase with ``lam`` added to the diagonal blocks —
the symbolic phase is unchanged.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


# --------------------------------------------------------------------- #
# host symbolic machinery
# --------------------------------------------------------------------- #

def _nested_dissection(adj: list, nodes: np.ndarray, min_size: int = 32):
    """Recursive BFS-layer separator ordering; returns node order (list).
    Children first, separator last — ancestors of both halves."""
    n = len(nodes)
    if n <= min_size:
        return list(nodes)
    nodeset = set(int(x) for x in nodes)
    # BFS from an eccentric node
    start = int(nodes[0])
    for _ in range(2):
        layers = _bfs_layers(adj, start, nodeset)
        start = layers[-1][-1]
    layers = _bfs_layers(adj, start, nodeset)
    if len(layers) < 3:
        return list(nodes)
    # separator = middle layer
    mid = len(layers) // 2
    sep = set(layers[mid])
    part_a = [v for layer in layers[:mid] for v in layer]
    part_b = [v for layer in layers[mid + 1:] for v in layer]
    covered = sep | set(part_a) | set(part_b)
    # disconnected leftovers go to part_a
    part_a += [v for v in nodeset if v not in covered]
    order = []
    if part_a:
        order += _nested_dissection(adj, np.asarray(part_a), min_size)
    if part_b:
        order += _nested_dissection(adj, np.asarray(part_b), min_size)
    order += sorted(sep)
    return order


def _bfs_layers(adj, start, nodeset):
    seen = {start}
    layers = [[start]]
    while True:
        nxt = []
        for v in layers[-1]:
            for w in adj[v]:
                if w in nodeset and w not in seen:
                    seen.add(w)
                    nxt.append(w)
        if not nxt:
            break
        layers.append(nxt)
    return layers


def _fill_from_perm(n: int, pairs: np.ndarray, perm: np.ndarray):
    """Pure-Python symbolic fill for a GIVEN ordering (the classic
    struct-merge algorithm).  Returns (parent, depth, colptr, rows_flat)."""
    inv = np.empty(n, dtype=np.int32)
    inv[perm] = np.arange(n, dtype=np.int32)          # old id -> new k

    # column structures in permuted space: struct[j] starts as neighbours
    # > j; eliminate columns in order, merging struct[j] \ {min} into
    # struct[parent]
    struct = [set() for _ in range(n)]
    for a, b in pairs:
        i, j = inv[int(a)], inv[int(b)]
        if i < j:
            i, j = j, i
        struct[j].add(int(i))          # rows below the diagonal of col j
    parent = np.full(n, -1, dtype=np.int32)
    for j in range(n):
        if struct[j]:
            p = min(struct[j])
            parent[j] = p
            struct[p].update(x for x in struct[j] if x != p)

    depth = np.zeros(n, dtype=np.int32)
    for j in range(n):
        p = parent[j]
        if p >= 0:
            depth[p] = max(depth[p], depth[j] + 1)

    colptr = np.zeros(n + 1, dtype=np.int64)
    for j in range(n):
        colptr[j + 1] = colptr[j] + len(struct[j])
    rows_flat = np.empty(colptr[-1], dtype=np.int32)
    for j in range(n):
        rows_flat[colptr[j]:colptr[j + 1]] = sorted(struct[j])
    return parent, depth, colptr, rows_flat


def _symbolic_python(n: int, pairs: np.ndarray, min_size: int):
    """Pure-Python symbolic analysis (fallback when the native library is
    unavailable).  Returns (perm, parent, depth, colptr, rows_flat)."""
    adj = [[] for _ in range(n)]
    for a, b in pairs:
        a, b = int(a), int(b)
        adj[a].append(b)
        adj[b].append(a)

    order = _nested_dissection(adj, np.arange(n), min_size=min_size)
    perm = np.asarray(order, dtype=np.int32)          # new k -> old id
    return (perm,) + _fill_from_perm(n, pairs, perm)


def symbolic_factorization(n: int, pairs: np.ndarray, *, min_size: int = 32):
    """Symbolic block Cholesky: fill-reducing ordering, elimination tree,
    exact L structure and etree depths.  Runs in the native C++ module
    (``native/symchol.cpp`` — the analogue of CSparse's ``cs_etree`` /
    ``cs_ereach``, ``g2o/solvers/csparse``) with a pure-Python fallback.

    Args:
      n: number of block columns.
      pairs: (M, 2) unique undirected off-diagonal block pairs.
    Returns a dict with the permutation, the L block structure (flat
    ``colptr``/``rows_flat`` + per-column ``rows`` views) and the level
    schedule (all in PERMUTED indices)."""
    from g2o_tpu import native

    res = native.symbolic_analysis(n, pairs, min_size) if n else None
    if res is not None:
        perm, parent, depth = res["perm"], res["parent"], res["depth"]
        colptr, rows_flat = res["colptr"], res["rows"]
    else:
        perm, parent, depth, colptr, rows_flat = _symbolic_python(
            n, pairs, min_size)

    inv = np.empty(n, dtype=np.int32)
    inv[perm] = np.arange(n, dtype=np.int32)          # old id -> new k

    levels: list[list[int]] = [[] for _ in range(int(depth.max()) + 1
                                                 if n else 0)]
    for j in np.argsort(depth, kind="stable"):
        levels[depth[j]].append(int(j))

    rows = [rows_flat[colptr[j]:colptr[j + 1]] for j in range(n)]
    return {
        "perm": perm, "inv": inv, "parent": parent, "rows": rows,
        "levels": levels, "nnz_blocks": int(colptr[-1]),
        "colptr": colptr, "rows_flat": rows_flat, "depth": depth,
    }


def _pad_by_level(level_of, payload, L, fill=-1):
    """Bucket ``payload`` rows (K, w) by ``level_of`` (K,) into a padded
    (L, maxK, w) array — vectorized (no per-level python loops)."""
    payload = np.asarray(payload)
    K = payload.shape[0]
    if K == 0:
        return np.full((L, 1) + payload.shape[1:], fill, dtype=np.int64)
    order = np.argsort(level_of, kind="stable")
    lv_sorted = level_of[order]
    counts = np.bincount(lv_sorted, minlength=L)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    within = np.arange(K) - starts[lv_sorted]
    out = np.full((L, int(counts.max())) + payload.shape[1:], fill,
                  dtype=np.int64)
    out[lv_sorted, within] = payload[order]
    return out


def build_schedule(sym, d: int):
    """Flatten the symbolic data into padded per-level device arrays —
    fully vectorized (the update-triple count is O(sum |col|^2), far too
    large for python loops at city scale).

    Block storage layout: slot j in [0, n) = diagonal block of column j;
    slot n + e = e-th off-diagonal block (column-major over ``rows``)."""
    n = len(sym["rows"])
    colptr = np.asarray(sym["colptr"], dtype=np.int64)
    rows_flat = np.asarray(sym["rows_flat"], dtype=np.int64)
    depth = np.asarray(sym["depth"], dtype=np.int64)
    nnz = int(colptr[-1])
    L = int(depth.max()) + 1 if n else 0
    lens = colptr[1:] - colptr[:-1]

    # slot -> (row, col) maps
    col_of_off = np.repeat(np.arange(n, dtype=np.int64), lens)
    row_of_slot = np.concatenate([np.arange(n, dtype=np.int64), rows_flat])
    col_of_slot = np.concatenate([np.arange(n, dtype=np.int64), col_of_off])

    # globally-ascending (col, row) key of the off-diagonal slots: rows are
    # sorted per column and slots ordered by column, so searchsorted gives
    # off_slot(i, j) = n + searchsorted(key, j*(n+1)+i)
    key_all = col_of_off * (n + 1) + rows_flat

    def off_slot_v(i, j):
        return n + np.searchsorted(key_all, j * (n + 1) + i)

    def off_slot(i, j):   # scalar convenience (marginals / tests)
        return int(off_slot_v(np.int64(i), np.int64(j)))

    # level membership of columns
    lvl_cols = _pad_by_level(depth, np.arange(n, dtype=np.int64)[:, None], L)
    lvl_cols = lvl_cols[..., 0].astype(np.int32)

    # solves: one per off-diagonal slot (slot, col), level = depth[col]
    solve_payload = np.stack(
        [n + np.arange(nnz, dtype=np.int64), col_of_off], axis=1)
    sv = _pad_by_level(depth[col_of_off], solve_payload, L)

    # update triples: per column j, all ordered pairs (a <= b) over rows(j):
    #   srcA = slot(rows[b], j), srcB = slot(rows[a], j),
    #   dst  = diag slot  when rows[a] == rows[b] (a == b),
    #          off_slot(rows[b], rows[a]) otherwise.
    # vectorized by grouping columns of equal length
    srcA_l, srcB_l, dst_l, lvl_l = [], [], [], []
    for l in np.unique(lens):
        if l == 0:
            continue
        cols_l = np.nonzero(lens == l)[0]                # (C,)
        a, b = np.triu_indices(int(l))                   # (P,)
        base = colptr[cols_l][:, None]                   # (C, 1)
        pa = base + a[None, :]
        pb = base + b[None, :]
        i = rows_flat[pb]
        k = rows_flat[pa]
        dst = np.where(i == k, k, off_slot_v(i, k))
        srcA_l.append((n + pb).ravel())
        srcB_l.append((n + pa).ravel())
        dst_l.append(dst.ravel())
        lvl_l.append(np.repeat(depth[cols_l], len(a)))
    if srcA_l:
        upd_payload = np.stack([np.concatenate(srcA_l),
                                np.concatenate(srcB_l),
                                np.concatenate(dst_l)], axis=1)
        up = _pad_by_level(np.concatenate(lvl_l), upd_payload, L)
    else:
        up = np.full((max(L, 1), 1, 3), -1, dtype=np.int64)
    if sv.shape[0] == 0:
        sv = np.full((max(L, 1), 1, 2), -1, dtype=np.int64)

    return {
        "n": n, "d": d, "nnz": nnz, "L": L,
        "lvl_cols": lvl_cols,
        "solves": sv, "updates": up,
        "col_start": colptr,
        "row_of_slot": row_of_slot,
        "col_of_slot": col_of_slot,
        "off_slot": off_slot,
        "off_slot_v": off_slot_v,
    }


# --------------------------------------------------------------------- #
# device numeric phase
# --------------------------------------------------------------------- #

def factorize(blocks, sched_aux):
    """Numeric level-scheduled block Cholesky.

    ``blocks``: (n + nnz, d, d) — diagonal blocks first (slots [0, n)),
    then off-diagonal blocks L-pattern-aligned (zero where no original
    entry).  Returns the factor in the same layout (L_jj lower-triangular
    in the diagonal slots, L_ij in the off-diagonal slots)."""
    lvl_cols = sched_aux["lvl_cols"]     # (L, C)
    solves = sched_aux["solves"]         # (L, S, 2)
    updates = sched_aux["updates"]       # (L, U, 3)
    n_total = blocks.shape[0]
    d = blocks.shape[-1]
    Lmax = lvl_cols.shape[0]

    def level_body(li, blocks):
        cols = lvl_cols[li]                       # (C,)
        cmask = (cols >= 0)
        csafe = jnp.maximum(cols, 0)
        # 1. factor diagonal blocks of this level's columns
        Dj = blocks[csafe]
        eye = jnp.eye(d, dtype=blocks.dtype)
        Dj = jnp.where(cmask[:, None, None], Dj, eye)
        Lj = jnp.linalg.cholesky(Dj)
        blocks = blocks.at[csafe].set(
            jnp.where(cmask[:, None, None], Lj, blocks[csafe]))

        # 2. column solves: L_ij = A_ij L_jj^{-T}
        sl = solves[li]                           # (S, 2)
        smask = sl[:, 0] >= 0
        s_slot = jnp.maximum(sl[:, 0], 0)
        s_col = jnp.maximum(sl[:, 1], 0)
        Aij = blocks[s_slot]                      # (S, d, d)
        Ljj = blocks[s_col]                       # lower chol of col diag
        # solve X Ljj^T = Aij  =>  X = Aij Ljj^{-T}
        Xt = jax.scipy.linalg.solve_triangular(
            Ljj, jnp.swapaxes(Aij, -1, -2), lower=True)
        X = jnp.swapaxes(Xt, -1, -2)
        X = jnp.where(smask[:, None, None], X, Aij)
        blocks = blocks.at[s_slot].set(X)

        # 3. right-looking updates: dst -= L_a L_b^T
        upd = updates[li]                         # (U, 3)
        umask = (upd[:, 0] >= 0).astype(blocks.dtype)
        a_slot = jnp.maximum(upd[:, 0], 0)
        b_slot = jnp.maximum(upd[:, 1], 0)
        dst = jnp.maximum(upd[:, 2], 0)
        La = blocks[a_slot]
        Lb = blocks[b_slot]
        M = jnp.einsum("uij,ukj->uik", La, Lb,
                       precision=jax.lax.Precision.HIGHEST) \
            * umask[:, None, None]
        # padded rows target slot 0 with zero contribution
        blocks = blocks.at[dst].add(-M)
        return blocks

    return jax.lax.fori_loop(0, Lmax, level_body, blocks)


def solve_factored(blocks, b, sched_aux):
    """Triangular solves L L^T x = b with the level schedule.
    ``b``: (n, d)."""
    lvl_cols = sched_aux["lvl_cols"]
    solves = sched_aux["solves"]
    col_of_slot = sched_aux["col_of_slot"]   # (n+nnz,) column j per slot
    row_of_slot = sched_aux["row_of_slot"]   # (n+nnz,) row i per slot
    Lmax = lvl_cols.shape[0]
    d = b.shape[-1]

    # forward: y_j = L_jj^{-1} (b_j); then b_i -= L_ij y_j for i in rows(j)
    def fwd_body(li, b):
        cols = lvl_cols[li]
        cmask = cols >= 0
        csafe = jnp.maximum(cols, 0)
        Ljj = blocks[csafe]
        rhs = b[csafe]
        y = jax.scipy.linalg.solve_triangular(Ljj, rhs[..., None],
                                              lower=True)[..., 0]
        y = jnp.where(cmask[:, None], y, rhs)
        b = b.at[csafe].set(y)
        sl = solves[li]
        smask = (sl[:, 0] >= 0).astype(b.dtype)
        s_slot = jnp.maximum(sl[:, 0], 0)
        i_row = row_of_slot[s_slot]
        j_col = jnp.maximum(sl[:, 1], 0)
        contrib = jnp.einsum("sij,sj->si", blocks[s_slot], b[j_col],
                             precision=jax.lax.Precision.HIGHEST)
        b = b.at[i_row].add(-contrib * smask[:, None])
        return b

    y = jax.lax.fori_loop(0, Lmax, fwd_body, b)

    # backward: reverse level order
    def bwd_body(k, y):
        li = Lmax - 1 - k
        sl = solves[li]
        smask = (sl[:, 0] >= 0).astype(y.dtype)
        s_slot = jnp.maximum(sl[:, 0], 0)
        i_row = row_of_slot[s_slot]
        j_col = jnp.maximum(sl[:, 1], 0)
        # y_j -= L_ij^T x_i  (x_i already final for i in higher levels)
        contrib = jnp.einsum("sji,sj->si", blocks[s_slot], y[i_row],
                             precision=jax.lax.Precision.HIGHEST)
        y = y.at[j_col].add(-contrib * smask[:, None])
        cols = lvl_cols[li]
        cmask = cols >= 0
        csafe = jnp.maximum(cols, 0)
        Ljj = blocks[csafe]
        rhs = y[csafe]
        x = jax.scipy.linalg.solve_triangular(
            jnp.swapaxes(Ljj, -1, -2), rhs[..., None], lower=False)[..., 0]
        x = jnp.where(cmask[:, None], x, rhs)
        y = y.at[csafe].set(x)
        return y

    return jax.lax.fori_loop(0, Lmax, bwd_body, y)


def build_takahashi_schedule(sym):
    """Per-level pair schedule for the block Takahashi selected inverse.

    For each column ``j`` with below-diagonal structure ``S`` the
    recursion needs, per target row ``s_a`` of ``S``, the reduction
    ``W_a = Σ_b  Σ_{s_a, s_b} · L_{s_b, j}`` where every ``Σ_{s_a, s_b}``
    lies on the factor pattern (the classical closure property the
    reference's hash-memoized scalar recursion relies on,
    ``g2o/core/marginal_covariance_cholesky.h:92`` ``computeEntry``).
    Pairs are emitted vectorized, grouped by column length, and padded by
    the same level indexing as :func:`build_schedule`;
    :func:`selected_inverse` walks the levels in REVERSE depth order
    (ancestor columns first — each column only consumes Σ entries of its
    etree ancestors, which live at strictly greater depth)."""
    n = len(sym["rows"])
    colptr = np.asarray(sym["colptr"], dtype=np.int64)
    rows_flat = np.asarray(sym["rows_flat"], dtype=np.int64)
    depth = np.asarray(sym["depth"], dtype=np.int64)
    L = int(depth.max()) + 1 if n else 0
    lens = colptr[1:] - colptr[:-1]
    col_of_off = np.repeat(np.arange(n, dtype=np.int64), lens)
    key_all = col_of_off * (n + 1) + rows_flat

    def off_slot_v(i, j):
        return n + np.searchsorted(key_all, j * (n + 1) + i)

    srcS_l, tr_l, srcL_l, dstW_l, lvl_l = [], [], [], [], []
    for l in np.unique(lens):
        if l == 0:
            continue
        cols_l = np.nonzero(lens == l)[0]
        a, b = [x.ravel() for x in np.indices((int(l), int(l)))]
        base = colptr[cols_l][:, None]                    # (C, 1)
        sa = rows_flat[base + a[None, :]]                 # (C, P)
        sb = rows_flat[base + b[None, :]]
        srcL = n + base + b[None, :]
        dstW = base + a[None, :]                          # off index [0,nnz)
        eqm = sa == sb
        ltm = sa < sb
        # Σ_{sa,sb}: diag slot when equal; stored transposed when sa < sb
        srcS = np.where(eqm, sa,
                        np.where(ltm, off_slot_v(sb, sa),
                                 off_slot_v(sa, sb)))
        srcS_l.append(srcS.ravel())
        tr_l.append(ltm.ravel().astype(np.int64))
        srcL_l.append(np.broadcast_to(srcL, sa.shape).ravel())
        dstW_l.append(np.broadcast_to(dstW, sa.shape).ravel())
        lvl_l.append(np.repeat(depth[cols_l], len(a)))
    if srcS_l:
        payload = np.stack([np.concatenate(srcS_l), np.concatenate(tr_l),
                            np.concatenate(srcL_l), np.concatenate(dstW_l)],
                           axis=1)
        pairs = _pad_by_level(np.concatenate(lvl_l), payload, L)
    else:
        pairs = np.full((max(L, 1), 1, 4), -1, dtype=np.int64)
    return pairs


def selected_inverse(Lblocks, sched_aux, pairs, n: int):
    """Block Takahashi recursion on the factor pattern.

    One reverse level-scheduled sweep computes ``Σ = H⁻¹`` restricted to
    the pattern of ``L`` (all diagonal blocks + every stored off-diagonal
    block) in ``O(Σ_j |struct(j)|²)`` batched block ops — the batched
    formulation of the reference's per-entry Takahashi recursion
    (``marginal_covariance_cholesky.h:92``), replacing one full
    triangular-solve pair per requested column.

    Per column ``j`` (batched across a level, ancestors already done):

    * ``Σ_{s,j} = −(Σ_b Σ_{s,s_b} L_{s_b,j}) L_jj⁻¹``  for ``s ∈ struct(j)``
    * ``Σ_{j,j} = L_jj⁻ᵀ L_jj⁻¹ − (Σ_s Σ_{s,j}ᵀ L_{s,j}) L_jj⁻¹``

    ``n`` must be a static int (block-column count)."""
    lvl_cols = sched_aux["lvl_cols"]
    solves = sched_aux["solves"]
    d = Lblocks.shape[-1]
    nnz = Lblocks.shape[0] - n
    Lmax = lvl_cols.shape[0]
    hi = jax.lax.Precision.HIGHEST
    dtype = Lblocks.dtype
    eye = jnp.eye(d, dtype=dtype)

    Sigma = jnp.zeros_like(Lblocks)

    def level_body(k, Sigma):
        li = Lmax - 1 - k
        pr = pairs[li]
        pmask = (pr[:, 0] >= 0).astype(dtype)
        srcS = jnp.maximum(pr[:, 0], 0)
        tr = pr[:, 1] == 1
        srcL = jnp.maximum(pr[:, 2], 0)
        dstW = jnp.maximum(pr[:, 3], 0)
        Sg = Sigma[srcS]
        Sg = jnp.where(tr[:, None, None], jnp.swapaxes(Sg, -1, -2), Sg)
        C = jnp.einsum("pij,pjk->pik", Sg, Lblocks[srcL], precision=hi)
        W = jnp.zeros((max(nnz, 1), d, d), dtype=dtype).at[dstW].add(
            C * pmask[:, None, None])

        sl = solves[li]
        smask = sl[:, 0] >= 0
        s_slot = jnp.maximum(sl[:, 0], 0)
        j_col = jnp.maximum(sl[:, 1], 0)
        Wm = W[jnp.maximum(s_slot - n, 0)]
        Ljj = Lblocks[j_col]
        # X = −W L_jj⁻¹  ⇔  L_jjᵀ Xᵀ = −Wᵀ
        Xt = jax.scipy.linalg.solve_triangular(
            jnp.swapaxes(Ljj, -1, -2), -jnp.swapaxes(Wm, -1, -2),
            lower=False)
        X = jnp.swapaxes(Xt, -1, -2)
        Sigma = Sigma.at[s_slot].set(
            jnp.where(smask[:, None, None], X, Sigma[s_slot]))

        # R_j = Σ_s Σ_{s,j}ᵀ L_{s,j}  (segment-sum over this level's slots)
        contrib = jnp.einsum("sji,sjk->sik", Sigma[s_slot], Lblocks[s_slot],
                             precision=hi)
        R = jnp.zeros((n, d, d), dtype=dtype).at[j_col].add(
            contrib * smask[:, None, None].astype(dtype))

        cols = lvl_cols[li]
        cmask = cols >= 0
        csafe = jnp.maximum(cols, 0)
        Ljc = Lblocks[csafe]
        invL = jax.scipy.linalg.solve_triangular(
            Ljc, jnp.broadcast_to(eye, Ljc.shape), lower=True)
        SigD = jnp.einsum("cki,ckj->cij", invL, invL, precision=hi)
        SigD = SigD - jnp.einsum("cij,cjk->cik", R[csafe], invL,
                                 precision=hi)
        SigD = 0.5 * (SigD + jnp.swapaxes(SigD, -1, -2))
        Sigma = Sigma.at[csafe].set(
            jnp.where(cmask[:, None, None], SigD, Sigma[csafe]))
        return Sigma

    return jax.lax.fori_loop(0, Lmax, level_body, Sigma)


# --------------------------------------------------------------------- #
# solver class (single uniform vertex type, no marginalization)
# --------------------------------------------------------------------- #

class SparseCholeskySolver:
    """Direct block-sparse Cholesky solver.  Symbolic analysis runs once at
    setup; every ``solve`` re-runs the numeric phase with the current
    lambda on the diagonal (the reference's setLambda/restoreDiagonal
    contract).

    Mixed vertex types are handled by PADDING every block to the maximum
    tangent dim ``d_max``: padding slots carry a decoupled unit diagonal,
    so the factor/solve/selected-inverse machinery stays one uniform
    batched schedule (the array answer to the reference's
    variable-blocksize ``BlockSolverX``, ``core/block_solver.h:196``).
    N-ary (hyper) edges contribute one H block per slot pair, exactly as
    the reference builds its pattern from whatever blocks exist
    (``block_solver.hpp:142-214``)."""

    name = "sparse_chol"

    def __init__(self, min_separator_size: int = 32):
        self.min_size = int(min_separator_size)
        self.aux = ()
        self._solve_fn = None
        self._solve_jit = None

    def setup(self, problem):
        p = problem
        tnames = list(p.vertex_types)
        dims = {t: p.vertex_types[t].tangent_dim for t in tnames}
        d = max(dims.values())                       # padded block dim
        base = {}
        acc = 0
        for t in tnames:
            base[t] = acc
            acc += p.counts[t]
        n = acc

        # block pattern: ALL vertex pairs of every edge — n-ary edges
        # (ternary calib etc.) contribute each slot pair, exactly as the
        # reference builds its pattern from whatever H blocks exist
        # (``g2o/core/block_solver.hpp:142-214``)
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
        self._sym = sym                      # kept for selected-inverse
        self._n_blocks, self._block_dim = n, d
        self._type_base, self._dims = base, dims
        sched = build_schedule(sym, d)
        inv = sym["inv"].astype(np.int64)
        off_slot = sched.pop("off_slot")
        off_slot_v = sched.pop("off_slot_v")

        # per-(edge type, slot pair) maps for scattering H_ab blocks
        # (vectorized: block (hi, lo) with hi > lo holds H[a,b] when
        # inv[a] > inv[b], H[b,a] — the transpose — otherwise)
        edge_maps = {}
        self_maps = {}
        for name, et in p.edge_types.items():
            vidx = np.asarray(p.data.edges[name].vidx)
            for a, b in slot_pairs[name]:
                ga = base[et.vertex_types[a].name] + vidx[:, a]
                gb = base[et.vertex_types[b].name] + vidx[:, b]
                i = inv[ga]
                j = inv[gb]
                valid = ga != gb
                lo = np.where(valid, np.minimum(i, j), 0)
                hi = np.where(valid, np.maximum(i, j), 1)
                slots = np.where(valid, off_slot_v(hi, lo), 0)
                transpose = i < j
                edge_maps[(name, a, b)] = (jnp.asarray(slots),
                                           jnp.asarray(transpose),
                                           jnp.asarray(valid))
                # both slots bind the SAME vertex: H_ab + H_abᵀ belongs to
                # its DIAGONAL block (dense_hessian_fn accumulates it
                # there; dropping it would factor a different matrix) —
                # rare, so the extra scatter exists only when present
                if (~valid).any():
                    self_maps[(name, a, b)] = jnp.asarray(
                        np.where(valid, n, ga))       # n = OOB -> dropped

        # global (n,) fixed mask + per-slot validity (padding slots off)
        fixed_np = np.zeros(n, dtype=bool)
        valid_np = np.zeros((n, d), dtype=np.float64)
        for t in tnames:
            fx = np.asarray(p.data.fixed[t])
            fixed_np[base[t]:base[t] + p.counts[t]] = fx
            valid_np[base[t]:base[t] + p.counts[t], :dims[t]] = 1.0

        perm = jnp.asarray(sym["perm"])      # new k -> old id
        dtype = p.dtype
        n_total = n + sched["nnz"]

        self.aux = dict(
            lvl_cols=jnp.asarray(sched["lvl_cols"]),
            solves=jnp.asarray(sched["solves"]),
            updates=jnp.asarray(sched["updates"]),
            row_of_slot=jnp.asarray(sched["row_of_slot"]),
            col_of_slot=jnp.asarray(sched["col_of_slot"]),
            perm=perm,
            gfixed=jnp.asarray(fixed_np),
            gvalid=jnp.asarray(valid_np, dtype=dtype),
            edge_maps=edge_maps, self_maps=self_maps,
        )
        eye = jnp.eye(d, dtype=dtype)

        def _pad_block(M):
            """(E, a, b) -> (E, d, d) zero-padded top-left embedding."""
            a, b = M.shape[-2], M.shape[-1]
            if a == d and b == d:
                return M
            return jnp.pad(M, ((0, 0), (0, d - a), (0, d - b)))

        def assemble_and_factor(data, lin, lam, aux):
            """Scatter H blocks into the L pattern (permuted) and run the
            level-scheduled numeric factorization.  All H einsums at
            HIGHEST precision: a reduced-precision matmul (TF32 at
            DEFAULT on the GPU, ~1e-3 relative) breaks the SPD-ness a direct factorization needs
            (iterative solvers tolerate it; Cholesky NaNs)."""
            hi = jax.lax.Precision.HIGHEST
            blocks = jnp.zeros((n_total, d, d), dtype=dtype)
            # diagonal blocks (permuted), with damping + fixed identity —
            # rebuilt at HIGHEST rather than taken from lin.diag
            diag = jnp.zeros((n, d, d), dtype=dtype)
            for name, et in p.edge_types.items():
                Js = p.edge_jacs(lin, name)
                W = p.edge_weights(lin, name)
                vidx = data.edges[name].vidx
                for s in range(et.num_slots):
                    t = et.vertex_types[s].name
                    Hss = jnp.einsum("erd,ers,esf->edf", Js[s], W, Js[s],
                                     precision=hi)
                    diag = diag.at[base[t] + vidx[:, s]].add(_pad_block(Hss))
            # same-vertex slot pairs: H_ab + H_abᵀ into the diagonal block
            for (name, a, b), sids in aux["self_maps"].items():
                Js = p.edge_jacs(lin, name)
                W = p.edge_weights(lin, name)
                Hab = _pad_block(jnp.einsum("erd,ers,esf->edf", Js[a], W,
                                            Js[b], precision=hi))
                diag = diag.at[sids].add(Hab + jnp.swapaxes(Hab, -1, -2),
                                         mode="drop")
            # damping on valid slots, unit diagonal on padding slots,
            # identity on fixed vertices
            vmask = aux["gvalid"]                       # (n, d)
            diag = diag + jnp.einsum("nd,de->nde", vmask, eye) * lam \
                + jnp.einsum("nd,de->nde", 1.0 - vmask, eye)
            fx = aux["gfixed"].astype(dtype)[:, None, None]
            diag = diag * (1.0 - fx) + eye * fx
            blocks = blocks.at[:n].set(diag[aux["perm"]])
            # off-diagonal H blocks (every slot pair of every edge)
            for name, et in p.edge_types.items():
                if not slot_pairs[name]:
                    continue
                Js = p.edge_jacs(lin, name)
                W = p.edge_weights(lin, name)
                for a, b in slot_pairs[name]:
                    Hab = _pad_block(jnp.einsum("erd,ers,esf->edf", Js[a],
                                                W, Js[b], precision=hi))
                    slots, transpose, valid = aux["edge_maps"][(name, a, b)]
                    Hab = jnp.where(transpose[:, None, None],
                                    jnp.swapaxes(Hab, -1, -2), Hab)
                    Hab = Hab * valid[:, None, None].astype(dtype)
                    blocks = blocks.at[slots].add(Hab)
            return factorize(blocks, aux)

        def solve(data, lin, lam, aux):
            blocks = assemble_and_factor(data, lin, lam, aux)
            bb = p.split_tangent(lin.b)
            bfull = jnp.zeros((n, d), dtype=dtype)
            for t in tnames:
                bfull = bfull.at[base[t]:base[t] + p.counts[t],
                                 :dims[t]].set(bb[t])
            bperm = bfull[aux["perm"]]
            xperm = solve_factored(blocks, bperm, aux)
            x = jnp.zeros_like(xperm).at[aux["perm"]].set(xperm)
            out = {t: x[base[t]:base[t] + p.counts[t], :dims[t]]
                   for t in tnames}
            return p.join_tangent(out)

        self._factor_fn = assemble_and_factor  # used by marginal recovery
        self._solve_fn = solve
        self._solve_jit = jax.jit(solve)
        return self

    def solve(self, data, lin, lam=0.0):
        return self._solve_jit(data, lin, lam, self.aux)
