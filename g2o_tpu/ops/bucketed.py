"""Degree-bucketed segment layout — gather/scatter-free segment reductions.

The per-CG-iteration segment reductions of the implicit Schur solver
(900k observation rows into 150k landmarks at Venice scale) can be written
without any scatter: when every segment has a fixed degree, the reduction
is a dense ``reshape(NP, deg, 3).sum(axis=1)``.

This module computes, on the host, a *bucketed* permutation of the rows:
segments are grouped by (rounded-up) degree, every segment's rows are padded
to its bucket's degree with a sentinel zero row, and each bucket occupies a
contiguous slab.  Device-side consumers then reduce each bucket with a pure
``reshape + sum`` and broadcast per-segment values back to rows with a pure
``broadcast_to + reshape`` — no gather or scatter appears in the iterative
hot loop at all (the analogue of the reference's per-landmark Schur loop,
``g2o/core/block_solver.hpp:342-393``, whose OpenMP column partitioning this
layout replaces).

The plan is returned as plain numpy arrays; solvers ship them to the device
through their ``aux`` pytree (never as baked jit constants — see the solver
aux-argument protocol in the dev notes).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class BucketPlan(NamedTuple):
    """Host-side bucketed-segment layout.

    ``perm_src[i]`` is the source row feeding padded slot ``i`` — in
    ``[0, E]`` where ``E`` (one past the last row) denotes the sentinel
    zero row.  Slots are grouped into ``len(buckets)`` contiguous slabs;
    slab ``b`` holds ``counts[b] * degrees[b]`` slots covering
    ``counts[b]`` segments of padded degree ``degrees[b]``.

    Within a slab, slots are DEGREE-MAJOR: slot ``j * counts[b] + i`` is
    the ``j``-th padded row of segment ``i`` — the segment axis is
    minormost, so a slab viewed as ``(deg, n_seg)`` (or ``(..., deg,
    n_seg)`` for dims-major arrays) puts the large axis minormost.
    A segment-major order would make every slab reshape a 4-6 wide minor
    axis, which XLA materialises as relayouts.

    ``seg_perm`` concatenates, slab by slab, the original segment id of
    every padded segment slot (each non-empty segment appears exactly
    once).  ``seg_perm_full`` additionally appends the ids of empty
    segments so it is a true permutation of ``range(num_segments)``.
    """

    perm_src: np.ndarray     # (E_pad,) int32
    seg_perm: np.ndarray     # (S_used,) int32
    seg_perm_full: np.ndarray  # (num_segments,) int32
    degrees: tuple           # per-bucket padded degree (static)
    counts: tuple            # per-bucket segment count (static)
    num_segments: int
    num_rows: int            # E (sentinel index == num_rows)

    @property
    def pad_ratio(self) -> float:
        used = sum(c * d for c, d in zip(self.counts, self.degrees))
        return used / max(self.num_rows, 1)


def _bucket_ladder(max_deg: int):
    """Padded-degree ladder with ~1.3x steps (padding within a bucket is
    bounded by the step ratio)."""
    ladder = [1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128]
    while ladder[-1] < max_deg:
        ladder.append(int(ladder[-1] * 1.5))
    return [d for d in ladder if d <= max_deg] + (
        [] if ladder and max_deg in ladder else [max_deg])


def bucket_by_segment(seg_ids: np.ndarray, num_segments: int, *,
                      max_buckets: int = 10) -> BucketPlan:
    """Build a :class:`BucketPlan` for rows labelled by ``seg_ids``.

    Rows of each segment stay in their original relative order.  Buckets
    are merged greedily (smallest added padding first) until at most
    ``max_buckets`` remain, bounding the number of device kernels a
    consumer emits per reduction."""
    seg_ids = np.asarray(seg_ids, dtype=np.int64)
    E = int(seg_ids.shape[0])
    deg = np.bincount(seg_ids, minlength=num_segments)
    used = np.nonzero(deg > 0)[0]
    empty = np.nonzero(deg == 0)[0]
    max_deg = int(deg.max()) if len(used) else 1

    ladder = _bucket_ladder(max_deg)
    # assign each used segment the smallest ladder degree >= its degree
    pad_deg = np.asarray(ladder)[np.searchsorted(ladder, deg[used])]

    # merge ladder levels until few enough buckets remain
    levels = sorted(set(int(d) for d in pad_deg))
    while len(levels) > max_buckets:
        # merging level i into level i+1 costs (levels[i+1]-levels[i]) *
        # (#segments at level i) extra padded rows — merge the cheapest
        costs = []
        for i in range(len(levels) - 1):
            n_i = int(np.sum(pad_deg == levels[i]))
            costs.append((levels[i + 1] - levels[i]) * n_i)
        i = int(np.argmin(costs))
        pad_deg[pad_deg == levels[i]] = levels[i + 1]
        levels.pop(i)

    # stable sort of rows by segment id; per-segment row lists in order
    order = np.argsort(seg_ids, kind="stable")
    sorted_segs = seg_ids[order]
    starts = np.searchsorted(sorted_segs, used)

    perm_chunks, seg_chunks, degrees, counts = [], [], [], []
    for lvl in levels:
        sel = np.nonzero(pad_deg == lvl)[0]          # indices into `used`
        if len(sel) == 0:
            continue
        segs = used[sel]
        n = len(segs)
        col = np.arange(lvl, dtype=np.int64)
        idx = starts[sel][:, None] + col[None, :]           # (n, lvl)
        valid = col[None, :] < deg[segs][:, None]
        slab = np.where(valid, order[np.minimum(idx, E - 1)], E)
        perm_chunks.append(slab.T.reshape(-1))              # degree-major
        seg_chunks.append(segs)
        degrees.append(int(lvl))
        counts.append(n)

    perm_src = (np.concatenate(perm_chunks) if perm_chunks
                else np.zeros((0,), dtype=np.int64))
    seg_perm = (np.concatenate(seg_chunks) if seg_chunks
                else np.zeros((0,), dtype=np.int64))
    seg_perm_full = np.concatenate([seg_perm, empty])
    return BucketPlan(
        perm_src=perm_src.astype(np.int32),
        seg_perm=seg_perm.astype(np.int32),
        seg_perm_full=seg_perm_full.astype(np.int32),
        degrees=tuple(degrees),
        counts=tuple(counts),
        num_segments=int(num_segments),
        num_rows=E,
    )


def bucket_reduce(plan: BucketPlan, rows_padded, reduce_fn=None):
    """Reduce padded rows ``(E_pad, ...)`` to per-segment values in
    BUCKET order ``(S_used, ...)`` — a pure reshape+sum per bucket.

    ``rows_padded`` must already be laid out by ``plan.perm_src``."""
    import jax.numpy as jnp

    out, off = [], 0
    for n, d in zip(plan.counts, plan.degrees):
        slab = rows_padded[off:off + n * d]
        slab = slab.reshape((d, n) + slab.shape[1:])
        out.append(slab.sum(axis=0) if reduce_fn is None else reduce_fn(slab))
        off += n * d
    return jnp.concatenate(out, axis=0)


def bucket_broadcast(plan: BucketPlan, seg_vals):
    """Broadcast per-segment values in BUCKET order ``(S_used, ...)`` back
    to padded row layout ``(E_pad, ...)`` — a pure broadcast per bucket."""
    import jax.numpy as jnp

    out, off = [], 0
    for n, d in zip(plan.counts, plan.degrees):
        v = seg_vals[off:off + n]
        out.append(jnp.broadcast_to(
            v[None], (d, n) + v.shape[1:]).reshape((n * d,) + v.shape[1:]))
        off += n
    return jnp.concatenate(out, axis=0)
