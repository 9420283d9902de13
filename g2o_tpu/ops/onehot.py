"""One-hot gather/scatter as matrix products.

A gather ``table[idx]`` and a segment sum over ``idx`` are written as
``onehot(idx) @ table`` and ``onehot(idx)^T @ rows``.  With
``Precision.HIGHEST`` the product is EXACT in f32 (one-hot entries are
exactly representable and accumulation happens in f32), so it can stand in
for the indexed form anywhere.  XLA may fuse the one-hot construction into
the matmul; where it does not, the (N, S) mask is materialised, which is
what bounds the segment counts these forms are used for (see
``Problem.hvp_operator`` and the bucketed layout of
``ImplicitSchurSolver``).

Out-of-range ids produce all-zero one-hot rows: gathers return zero rows,
scatters drop the row — matching XLA's clip/drop semantics for padding
sentinels."""

from __future__ import annotations

import jax

_HI = jax.lax.Precision.HIGHEST


def onehot_scatter_add(idx, rows, n_seg: int, precision=_HI):
    """Sum rows[i] into segment idx[i]: (N, ...) -> (n_seg, ...).

    ``precision`` defaults to exact f32 (HIGHEST); iterative-solver matvecs
    may pass DEFAULT, which on the GPU runs the product in TF32 (~1e-3
    relative)."""
    flat = rows.reshape(rows.shape[0], -1)
    dims = (((0,), (0,)), ((), ()))
    oh = jax.nn.one_hot(idx, n_seg, dtype=flat.dtype)
    out = jax.lax.dot_general(oh, flat, dims, precision=precision,
                              preferred_element_type=flat.dtype)
    return out.reshape((n_seg,) + rows.shape[1:])


def onehot_gather(idx, table, precision=_HI):
    """table[idx]: (S, ...) -> (N, ...).  See ``onehot_scatter_add`` for
    the ``precision`` contract."""
    flat = table.reshape(table.shape[0], -1)
    dims = (((1,), (0,)), ((), ()))
    oh = jax.nn.one_hot(idx, table.shape[0], dtype=flat.dtype)
    out = jax.lax.dot_general(oh, flat, dims, precision=precision,
                              preferred_element_type=flat.dtype)
    return out.reshape((idx.shape[0],) + table.shape[1:])


def onehot_gather_t(idx, table, precision=_HI):
    """Dims-major gather: table ``(S, D)`` -> ``(D, N)`` rows of
    ``table[idx]`` with the row axis minormost, for consumers that keep the
    edge axis on lanes (no relayout of the (D, N) output needed)."""
    flat = table.reshape(table.shape[0], -1)               # (S, D)
    dims = (((0,), (1,)), ((), ()))
    oh = jax.nn.one_hot(idx, table.shape[0], dtype=flat.dtype)   # (N, S)
    return jax.lax.dot_general(flat, oh, dims, precision=precision,
                               preferred_element_type=flat.dtype)


def onehot_scatter_add_t(idx, rows_t, n_seg: int, precision=_HI):
    """Dims-major segment sum: rows_t ``(D, N)`` -> ``(n_seg, D)``.

    The one-hot dot contracts the row axis directly
    (``rows_t @ onehot(idx)``), so dims-major producers (see the
    linearize assembly fast path) feed it without a relayout back to
    row-major."""
    dims = (((1,), (0,)), ((), ()))
    oh = jax.nn.one_hot(idx, n_seg, dtype=rows_t.dtype)       # (N, n_seg)
    out_t = jax.lax.dot_general(rows_t, oh, dims, precision=precision,
                                preferred_element_type=rows_t.dtype)
    return out_t.T                                         # (n_seg, D)
