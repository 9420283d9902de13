"""Incremental warm start: frozen preconditioner across -inc updates.

The reference's g2o_incremental reuses the CHOLMOD factor across updates
via update/downdate (``linear_solver_cholmod_online.h``); the array-program
equivalent is a frozen preconditioner refreshed once per update
(``PCGSolver(precond_mode="frozen")`` + ``refresh_precond``), with the
carried-residual CG floor persisting across updates.  These tests pin
(a) frozen == per-solve final chi2, (b) an incremental replay converging
with the warm-started solver, (c) map-staleness safety for chunk
preconditioners (setup rebuild on dirty edges).
"""

import numpy as np
import jax.numpy as jnp
import pytest

import g2o_tpu.types  # noqa: F401
from g2o_tpu.core.incremental import IncrementalOptimizer
from g2o_tpu.core.lm_fused import optimize_fused
from g2o_tpu.core.solvers import PCGSolver
from g2o_tpu.sim.generators import create_manhattan


def test_frozen_precond_matches_per_solve():
    g = create_manhattan(n_poses=250, seed=0)
    p = g.compile()
    est0 = {t: np.array(v) for t, v in p.estimates.items()}
    r1 = optimize_fused(p, PCGSolver(max_iter=200, tol=1e-8), 15)
    p.set_estimates({t: jnp.asarray(v, dtype=p.dtype)
                     for t, v in est0.items()})
    r2 = optimize_fused(p, PCGSolver(max_iter=200, tol=1e-8,
                                     precond_mode="frozen"), 15)
    assert r2["chi2_final"] == pytest.approx(r1["chi2_final"], rel=1e-3)


def _replay(inc, g, split=0.5, iters_per_update=3, n_updates=4):
    vs = sorted(g.vertices())
    recs, es = g.vertices(), g.edges()
    cut = [int(len(vs) * (split + (1 - split) * k / n_updates))
           for k in range(n_updates + 1)]
    placed = set()
    added_edges = set()
    chis = []
    for k in range(n_updates + 1):
        for vid in vs[len(placed):cut[k]] if k else vs[:cut[0]]:
            r = recs[vid]
            inc.add_vertex(vid, r.vtype, r.estimate, fixed=r.fixed)
            placed.add(vid)
        for i, e in enumerate(es):
            if i not in added_edges and set(e.vids) <= placed:
                inc.add_edge(e.etype, e.vids, e.measurement, e.information)
                added_edges.add(i)
        inc.optimize(iters_per_update)
        chis.append(inc.chi2())
    return chis


@pytest.mark.parametrize("precond,mode", [("jacobi", "frozen"),
                                          ("chunk2", "frozen")])
def test_incremental_replay_warm(precond, mode):
    inc = IncrementalOptimizer(solver_factory=lambda: PCGSolver(
        max_iter=150, tol=1e-8, precond=precond, chunk_size=16,
        precond_mode=mode))
    g = create_manhattan(n_poses=120, seed=2)
    chis = _replay(inc, g)
    # cold full-batch reference on the SAME final graph
    p = g.compile()
    ref = optimize_fused(p, PCGSolver(max_iter=200, tol=1e-8), 20)
    assert chis[-1] == pytest.approx(ref["chi2_final"], rel=1e-2)
