"""Incremental / online optimization — analogue of the reference's
``SparseOptimizer::updateInitialization`` online mode
(``g2o/core/sparse_optimizer.cpp:465-502``) and the ``g2o -inc`` /
``g2o_incremental`` flow (``apps/g2o_cli/g2o.cpp:373-460``, SURVEY.md §3.5).

XLA-native reformulation of "grow the active structures without
re-initialising": the compiled problem is *capacity-padded* — vertex slots
beyond the live count are pinned (fixed mask) and edge slots beyond the live
count are inactive padding rows.  Adding a vertex/edge is then a handful of
device ``.at[].set`` updates (estimates row, edge batch rows, flag flips);
the jitted step functions never retrace.  Only when a capacity overflows do
we recompile, with doubled slack — the analogue of the reference's
"buildStructure once, reuse the pattern" contract
(``g2o/core/block_solver.hpp:103``, SURVEY.md §7.3).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from g2o_tpu.core.graph import Graph
from g2o_tpu.core.optimizer import SparseOptimizer
from g2o_tpu.core.solvers import PCGSolver


class IncrementalOptimizer:
    """Online wrapper: add vertices/edges, call :meth:`optimize` anytime."""

    def __init__(self, *, algorithm_factory=None, solver_factory=None,
                 edge_chunk: int = 256, vertex_chunk: int = 128,
                 verbose: bool = False, init_from_edges: bool = True):
        from g2o_tpu.core.optimizer import LevenbergMarquardt

        self.graph = Graph()
        self.edge_chunk = int(edge_chunk)
        self.vertex_chunk = int(vertex_chunk)
        self.verbose = verbose
        # reference `g2o -inc` behaviour (``apps/g2o_cli/g2o.cpp:440-492``):
        # a vertex first seen through a new edge is initialised by the
        # edge's initialEstimate rule from the already-placed endpoint
        self.init_from_edges = bool(init_from_edges)
        self._fresh: set[int] = set()
        self._algorithm_factory = algorithm_factory or LevenbergMarquardt
        self._solver_factory = solver_factory or (
            lambda: PCGSolver(max_iter=100, tol=1e-8))
        self._problem = None
        self._opt = None
        self._live_edges: dict[str, int] = {}
        self._reserved: dict[str, int] = {}
        self._recompiles = 0

    # ------------------------------------------------------------------ #

    def add_vertex(self, vid, vtype, estimate, *, fixed=False):
        self.graph.add_vertex(vid, vtype, estimate, fixed=fixed)
        if self.init_from_edges and not fixed:
            self._fresh.add(vid)
        if self._problem is not None:
            t = (vtype if isinstance(vtype, str) else vtype.name)
            slot = self._next_vertex_slot(t)
            if slot is None:
                self._invalidate()
            else:
                p = self._problem
                est = jnp.asarray(np.asarray(estimate, dtype=np.float64),
                                  dtype=p.dtype)
                p.estimates[t] = p.estimates[t].at[slot].set(est)
                fixed_arr = p.data.fixed[t].at[slot].set(bool(fixed))
                self._set_data(fixed={**p.data.fixed, t: fixed_arr})
                p.vid_index[vid] = (t, slot)
                self._live_counts[t] += 1
                self._refresh_fixed_flat(t, slot, bool(fixed))
        return vid

    def add_edge(self, etype, vids, measurement, information, **kw):
        self.graph.add_edge(etype, vids, measurement, information, **kw)
        if self.init_from_edges:
            self._init_fresh_through_edge(self.graph.edges()[-1])
        if self._problem is None:
            return
        rec = self.graph.edges()[-1]
        name = rec.etype.name
        p = self._problem
        if rec.level != 0:
            # compile() excludes level != 0 edges (problem.py level
            # filter); writing one into the level-0 batch would make chi2
            # jump across the next recompile.  The graph keeps it; the
            # compiled problem ignores it — consistent with a recompile.
            return
        if name not in p.data.edges or \
                self._live_edges[name] >= p.data.edges[name].vidx.shape[0]:
            self._invalidate()
            return
        i = self._live_edges[name]
        b = p.data.edges[name]
        vidx_row = np.array([p.vid_index[v][1] for v in rec.vids],
                            dtype=np.int32)
        par_row = (np.concatenate([self.graph.parameter(pid)
                                   for pid in rec.param_id])
                   if rec.etype.param_dim else np.zeros(0))
        new_batch = b._replace(
            vidx=b.vidx.at[i].set(jnp.asarray(vidx_row)),
            meas=b.meas.at[i].set(jnp.asarray(rec.measurement, dtype=p.dtype)),
            info=b.info.at[i].set(jnp.asarray(rec.information, dtype=p.dtype)),
            kernel=b.kernel.at[i].set(rec.kernel),
            delta=b.delta.at[i].set(jnp.asarray(rec.delta, dtype=p.dtype)),
            active=b.active.at[i].set(bool(rec.active)),
            param=(b.param.at[i].set(jnp.asarray(par_row, dtype=p.dtype))
                   if rec.etype.param_dim else b.param),
        )
        new_plans = p.data.plans
        fm = (new_plans.get(name) or {}).get("free_mask")
        if fm is not None:
            # refresh the fixed-vertex Jacobian multiplier for this row
            # (placeholder rows were built against fixed placeholder slots)
            row = jnp.asarray(
                [0.0 if bool(p.data.fixed[p.vid_index[v][0]]
                             [p.vid_index[v][1]]) else 1.0
                 for v in rec.vids], dtype=p.dtype)
            new_plans = {**new_plans,
                         name: {**new_plans[name],
                                "free_mask": fm.at[i].set(row)}}
        self._set_data(edges={**p.data.edges, name: new_batch},
                       plans=new_plans)
        self._live_edges[name] = i + 1
        if p.n_active_edges is not None and rec.active:
            p.n_active_edges += 1     # keep the host-side count current
        self._edges_dirty = True

    def _init_fresh_through_edge(self, rec):
        """Initialise endpoints first seen through this edge from the other
        (already-placed) endpoint via the edge type's initialEstimate rule —
        the reference's online-vertex initialisation
        (``apps/g2o_cli/g2o.cpp:457-492``)."""
        from g2o_tpu.core.initial_guess import _propagate_rule

        fresh_slots = [s for s, v in enumerate(rec.vids) if v in self._fresh]
        if not fresh_slots:
            return
        if len(fresh_slots) == len(rec.vids) and len(rec.vids) > 1:
            return  # no initialised endpoint to propagate from
        rule = _propagate_rule(rec.etype.name)
        if rule is None:
            return
        verts = self.graph.vertices()
        states = [self._current_estimate(v) for v in rec.vids]
        param = (np.concatenate([self.graph.parameter(pid)
                                 for pid in rec.param_id])
                 if rec.param_id is not None else None)
        for s in fresh_slots:
            new = rule(states, rec.measurement, param, s)
            if new is None:
                continue
            vid = rec.vids[s]
            new = np.asarray(new, dtype=np.float64)
            verts[vid].estimate = new
            self._fresh.discard(vid)
            if self._problem is not None and vid in self._problem.vid_index:
                t, slot = self._problem.vid_index[vid]
                p = self._problem
                p.estimates[t] = p.estimates[t].at[slot].set(
                    jnp.asarray(new, dtype=p.dtype))

    def _current_estimate(self, vid):
        if self._problem is not None and vid in self._problem.vid_index:
            return np.asarray(self._problem.get_estimate(vid))
        return np.asarray(self.graph.vertices()[vid].estimate)

    # ------------------------------------------------------------------ #

    def _set_data(self, **fields):
        p = self._problem
        p.data = p.data._replace(**fields)

    def _refresh_fixed_flat(self, t, slot, fixed):
        p = self._problem
        d = p.vertex_types[t].tangent_dim
        off = int(np.asarray(p.data.offsets[t])[slot])
        val = 1.0 if fixed else 0.0
        ff = p.data.fixed_flat.at[off:off + d].set(val)
        self._set_data(fixed_flat=ff)

    def _next_vertex_slot(self, t):
        p = self._problem
        if t not in p.counts:
            return None
        n = self._live_counts[t]
        return n if n < p.counts[t] else None

    def _invalidate(self):
        self._problem = None
        self._opt = None

    def _compile(self):
        # build a capacity-padded copy: reserve extra pinned vertices and
        # inactive edge rows so future adds are in-place updates
        g = Graph(self.graph.registry)
        by_type_counts: dict[str, int] = {}
        for vid in sorted(self.graph.vertices()):
            rec = self.graph.vertices()[vid]
            g.add_vertex(vid, rec.vtype, rec.estimate, fixed=rec.fixed,
                         marginalized=rec.marginalized)
            by_type_counts[rec.vtype.name] = \
                by_type_counts.get(rec.vtype.name, 0) + 1
        for pid, val in self.graph._parameters.items():
            g.add_parameter(pid, val)
        # reserve pinned placeholder vertices with ids ABOVE any real id so
        # they occupy the trailing slots of each per-type array
        placeholder_id = max(self.graph.vertices(), default=0) + 1
        proto = {r.vtype.name: r.estimate
                 for r in self.graph.vertices().values()}
        for t, n in by_type_counts.items():
            vt = self.graph.registry.vertex_types[t]
            for _ in range(self.vertex_chunk):
                g.add_vertex(placeholder_id, vt, proto[t], fixed=True)
                placeholder_id += 1
        edge_counts: dict[str, int] = {}
        for e in self.graph.edges():
            g.add_edge(e.etype, e.vids, e.measurement, e.information,
                       kernel=e.kernel, delta=e.delta, level=e.level,
                       active=e.active, param_id=e.param_id)
            edge_counts[e.etype.name] = edge_counts.get(e.etype.name, 0) + 1
        # guarantee at least one inactive slack row per edge type
        for e in list(self.graph.edges()):
            if edge_counts.get(e.etype.name, 0) % self.edge_chunk == 0:
                g.add_edge(e.etype, e.vids, e.measurement, e.information,
                           kernel=e.kernel, delta=e.delta, level=e.level,
                           active=False, param_id=e.param_id)
                edge_counts[e.etype.name] += 1

        # dynamic kernel dispatch: added edges may carry a different robust
        # kernel than the placeholder rows they overwrite
        p = g.compile(pad_edges_to_multiple=self.edge_chunk,
                      static_kernels=False)
        # force at least one chunk of slack per present edge type
        self._problem = p
        # live counters: real (sorted) vertices come first per type only if
        # their ids sort before the placeholders — placeholder ids are
        # *smaller*, so they sort first.  Re-map: we instead count live
        # vertices by scanning vid_index for real ids.
        self._live_counts = {t: 0 for t in p.counts}
        for vid, (t, i) in p.vid_index.items():
            if vid in self.graph.vertices():
                self._live_counts[t] += 1
        # level != 0 edges are excluded from the compiled batch, so they
        # must not advance the in-place write cursor either
        self._live_edges = {name: sum(1 for e in self.graph.edges()
                                      if e.etype.name == name
                                      and e.level == 0)
                            for name in p.edge_types}
        self._recompiles += 1
        solver = self._solver_factory()
        self._opt = SparseOptimizer(p, algorithm=self._algorithm_factory(),
                                    solver=solver, verbose=self.verbose)

    # ------------------------------------------------------------------ #

    @property
    def problem(self):
        if self._problem is None:
            self._compile()
        return self._problem

    @property
    def recompiles(self):
        return self._recompiles

    def chi2(self):
        if self._problem is None:
            self._compile()
        return self._opt.chi2()

    def optimize(self, iterations: int = 5):
        if self._problem is None:
            self._compile()
        self._opt.problem = self._problem
        solver = self._opt.solver
        if (getattr(solver, "precond", None) in ("chunk", "chunk2")
                and getattr(self, "_edges_dirty", False)):
            # chunk preconditioners hold edge→chunk index maps built at
            # setup; rows overwritten since then would feed real blocks
            # through stale placeholder indices.  The maps travel via
            # solver.aux (jit arguments), so refreshing them is a
            # host-side recompute with NO retrace — setup(force=True)
            # re-created every jit closure (~1 s each; advisor r2 #4)
            if hasattr(solver, "refresh_chunk_maps"):
                solver.refresh_chunk_maps(self._problem)
            else:
                solver.setup(self._problem, force=True)
        self._edges_dirty = False
        if getattr(solver, "precond_mode", None) == "frozen":
            # warm start: ONE preconditioner build per update; all LM
            # iterations/λ-trials of this update reuse it (the device-side
            # analogue of the reference's cross-update factor reuse,
            # ``g2o_incremental/linear_solver_cholmod_online.h``)
            solver.refresh_precond(self._problem)
        return self._opt.optimize(iterations)

    def get_estimate(self, vid):
        return self.problem.get_estimate(vid)
