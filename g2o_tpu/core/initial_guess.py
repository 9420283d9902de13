"""Initial-guess computation — analogue of the reference
``EstimatePropagator`` spanning-tree propagation
(``g2o/core/estimate_propagator.cpp:86-137``) and the CLI's odometry guess
(``apps/g2o_cli/g2o.cpp`` ``-guessOdometry``).

Host-side, runs once before compilation: starting from fixed vertices (the
gauge) and unary-prior-pinned vertices, run Dijkstra WITH RELAXATION over
the selected level's active edges and initialise each vertex when it is
finalised — through the cheapest incoming edge's ``initial_estimate`` rule
(the analogue of ``Edge::initialEstimate``,
``g2o/core/optimizable_graph.h:452``).  Cost defaults to hop count,
matching the common ``EstimatePropagatorCostOdometry`` usage.

All group arithmetic here is PLAIN NUMPY: this is a per-edge host loop, and
one eager jnp dispatch per edge would cost far more than the traversal
itself.
"""

from __future__ import annotations

import heapq

import numpy as np


# ---- plain-numpy group ops (reps match g2o_tpu.ops.lie: SE2 = [x, y, th],
# SE3 = [t(3), q(x, y, z, w)]) ------------------------------------------- #

def _se2_compose_np(a, b):
    c, s = np.cos(a[2]), np.sin(a[2])
    th = (a[2] + b[2] + np.pi) % (2 * np.pi) - np.pi
    return np.array([a[0] + c * b[0] - s * b[1],
                     a[1] + s * b[0] + c * b[1], th])


def _se2_inv_np(a):
    c, s = np.cos(a[2]), np.sin(a[2])
    return np.array([-(c * a[0] + s * a[1]), s * a[0] - c * a[1], -a[2]])


def _se2_act_np(a, p):
    c, s = np.cos(a[2]), np.sin(a[2])
    return np.array([a[0] + c * p[0] - s * p[1],
                     a[1] + s * p[0] + c * p[1]])


def _qmul_np(q1, q2):
    x1, y1, z1, w1 = q1
    x2, y2, z2, w2 = q2
    return np.array([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ])


def _qrot_np(q, v):
    u, w = q[:3], q[3]
    return v + 2.0 * np.cross(u, np.cross(u, v) + w * v)


def _se3_compose_np(a, b):
    return np.concatenate([a[:3] + _qrot_np(a[3:7], b[:3]),
                           _qmul_np(a[3:7], b[3:7])])


def _se3_inv_np(a):
    qc = np.array([-a[3], -a[4], -a[5], a[6]])
    return np.concatenate([-_qrot_np(qc, a[:3]), qc])


def _se3_act_np(a, p):
    return a[:3] + _qrot_np(a[3:7], p)


def _propagate_rule(etype_name):
    """Returns fn(states, meas, param, to_slot) -> new state or None."""
    if etype_name == "EDGE_SE2":
        def rule(states, meas, param, to_slot):
            if to_slot == 1:
                return _se2_compose_np(states[0], meas)
            return _se2_compose_np(states[1], _se2_inv_np(meas))
        return rule
    if etype_name == "EDGE_SE3:QUAT":
        def rule(states, meas, param, to_slot):
            if to_slot == 1:
                return _se3_compose_np(states[0], meas)
            return _se3_compose_np(states[1], _se3_inv_np(meas))
        return rule
    if etype_name in ("EDGE_SE2_XY", "EDGE_SE2_POINT_XY"):
        def rule(states, meas, param, to_slot):
            if to_slot == 1:
                return _se2_act_np(states[0], np.asarray(meas))
            return None
        return rule
    if etype_name == "EDGE_SE3_TRACKXYZ":
        def rule(states, meas, param, to_slot):
            if to_slot == 1:
                sensor = _se3_compose_np(states[0], param)
                return _se3_act_np(sensor, np.asarray(meas))
            return None
        return rule
    if etype_name == "EDGE_PRIOR_SE2":
        return lambda states, meas, param, to_slot: np.asarray(meas)
    if etype_name == "EDGE_SE3:EXPMAP":
        # error = (X2^-1 Z X1).log() => X2 = Z X1
        def rule(states, meas, param, to_slot):
            if to_slot == 1:
                return _se3_compose_np(meas, states[0])
            return _se3_compose_np(_se3_inv_np(meas), states[1])
        return rule
    return None


def _propagate_targets(etype_name, n_slots):
    """Static viability: the to_slots a rule can initialise (used during
    relaxation, where calling the rule itself would read a non-final
    parent estimate)."""
    if etype_name in ("EDGE_SE2", "EDGE_SE3:QUAT", "EDGE_SE3:EXPMAP"):
        return set(range(n_slots))
    if etype_name in ("EDGE_SE2_XY", "EDGE_SE2_POINT_XY",
                      "EDGE_SE3_TRACKXYZ"):
        return {1}
    if etype_name == "EDGE_PRIOR_SE2":
        return {0}
    return set()


def hyper_dijkstra(graph, roots, *, cost=None, max_distance=float("inf"),
                   level=0):
    """Shortest-path traversal over the hyper-graph with a pluggable edge
    cost — the analogue of ``HyperDijkstra::shortestPaths``
    (``g2o/core/hyper_dijkstra.h:77-88``) with the
    ``EstimatePropagatorCost`` functor family
    (``g2o/core/estimate_propagator.h:46-61``).

    ``cost(edge_rec, from_vid, to_vid) -> float`` (default: uniform 1.0;
    return ``inf``/``None`` to forbid an edge).  Returns ``(dist, parent)``
    dicts: ``dist[vid]`` = accumulated cost, ``parent[vid]`` =
    ``(edge_rec, from_vid)`` for the spanning-tree edge (roots map to
    ``None``)."""
    if cost is None:
        cost = lambda e, frm, to: 1.0  # noqa: E731

    adj: dict[int, list] = {}
    for e in graph.edges():
        if not e.active or e.level != level:
            continue
        for s, vid in enumerate(e.vids):
            adj.setdefault(vid, []).append((e, s))

    dist = {vid: 0.0 for vid in roots}
    parent: dict[int, object] = {vid: None for vid in roots}
    visited = set()
    heap = [(0.0, vid) for vid in roots]
    heapq.heapify(heap)
    while heap:
        d, vid = heapq.heappop(heap)
        if vid in visited or d > dist.get(vid, float("inf")):
            continue
        visited.add(vid)
        for e, my_slot in adj.get(vid, ()):
            for to_slot, to_vid in enumerate(e.vids):
                if to_slot == my_slot or to_vid in visited:
                    continue
                c = cost(e, vid, to_vid)
                if c is None or not np.isfinite(c):
                    continue
                nd = d + float(c)
                if nd > max_distance or nd >= dist.get(to_vid, float("inf")):
                    continue
                dist[to_vid] = nd
                parent[to_vid] = (e, vid)
                heapq.heappush(heap, (nd, to_vid))
    return dist, parent


def compute_initial_guess(graph, *, roots=None, cost=None, level=0) -> int:
    """Propagate estimates over a Dijkstra spanning tree from the fixed
    vertices (or explicit root ids) — the reference's
    ``EstimatePropagator::propagate`` (``estimate_propagator.cpp:86-137``).

    * proper RELAXATION: a vertex is initialised when it is FINALISED,
      through its cheapest incoming edge — a later-arriving shorter path
      replaces an earlier discovery (the previous implementation pinned
      the first discovery, yielding a worse spanning tree under
      non-uniform costs);
    * unary priors (EDGE_PRIOR_SE2) pin their vertex first and act as
      extra roots (the reference applies unary ``initialEstimate`` too);
    * with nothing fixed, the fallback root is the lowest id of the
      LARGEST-tangent-dim vertex type (the reference ``findGauge``
      selects a pose-dimension vertex — a landmark root propagates
      nothing);
    * only ``level``'s active edges participate (``compile(level=)``
      optimizes one level; propagating through excluded edges would build
      a guess for a different problem).

    ``cost`` is an optional ``(edge_rec, from_vid, to_vid) -> float``
    functor (default: uniform hop count).  Mutates the graph's vertex
    estimates in place; returns the number of vertices initialised."""
    verts = graph.vertices()
    n_init = 0

    def edge_param(e):
        return (np.concatenate([graph.parameter(p) for p in e.param_id])
                if e.param_id is not None else None)

    # unary priors: pin their (non-fixed) vertex and make it a root
    prior_roots = []
    for e in graph.edges():
        if not e.active or e.level != level or len(e.vids) != 1:
            continue
        rule = _propagate_rule(e.etype.name)
        vid = e.vids[0]
        if rule is None or verts[vid].fixed:
            continue
        new = rule([verts[vid].estimate], e.measurement, edge_param(e), 0)
        if new is not None:
            verts[vid].estimate = np.asarray(new, dtype=np.float64)
            prior_roots.append(vid)
            n_init += 1

    if roots is None:
        roots = [vid for vid, r in verts.items() if r.fixed]
    roots = list(dict.fromkeys(list(roots) + prior_roots))
    if not roots and verts:
        # findGauge-ish fallback: lowest id of the largest-tangent type
        dmax = max(r.vtype.tangent_dim for r in verts.values())
        roots = [min(vid for vid, r in verts.items()
                     if r.vtype.tangent_dim == dmax)]
    if cost is None:
        cost = lambda e, frm, to: 1.0  # noqa: E731

    # adjacency: vid -> list of (edge_rec, my_slot), selected level only
    adj: dict[int, list] = {}
    for e in graph.edges():
        if not e.active or e.level != level or len(e.vids) < 2:
            continue
        for s, vid in enumerate(e.vids):
            adj.setdefault(vid, []).append((e, s))

    dist = {vid: 0.0 for vid in roots}
    pred: dict[int, object] = {vid: None for vid in roots}
    finalized = set()
    heap = [(0.0, vid) for vid in roots]
    heapq.heapify(heap)

    while heap:
        d, vid = heapq.heappop(heap)
        if vid in finalized or d > dist.get(vid, float("inf")):
            continue
        finalized.add(vid)
        incoming = pred.get(vid)
        if incoming is not None and not verts[vid].fixed:
            e, from_vid, to_slot = incoming
            rule = _propagate_rule(e.etype.name)
            states = [verts[v].estimate for v in e.vids]
            new = rule(states, e.measurement, edge_param(e), to_slot)
            if new is not None:
                verts[vid].estimate = np.asarray(new, dtype=np.float64)
                n_init += 1
        for e, my_slot in adj.get(vid, ()):
            targets = _propagate_targets(e.etype.name, len(e.vids))
            for to_slot, to_vid in enumerate(e.vids):
                if (to_slot == my_slot or to_vid in finalized
                        or to_slot not in targets):
                    continue
                c = cost(e, vid, to_vid)
                if c is None or not np.isfinite(c):
                    continue
                nd = d + float(c)
                if nd >= dist.get(to_vid, float("inf")):
                    continue
                dist[to_vid] = nd
                pred[to_vid] = (e, vid, to_slot)
                heapq.heappush(heap, (nd, to_vid))
    return n_init
