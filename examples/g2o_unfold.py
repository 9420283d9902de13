"""Cost-bounded region growing + local optimization — analogue of the
reference ``examples/g2o_unfold`` (``g2o-unfold.cpp``, ``tools.cpp``).

The reference tool loads a 2D SLAM graph and grows a connected edge region
from a start edge, bounded by an edge-cost limit (the inverse robust chi2,
``g2o-unfold.cpp:66-79``); edges within the limit form the *selected* set,
edges past it the *border* (``tools.cpp
findConnectedEdgesWithCostLimit``).  It then optimizes and gnuplot-dumps
the edges annotated with their chi2 (``tools.cpp gnudump_edges``).

Array-program formulation: per-edge chi2 for the whole graph is ONE batched
device computation (``Problem.edge_chi2_fn``), the region growing is a
host-side BFS over the (static) adjacency, and the optimization is the
standard fused LM runner.

Run: python examples/g2o_unfold.py graph.g2o [-i N] [-maxCost C]
     [-guess] [-gnudump file.dat]
"""

import argparse
import os
import sys
from collections import deque

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def edge_costs_inv_chi2(graph, problem, eps: float = 1e-6):
    """1/(eps + robust chi2) per edge, aligned with ``graph.edges()`` order —
    the reference's ``InvChi2CostFunction`` (``g2o-unfold.cpp:66-79``)."""
    import numpy as np

    chis = problem.edge_chi2_fn(problem.data, problem.estimates)
    chis = {t: np.asarray(v) for t, v in chis.items()}
    pos = {t: 0 for t in chis}
    costs = []
    for e in graph.edges():
        t = e.etype.name
        if t in pos:
            costs.append(1.0 / (eps + float(chis[t][pos[t]])))
            pos[t] += 1
        else:  # level-filtered out of the compiled problem
            costs.append(float("inf"))
    return costs


def find_connected_edges_with_cost_limit(graph, start_edge: int, costs,
                                         max_edge_cost: float):
    """Grow a connected edge set from ``start_edge`` by BFS, splitting into
    (selected, border) index sets by ``max_edge_cost`` — the reference's
    ``findConnectedEdgesWithCostLimit`` (``tools.cpp:53-95``)."""
    edges = graph.edges()
    adj = {}
    for i, e in enumerate(edges):
        for vid in e.vids:
            adj.setdefault(vid, []).append(i)

    selected, border, seen = set(), set(), set()
    frontier = deque([start_edge])
    seen.add(start_edge)
    while frontier:
        i = frontier.popleft()
        c = costs[i]
        if c > max_edge_cost:
            border.add(i)
            continue
        selected.add(i)
        for vid in edges[i].vids:
            for j in adj[vid]:
                if j not in seen:
                    seen.add(j)
                    frontier.append(j)
    return selected, border


def gnudump_edges(path, graph, estimates_by_vid, costs, indices):
    """Dump edge endpoint estimates + chi2 to a gnuplot data file — the
    reference's ``gnudump_edges`` (``tools.cpp:101-160``)."""
    with open(path, "w") as fh:
        for i in sorted(indices):
            e = graph.edges()[i]
            chi2 = 1.0 / costs[i] - 1e-6 if costs[i] > 0 else float("inf")
            for vid in e.vids:
                est = estimates_by_vid[vid]
                fh.write(" ".join(f"{x:.6f}" for x in est[:3])
                         + f" {chi2:.6f}\n")
            fh.write("\n")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("input")
    ap.add_argument("-i", type=int, default=5, dest="iterations")
    ap.add_argument("-v", action="store_true", dest="verbose")
    ap.add_argument("-guess", action="store_true")
    ap.add_argument("-maxCost", type=float, default=None,
                    help="edge-cost limit for the region growing "
                         "(cost = 1/(1e-6 + chi2); small cost = bad edge)")
    ap.add_argument("-startEdge", type=int, default=0)
    ap.add_argument("-gnudump", default="")
    ap.add_argument("-o", default="", dest="output")
    args = ap.parse_args()

    import g2o_tpu
    import g2o_tpu.types  # register tags
    from g2o_tpu.core.initial_guess import compute_initial_guess
    from g2o_tpu.core.solvers import PCGSolver
    from g2o_tpu.io import g2o_format

    g = g2o_format.load(args.input)
    if not any(r.fixed for r in g.vertices().values()):
        g.set_fixed(min(g.vertices()), True)
    if args.guess:
        compute_initial_guess(g)
    p = g.compile()

    # region analysis BEFORE optimization (matches the reference flow:
    # errors are computed on the loaded estimates)
    costs = edge_costs_inv_chi2(g, p)
    if args.maxCost is not None:
        sel, border = find_connected_edges_with_cost_limit(
            g, args.startEdge, costs, args.maxCost)
        print(f"selected {len(sel)} edges, border {len(border)} edges "
              f"(maxCost {args.maxCost})")
    else:
        sel = set(range(g.num_edges))
        border = set()

    opt = g2o_tpu.SparseOptimizer(p, algorithm=g2o_tpu.LevenbergMarquardt(),
                                  solver=PCGSolver(), verbose=args.verbose)
    opt.optimize(args.iterations)

    est = p.estimates_by_vid()
    if args.gnudump:
        base, ext = os.path.splitext(args.gnudump)
        costs = edge_costs_inv_chi2(g, p)   # post-optimization chi2
        gnudump_edges(f"{base}_selected{ext or '.dat'}", g, est, costs, sel)
        if border:
            gnudump_edges(f"{base}_border{ext or '.dat'}", g, est, costs,
                          border)
        print(f"gnudump written ({base}_*{ext or '.dat'})")
    if args.output:
        g2o_format.save(g, args.output, estimates_by_vid=est)
        print(f"saved {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
