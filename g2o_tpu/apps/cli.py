"""Command-line optimizer — the analogue of the reference ``g2o`` CLI
(``g2o/apps/g2o_cli/g2o.cpp:103-460``).

Usage::

    python -m g2o_tpu.apps.cli [options] graph.g2o

Supported flags mirror the reference's core set: iterations, output file,
verbose, solver selection (``-listSolvers``), robust kernel attachment
(``-robustKernel/-robustKernelWidth``), spanning-tree initial guess
(``-guess``), landmark marginalization (``-marginalize``), per-iteration
statistics dump (``-stats``), run summary (``-summary``), gain-based
termination (negative ``-i`` enables it as in the reference).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


SOLVERS = {}


def _build_solver_table():
    from g2o_tpu.core.solvers import DenseSolver, PCGSolver, SchurSolver
    from g2o_tpu.core.solvers.cgls import CGLSSolver

    def dense():
        return DenseSolver()

    def pcg():
        return PCGSolver(max_iter=100, tol=1e-8)

    def cgls():
        return CGLSSolver(max_iter=200, eta=1e-6)

    def schur():
        return SchurSolver()

    def sparse_chol():
        from g2o_tpu.core.solvers.sparse_chol import SparseCholeskySolver

        return SparseCholeskySolver()

    def schur_implicit():
        from g2o_tpu.core.solvers.schur_implicit import ImplicitSchurSolver

        return ImplicitSchurSolver()

    def schur_implicit_bucketed():
        # the BA fast path: degree-bucketed landmark reductions + one-hot
        # camera matmuls + eta-forcing CG (inexact Newton)
        from g2o_tpu.core.solvers.schur_implicit import ImplicitSchurSolver

        return ImplicitSchurSolver(max_iter=100, tol=1e-2, precond="jacobi",
                                   layout="bucketed")

    def supernodal():
        from g2o_tpu.core.solvers.supernodal import SupernodalCholeskySolver

        return SupernodalCholeskySolver()

    def host_chol():
        from g2o_tpu.core.solvers.host_chol import HostCholSolver

        return HostCholSolver()

    for algo in ("gn", "lm", "dl"):
        SOLVERS[f"{algo}_dense"] = (algo, dense)
        SOLVERS[f"{algo}_pcg"] = (algo, pcg)
        SOLVERS[f"{algo}_cgls"] = (algo, cgls)
        SOLVERS[f"{algo}_schur"] = (algo, schur)
        SOLVERS[f"{algo}_sparse_chol"] = (algo, sparse_chol)
        SOLVERS[f"{algo}_supernodal"] = (algo, supernodal)
        SOLVERS[f"{algo}_schur_implicit"] = (algo, schur_implicit)
        SOLVERS[f"{algo}_schur_implicit_bucketed"] = (
            algo, schur_implicit_bucketed)
        # hybrid: device linearize/assembly + native host f64 sparse
        # Cholesky (the reference csparse/cholmod analogue, host-loop only)
        SOLVERS[f"{algo}_host_chol"] = (algo, host_chol)
        # reference-style aliases: variable/fixed block sizes all map onto
        # the same array-typed pipeline
        for alias in ("var", "fix6_3", "fix7_3", "fix3_2"):
            SOLVERS[f"{algo}_{alias}"] = (algo, pcg)
        SOLVERS[f"{algo}_var_cholmod"] = (algo, pcg)


def _make_algorithm(name, fused):
    from g2o_tpu.core.lm_fused import FusedLevenbergMarquardt
    from g2o_tpu.core.optimizer import Dogleg, GaussNewton, LevenbergMarquardt

    if name == "gn":
        return GaussNewton()
    if name == "dl":
        return Dogleg()
    return FusedLevenbergMarquardt() if fused else LevenbergMarquardt()


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="g2o_tpu",
        description="JAX graph optimizer (g2o-compatible CLI subset)")
    ap.add_argument("input", nargs="?", help=".g2o input file")
    ap.add_argument("-i", "--iterations", type=int, default=10,
                    help="iterations; negative enables gain termination "
                         "with |i| as cap (reference semantics)")
    ap.add_argument("-o", "--output", default=None, help="optimized output")
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("-solver", default="lm_pcg",
                    help="solver tag (see -listSolvers)")
    ap.add_argument("-robustKernel", default=None)
    ap.add_argument("-robustKernelWidth", type=float, default=1.0)
    ap.add_argument("-guess", action="store_true",
                    help="spanning-tree initial guess")
    ap.add_argument("-guessLinear", action="store_true",
                    help="SLAM2D linear orientation+position initialization "
                         "(Carlone et al.)")
    ap.add_argument("-marginalize", action="store_true",
                    help="Schur-marginalize all landmark (non-max-dim) vertices")
    ap.add_argument("-stats", default=None, help="write per-iteration stats")
    ap.add_argument("-summary", default=None, help="append run summary json")
    ap.add_argument("-gainThreshold", type=float, default=1e-6)
    ap.add_argument("-fused", action="store_true",
                    help="run the device-fused LM loop")
    ap.add_argument("-fp64", action="store_true", help="force float64")
    ap.add_argument("-listSolvers", action="store_true")
    ap.add_argument("-listKernels", action="store_true")
    ap.add_argument("-listTypes", action="store_true")
    ap.add_argument("-renameTypes", default=None,
                    help="on-disk tag remapping 'oldtag=newtag,...' "
                         "(reference -renameTypes)")
    ap.add_argument("-solverProperties", default=None,
                    help="'key=value,...' applied to the solver/algorithm "
                         "(e.g. max_iter=200,tol=1e-8,initial_lambda=1e-4)")
    ap.add_argument("-printSolverProperties", action="store_true")
    ap.add_argument("-inc", action="store_true",
                    help="incremental mode: re-add edges ordered by max "
                         "vertex id, optimizing as the graph grows "
                         "(reference g2o.cpp:373-460)")
    ap.add_argument("-update", type=int, default=10,
                    help="incremental: optimize every N new vertices")
    ap.add_argument("-incIterations", type=int, default=1,
                    help="incremental: iterations per update")
    ap.add_argument("-gt", default=None,
                    help="ground-truth .g2o file: report ATE/RPE after "
                         "optimization")
    ap.add_argument("-gnudump", default=None,
                    help="dump the optimized graph for gnuplot "
                         "(reference -gnudump)")
    ap.add_argument("-dumpGraphviz", default=None,
                    help="dump the hyper-graph structure as graphviz dot")
    ap.add_argument("-plot", default=None,
                    help="render the optimized graph to an image "
                         "(.png/.svg/.pdf) — the no-GUI viewer substitute")
    ap.add_argument("-htmlPlot", default=None,
                    help="render the optimized graph to a standalone "
                         "interactive HTML file (pan/zoom)")
    ap.add_argument("-writeDebug", default=None, metavar="DIR",
                    help="on a failed step, dump the linearized system "
                         "(H diag blocks, b, lambda) to DIR as .npz "
                         "(reference writeDebug, solver.h:128)")
    ap.add_argument("-replayHtml", default=None,
                    help="record per-iteration estimates and write a "
                         "standalone HTML replay (slider + play through "
                         "the optimization) — the no-GUI analogue of "
                         "viewer stepping; forces the host-loop path")
    args = ap.parse_args(argv)

    _build_solver_table()
    if args.listSolvers:
        for k in sorted(SOLVERS):
            print(k)
        return 0

    import g2o_tpu.types  # register type libraries
    from g2o_tpu.core.types import REGISTRY
    from g2o_tpu.ops import robust as robust_mod

    if args.listKernels:
        for k in sorted(robust_mod.KERNEL_IDS):
            if k:
                print(k)
        return 0
    if args.listTypes:
        for t in REGISTRY.known_tags():
            print(t)
        return 0
    if not args.input:
        ap.error("missing input file")

    import jax

    from g2o_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    if args.fp64:
        jax.config.update("jax_enable_x64", True)

    from g2o_tpu.core.initial_guess import compute_initial_guess
    from g2o_tpu.core.optimizer import SparseOptimizer
    from g2o_tpu.io import g2o_format

    rename = None
    if args.renameTypes:
        rename = dict(kv.split("=", 1) for kv in
                      args.renameTypes.split(",") if "=" in kv)

    t0 = time.perf_counter()
    g = g2o_format.load(args.input, rename=rename)
    print(f"loaded {args.input}: {g.num_vertices} vertices, "
          f"{g.num_edges} edges ({time.perf_counter() - t0:.2f} s)",
          file=sys.stderr)

    if args.robustKernel:
        g.set_robust_kernel(args.robustKernel, args.robustKernelWidth)

    # gauge handling (reference gaugeFreedom/findGauge,
    # ``sparse_optimizer.cpp:118,139``)
    if not any(r.fixed for r in g.vertices().values()):
        # findGauge-style pick: lowest id of the LARGEST-tangent-dim type
        # (fixing a 3-dof landmark leaves rotational gauge freedom)
        dmax = max(r.vtype.tangent_dim for r in g.vertices().values())
        first = min(vid for vid, r in g.vertices().items()
                    if r.vtype.tangent_dim == dmax)
        g.set_fixed(first, True)
        print(f"# graph is fixed by node {first}", file=sys.stderr)

    if args.marginalize:
        max_dim = max(r.vtype.tangent_dim for r in g.vertices().values())
        n = 0
        for vid, r in g.vertices().items():
            if r.vtype.tangent_dim != max_dim:
                g.set_marginalized(vid, True)
                n += 1
        print(f"# marginalized {n} vertices", file=sys.stderr)

    if args.guess:
        n = compute_initial_guess(g)
        print(f"# initial guess for {n} vertices", file=sys.stderr)
    if args.guessLinear:
        from g2o_tpu.core.slam2d_linear import solve_slam2d_linear

        n = solve_slam2d_linear(g)
        print(f"# linear 2D initialization for {n} poses", file=sys.stderr)

    algo_name, solver_factory = SOLVERS.get(args.solver, (None, None))
    if algo_name is None:
        print(f"unknown solver {args.solver!r}; see -listSolvers",
              file=sys.stderr)
        return 1

    def apply_properties(*objs, warn=True):
        """Route '-solverProperties k=v,...' onto solver/algorithm knobs —
        the analogue of the reference PropertyMap::updateMapFromString
        (``stuff/property.h:41-159``, CLI wiring ``g2o.cpp:225-237``).
        ``warn=False`` silences the unknown-key warning when the same
        property string is applied to solver and algorithm in separate
        calls (incremental mode's factories)."""
        if args.printSolverProperties:
            for o in objs:
                for k, v in sorted(vars(o).items()):
                    if not k.startswith("_") and isinstance(
                            v, (int, float, bool, str)):
                        print(f"{type(o).__name__}.{k} = {v}",
                              file=sys.stderr)
        if not args.solverProperties:
            return
        for kv in args.solverProperties.split(","):
            if "=" not in kv:
                continue
            k, v = kv.split("=", 1)
            hit = False
            for o in objs:
                if hasattr(o, k) and not k.startswith("_"):
                    cur = getattr(o, k)
                    cast = type(cur) if not isinstance(cur, bool) else \
                        (lambda s: s.lower() in ("1", "true", "yes"))
                    setattr(o, k, cast(v))
                    hit = True
            if not hit and warn:
                print(f"# warning: unknown solver property {k!r}",
                      file=sys.stderr)

    if args.inc:
        return _run_incremental(args, g, algo_name, solver_factory,
                                apply_properties)

    p = g.compile()
    n_iter = abs(args.iterations)
    use_gain = args.iterations < 0

    if args.replayHtml and args.fused:
        print("# -replayHtml needs per-iteration estimates: using the "
              "host-loop path", file=sys.stderr)
        args.fused = False
    if args.fused and "host_chol" in args.solver:
        print("# host_chol factorizes on the host CPU and cannot run in a "
              "fused device loop: using the host-loop path", file=sys.stderr)
        args.fused = False
    if args.fused and getattr(args, "writeDebug", None):
        print("# -writeDebug needs per-iteration host inspection: using "
              "the host-loop path", file=sys.stderr)
        args.fused = False

    if args.fused and algo_name == "lm":
        from g2o_tpu.core.lm_fused import optimize_fused

        solver = solver_factory()
        apply_properties(solver)
        res = optimize_fused(
            p, solver, n_iter,
            gain_threshold=args.gainThreshold if use_gain else 0.0)
        for it, (chi, tr) in enumerate(zip(res["chi2_per_iteration"],
                                           res["trials_per_iteration"])):
            if args.verbose:
                print(f"iteration= {it}\t chi2= {chi:.6f}\t "
                      f"levenbergIter= {tr}")
        print(f"final chi2= {res['chi2_final']:.6f} "
              f"({res['iterations']} iterations, {res['wall_s']:.3f} s)",
              file=sys.stderr)
        stats_rows = [
            {"iteration": i, "chi2": c, "levenberg_iterations": int(t)}
            for i, (c, t) in enumerate(zip(res["chi2_per_iteration"],
                                           res["trials_per_iteration"]))
        ]
        summary = {"input": args.input, "final_chi2": res["chi2_final"],
                   "iterations": res["iterations"],
                   "wall_s": res["wall_s"], "solver": args.solver}
    else:
        algorithm = _make_algorithm(algo_name, args.fused)
        solver = solver_factory()
        apply_properties(solver, algorithm)
        opt = SparseOptimizer(p, algorithm=algorithm, solver=solver,
                              verbose=args.verbose)
        opt.write_debug = args.writeDebug
        if use_gain:
            opt.terminate_gain_threshold = args.gainThreshold
        replay_frames, replay_chi2 = [], []
        if args.replayHtml:
            replay_frames.append(p.estimates_by_vid())
            replay_chi2.append(float(opt.chi2()))

            def _record(o, it):
                replay_frames.append(o.problem.estimates_by_vid())
                # post_iteration_actions fire even on rejected steps, where
                # current_chi2 may still be None (already-converged input)
                c2 = o.current_chi2
                replay_chi2.append(float(c2) if c2 is not None
                                   else replay_chi2[-1])

            opt.post_iteration_actions.append(_record)
        t0 = time.perf_counter()
        done = opt.optimize(n_iter)
        wall = time.perf_counter() - t0
        print(f"final chi2= {opt.chi2():.6f} ({done} iterations, "
              f"{wall:.3f} s)", file=sys.stderr)
        stats_rows = [s.as_dict() for s in opt.batch_statistics]
        summary = {"input": args.input, "final_chi2": opt.chi2(),
                   "iterations": done, "wall_s": wall,
                   "solver": args.solver}

    if args.stats:
        with open(args.stats, "w") as fh:
            for row in stats_rows:
                fh.write(json.dumps(row) + "\n")
    if args.summary:
        with open(args.summary, "a") as fh:
            fh.write(json.dumps(summary) + "\n")
    if args.gt:
        _report_ate(args, g, p.estimates_by_vid(), rename)
    if args.output:
        g2o_format.save(g, args.output,
                        estimates_by_vid=p.estimates_by_vid())
        print(f"wrote {args.output}", file=sys.stderr)
    if args.gnudump:
        from g2o_tpu.io.export import write_gnuplot

        write_gnuplot(g, args.gnudump,
                      estimates_by_vid=p.estimates_by_vid())
        print(f"wrote {args.gnudump}", file=sys.stderr)
    if args.dumpGraphviz:
        from g2o_tpu.io.export import write_dot

        write_dot(g, args.dumpGraphviz)
        print(f"wrote {args.dumpGraphviz}", file=sys.stderr)
    if args.plot or args.htmlPlot:
        from g2o_tpu.io import viz

        if args.plot:
            viz.render_graph(g, args.plot,
                             estimates_by_vid=p.estimates_by_vid(),
                             title=args.input)
            print(f"wrote {args.plot}", file=sys.stderr)
        if args.htmlPlot:
            viz.render_html(g, args.htmlPlot,
                            estimates_by_vid=p.estimates_by_vid(),
                            title=str(args.input))
            print(f"wrote {args.htmlPlot}", file=sys.stderr)
    if args.replayHtml:
        from g2o_tpu.io import viz

        viz.render_replay_html(g, args.replayHtml, replay_frames,
                               replay_chi2, title=str(args.input))
        print(f"wrote {args.replayHtml} ({len(replay_frames)} frames)",
              file=sys.stderr)
    return 0


def _report_ate(args, g, est_by_vid, rename):
    """ATE/RPE against a ground-truth .g2o trajectory (BASELINE.md parity
    metrics; the reference leaves this to external evo-style tools)."""
    from g2o_tpu.io import g2o_format
    from g2o_tpu.utils.metrics import ate, rpe

    gt_graph = g2o_format.load(args.gt, rename=rename)
    gt_recs = gt_graph.vertices()
    by_shape = {}
    for vid in sorted(est_by_vid):
        if vid in gt_recs:
            sh = est_by_vid[vid].shape
            by_shape.setdefault(sh, ([], []))
            by_shape[sh][0].append(est_by_vid[vid])
            by_shape[sh][1].append(gt_recs[vid].estimate)
    # the trajectory = poses, not landmarks: prefer the LARGEST state
    # dimension (SE3 (7,) beats TRACKXYZ (3,) even when landmarks
    # outnumber cameras — metrics._positions would misread xyz points as
    # (x, y, theta) and drop z), then group size
    est, gt = max(by_shape.items(),
                  key=lambda kv: (kv[0][-1], len(kv[1][0])))[1] \
        if by_shape else ([], [])
    if len(est) < 2:
        print("# -gt: no overlapping vertex ids", file=sys.stderr)
        return
    print(f"ATE(rmse)= {ate(est, gt):.6f}  RPE(rmse)= {rpe(est, gt):.6f}  "
          f"over {len(est)} poses")


def _run_incremental(args, g, algo_name, solver_factory, apply_properties):
    """Incremental mode — re-add edges ordered by max vertex id, optimizing
    every ``-update`` vertices (reference ``g2o.cpp:373-460``)."""
    from g2o_tpu.core.incremental import IncrementalOptimizer

    def solver_with_props():
        s = solver_factory()
        apply_properties(s)
        return s

    def algorithm_factory():
        a = _make_algorithm(algo_name, False)
        apply_properties(a, warn=False)   # solver-side call already warns
        return a

    inc = IncrementalOptimizer(solver_factory=solver_with_props,
                               algorithm_factory=algorithm_factory,
                               verbose=args.verbose)
    for pid, val in g._parameters.items():
        inc.graph.add_parameter(pid, val)     # param-bearing edges re-add
    vrecs = g.vertices()
    edges = sorted(g.edges(), key=lambda e: max(e.vids))
    added = set()
    n_since = 0
    t0 = time.perf_counter()
    for e in edges:
        for vid in e.vids:
            if vid not in added:
                r = vrecs[vid]
                inc.add_vertex(vid, r.vtype, r.estimate, fixed=r.fixed)
                added.add(vid)
                n_since += 1
        inc.add_edge(e.etype, e.vids, e.measurement, e.information,
                     kernel=e.kernel, delta=e.delta, param_id=e.param_id,
                     level=e.level, active=e.active)
        if n_since >= args.update:
            inc.optimize(args.incIterations)
            n_since = 0
            if args.verbose:
                print(f"vertices= {len(added)}\t chi2= {inc.chi2():.6f}",
                      file=sys.stderr)
    inc.optimize(max(args.incIterations, 1))
    wall = time.perf_counter() - t0
    print(f"final chi2= {inc.chi2():.6f} ({len(added)} vertices, "
          f"{inc.recompiles} recompiles, {wall:.3f} s)", file=sys.stderr)
    if args.output:
        from g2o_tpu.io import g2o_format

        g2o_format.save(inc.graph, args.output,
                        estimates_by_vid=inc.problem.estimates_by_vid())
        print(f"wrote {args.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
