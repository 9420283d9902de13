"""Nonlinear optimization algorithms + the optimizer driver.

JAX analogues of the reference algorithm layer:

* :class:`GaussNewton` — ``OptimizationAlgorithmGaussNewton``
  (``g2o/core/optimization_algorithm_gauss_newton.cpp:50``)
* :class:`LevenbergMarquardt` — ``OptimizationAlgorithmLevenberg``
  (``g2o/core/optimization_algorithm_levenberg.cpp:58``), with the same
  trust-region bookkeeping: ``lambda_init = tau * max|H_jj|`` (``:152``),
  gain ratio ``rho = (chi0 - chi) / (dx^T (lambda dx + b) + eps)``
  (``:124-127``), accept: ``lambda *= max(1/3, 1-(2 rho-1)^3)``, reject:
  ``lambda *= nu; nu *= 2`` (``:128-142``), inner-trial cap (``:49``).
* :class:`Dogleg` — ``OptimizationAlgorithmDogleg``
  (``g2o/core/optimization_algorithm_dogleg.cpp:57``), blending the
  steepest-descent and Gauss-Newton steps inside a trust radius.

The outer iteration loop lives on the host (termination, verbose printing,
force-stop — mirroring ``SparseOptimizer::optimize``,
``g2o/core/sparse_optimizer.cpp:374``); each building block (linearize,
solve, apply, chi2) is a single jitted device program.  The reference's
push/pop estimate backup stacks (``g2o/core/base_vertex.h:93-96``) reduce to
keeping the previous estimates pytree on device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from g2o_tpu.core.solvers.dense import DenseSolver


@dataclasses.dataclass
class BatchStatistics:
    """Per-iteration stats — schema mirrors ``G2OBatchStatistics``
    (``g2o/core/batch_stats.h:40-77``)."""

    iteration: int = -1
    num_vertices: int = 0
    num_edges: int = 0
    chi2: float = 0.0
    time_residuals: float = 0.0
    time_linearize: float = 0.0
    time_quadratic_form: float = 0.0
    time_schur_complement: float = 0.0
    time_linear_solver: float = 0.0
    time_update: float = 0.0
    time_iteration: float = 0.0
    levenberg_iterations: int = 0
    lambda_value: float = 0.0
    iterations_linear_solver: int = 0

    def as_dict(self):
        return dataclasses.asdict(self)


def _max_abs_diag(problem, lin):
    """max |H_jj| over non-fixed vertices (LM lambda init,
    ``optimization_algorithm_levenberg.cpp:152-176``)."""
    m = -jnp.inf
    for t, vt in problem.vertex_types.items():
        d = vt.tangent_dim
        diag_entries = jnp.abs(
            jnp.diagonal(lin.diag[t], axis1=-2, axis2=-1)
        )  # (N, d)
        mask = 1.0 - problem.data.fixed[t].astype(problem.dtype)
        m = jnp.maximum(m, jnp.max(diag_entries * mask[:, None]))
    return m


class OptimizationAlgorithm:
    """Strategy interface (reference ``OptimizationAlgorithm``,
    ``g2o/core/optimization_algorithm.h:47``)."""

    def init(self, optimizer):
        pass

    def step(self, optimizer, iteration: int, stats: BatchStatistics) -> bool:
        raise NotImplementedError

    def print_verbose_suffix(self) -> str:
        return ""


class GaussNewton(OptimizationAlgorithm):
    def step(self, optimizer, iteration, stats):
        p = optimizer.problem
        t0 = time.perf_counter()
        lin = p.linearize_jit(p.data, p.estimates)
        stats.chi2 = float(lin.chi2_robust)
        stats.time_linearize = time.perf_counter() - t0

        t0 = time.perf_counter()
        dx = optimizer.solver.solve(p.data, lin, 0.0)
        dx.block_until_ready()
        stats.time_linear_solver = time.perf_counter() - t0

        t0 = time.perf_counter()
        new_est = p.apply_jit(p.data, p.estimates, dx)
        chi2_new, _ = p.chi2_jit(p.data, new_est)
        chi2_new = float(chi2_new)
        stats.time_update = time.perf_counter() - t0
        if not np.isfinite(chi2_new):
            if optimizer.write_debug:
                from g2o_tpu.utils.debug_dump import dump_failed_system
                dump_failed_system(p, lin, 0.0, iteration,
                                   optimizer.write_debug,
                                   reason="non-finite chi2 after GN step",
                                   chi2=stats.chi2)
            return False
        p.set_estimates(new_est)
        optimizer.current_chi2 = chi2_new
        return True


class LevenbergMarquardt(OptimizationAlgorithm):
    def __init__(self, initial_lambda: float = 0.0,
                 max_trials_after_failure: int = 10, tau: float = 1e-5):
        self.initial_lambda = initial_lambda
        self.max_trials = int(max_trials_after_failure)
        self.tau = tau
        self._lambda = None
        self._ni = 2.0
        self._levenberg_iters = 0

    def init(self, optimizer):
        self._lambda = None
        self._ni = 2.0

    def step(self, optimizer, iteration, stats):
        p = optimizer.problem
        t0 = time.perf_counter()
        lin = p.linearize_jit(p.data, p.estimates)
        current_chi2 = float(lin.chi2_robust)
        stats.chi2 = current_chi2
        stats.time_linearize = time.perf_counter() - t0

        if self._lambda is None:
            if self.initial_lambda > 0:
                self._lambda = float(self.initial_lambda)
            else:
                self._lambda = float(self.tau * _max_abs_diag(p, lin))

        rho = 0.0
        trials = 0
        good = False
        t_solve = 0.0
        while not good and trials < self.max_trials:
            t0 = time.perf_counter()
            dx = optimizer.solver.solve(p.data, lin, self._lambda)
            new_est = p.apply_jit(p.data, p.estimates, dx)
            chi2_new_dev, _ = p.chi2_jit(p.data, new_est)
            chi2_new = float(chi2_new_dev)
            t_solve += time.perf_counter() - t0

            # gain ratio (``…levenberg.cpp:124-127``)
            scale = float(jnp.sum(dx * (self._lambda * dx + lin.b))) + 1e-3
            rho = (current_chi2 - chi2_new) / scale
            if np.isfinite(chi2_new) and rho > 0 and chi2_new < current_chi2:
                good = True
                self._lambda *= max(1.0 / 3.0,
                                    1.0 - (2.0 * rho - 1.0) ** 3)
                self._ni = 2.0
                p.set_estimates(new_est)
                optimizer.current_chi2 = chi2_new
            else:
                self._lambda *= self._ni
                self._ni *= 2.0
                trials += 1
                if not np.isfinite(self._lambda):
                    break
        stats.time_linear_solver = t_solve
        stats.levenberg_iterations = trials + (1 if good else 0)
        stats.lambda_value = self._lambda
        self._levenberg_iters = stats.levenberg_iterations
        if not good and optimizer.write_debug:
            from g2o_tpu.utils.debug_dump import dump_failed_system
            dump_failed_system(
                p, lin, self._lambda, iteration, optimizer.write_debug,
                reason=f"LM exhausted {trials} trials (last rho={rho:.3g})",
                chi2=current_chi2)
        return good

    def print_verbose_suffix(self):
        return (f"\t lambda= {self._lambda:.6g}"
                f"\t levenbergIter= {self._levenberg_iters}")


class Dogleg(OptimizationAlgorithm):
    """Powell's dogleg (reference ``optimization_algorithm_dogleg.cpp:57``)."""

    def __init__(self, initial_delta: float = 100.0, max_trials: int = 30):
        self.delta = float(initial_delta)
        self.max_trials = int(max_trials)
        self._last_step = "GN"

    def init(self, optimizer):
        pass

    def step(self, optimizer, iteration, stats):
        p = optimizer.problem
        lin = p.linearize_jit(p.data, p.estimates)
        current_chi2 = float(lin.chi2_robust)
        stats.chi2 = current_chi2

        b = lin.b
        Hb = p.hvp_jit(p.data, lin, b)
        alpha = float(jnp.sum(b * b)) / max(float(jnp.sum(b * Hb)), 1e-300)
        h_sd = alpha * b
        h_gn = optimizer.solver.solve(p.data, lin, 0.0)
        norm_gn = float(jnp.linalg.norm(h_gn))
        norm_sd = float(jnp.linalg.norm(h_sd))

        good = False
        trials = 0
        while not good and trials < self.max_trials:
            if np.isfinite(norm_gn) and norm_gn <= self.delta:
                h_dl, self._last_step = h_gn, "GN"
            elif norm_sd >= self.delta:
                h_dl = (self.delta / norm_sd) * h_sd
                self._last_step = "SD"
            else:
                # blend along the dogleg path: h_sd + beta (h_gn - h_sd)
                diff = h_gn - h_sd
                a = float(jnp.sum(diff * diff))
                bcoef = float(jnp.sum(h_sd * diff))
                c = float(jnp.sum(h_sd * h_sd)) - self.delta ** 2
                beta = (-bcoef + np.sqrt(max(bcoef * bcoef - a * c, 0.0))) / max(a, 1e-300)
                h_dl = h_sd + beta * diff
                self._last_step = "DL"

            new_est = p.apply_jit(p.data, p.estimates, h_dl)
            chi2_new = float(p.chi2_jit(p.data, new_est)[0])
            # predicted reduction of the quadratic model
            Hh = p.hvp_jit(p.data, lin, h_dl)
            pred = float(jnp.sum(h_dl * b) - 0.5 * jnp.sum(h_dl * Hh))
            rho = (current_chi2 - chi2_new) / max(pred, 1e-300)
            norm_dl = float(jnp.linalg.norm(h_dl))
            if np.isfinite(chi2_new) and rho > 0:
                good = True
                p.set_estimates(new_est)
                optimizer.current_chi2 = chi2_new
            if rho > 0.75:
                self.delta = max(self.delta, 3.0 * norm_dl)
            elif rho < 0.25:
                self.delta *= 0.5
                if self.delta < 1e-12:
                    break
            trials += 1
        stats.levenberg_iterations = trials
        return good

    def print_verbose_suffix(self):
        return f"\t delta= {self.delta:.6g}\t step= {self._last_step}"


class SparseOptimizer:
    """The driver — reference ``SparseOptimizer``
    (``g2o/core/sparse_optimizer.h:44``)."""

    def __init__(self, problem, algorithm: Optional[OptimizationAlgorithm] = None,
                 solver=None, verbose: bool = False):
        self.problem = problem
        self.algorithm = algorithm or LevenbergMarquardt()
        self.solver = (solver or DenseSolver()).setup(problem)
        self.verbose = verbose
        self.current_chi2 = None
        self.batch_statistics: list[BatchStatistics] = []
        self.force_stop = False
        self.terminate_gain_threshold: Optional[float] = None
        # failure diagnostics: directory to dump the linearized system to on
        # a failed step (reference ``writeDebug``, ``g2o/core/solver.h:128``)
        self.write_debug: Optional[str] = None
        # pre/post iteration hooks — analogue of HyperGraphAction
        # (``g2o/core/hyper_graph_action.h:49``); called as fn(optimizer, it)
        self.pre_iteration_actions: list = []
        self.post_iteration_actions: list = []

    def chi2(self):
        c, _ = self.problem.chi2_jit(self.problem.data, self.problem.estimates)
        return float(c)

    def optimize(self, max_iterations: int) -> int:
        self.algorithm.init(self)
        self.batch_statistics = []
        cum_time = 0.0
        prev_chi2 = None
        it = 0
        for it in range(max_iterations):
            if self.force_stop:
                # it iterations (0..it-1) completed before the stop
                return it
            stats = BatchStatistics(
                iteration=it,
                num_vertices=sum(self.problem.counts.values()),
                num_edges=self.problem.num_edges,
            )
            for action in self.pre_iteration_actions:
                action(self, it)
            t0 = time.perf_counter()
            ok = self.algorithm.step(self, it, stats)
            stats.time_iteration = time.perf_counter() - t0
            for action in self.post_iteration_actions:
                action(self, it)
            cum_time += stats.time_iteration
            self.batch_statistics.append(stats)
            if self.verbose:
                print(
                    f"iteration= {it}\t chi2= {stats.chi2:.6f}\t "
                    f"time= {stats.time_iteration:.5g}\t "
                    f"cumTime= {cum_time:.5g}\t "
                    f"edges= {stats.num_edges}"
                    + self.algorithm.print_verbose_suffix()
                )
            if not ok:
                return it
            # gain-based early termination (reference
            # ``SparseOptimizerTerminateAction``,
            # ``sparse_optimizer_terminate_action.h:45``)
            if self.terminate_gain_threshold is not None and prev_chi2 is not None:
                cur = self.current_chi2
                if cur is not None and prev_chi2 > 0:
                    gain = (prev_chi2 - cur) / prev_chi2
                    if 0 <= gain < self.terminate_gain_threshold:
                        return it + 1
            prev_chi2 = self.current_chi2
        return it + 1 if max_iterations > 0 else 0
