"""Multi-device SPMD execution — mesh creation and edge/array sharding.

The reference's only parallelism is shared-memory OpenMP loops over edges
with per-vertex mutexes (``g2o/core/sparse_optimizer.cpp:72-78``,
``block_solver.hpp:482-506``, SURVEY.md §2.7).  The JAX equivalent is
SPMD over a ``jax.sharding.Mesh``:

* the *edge* axis of every edge-type batch is sharded across devices (the
  analogue of the OpenMP edge loop, and of data parallelism);
* vertex estimates and the assembled gradient/Hessian are replicated; the
  segment-sum scatter-adds become per-shard partial sums that XLA's GSPMD
  partitioner completes with ``psum``-style collectives over ICI — replacing
  the reference's per-vertex mutexes (``g2o/core/base_edge.h:42-58``);
* the whole GN/LM step (linearize → solve → oplus) is one jitted program so
  collective scheduling can overlap with compute.

Landmark-sharded Schur (the EP-like axis) builds on the same helpers.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from g2o_tpu.core.problem import EdgeBatchData, ProblemData

EDGE_AXIS = "edges"


def make_mesh(n_devices: int | None = None, axis: str = EDGE_AXIS) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def shard_problem_data(data: ProblemData, mesh: Mesh,
                       axis: str = EDGE_AXIS) -> ProblemData:
    """Place edge batches sharded over the mesh edge axis; everything else
    replicated. Edge counts must divide the axis size (use
    ``compile(..., pad_edges_to_multiple=n_devices)``)."""
    edge_spec = NamedSharding(mesh, P(axis))
    repl = NamedSharding(mesh, P())

    def shard_batch(b: EdgeBatchData) -> EdgeBatchData:
        return EdgeBatchData(*[jax.device_put(x, edge_spec) for x in b])

    return ProblemData(
        edges={k: shard_batch(b) for k, b in data.edges.items()},
        fixed={k: jax.device_put(v, repl) for k, v in data.fixed.items()},
        offsets={k: jax.device_put(v, repl) for k, v in data.offsets.items()},
        fixed_flat=jax.device_put(data.fixed_flat, repl),
        plans={k: {kk: jax.device_put(vv, repl) for kk, vv in d.items()}
               for k, d in data.plans.items()},
    )


def replicate_estimates(estimates: dict, mesh: Mesh) -> dict:
    repl = NamedSharding(mesh, P())
    return {k: jax.device_put(v, repl) for k, v in estimates.items()}


def make_fused_step(problem, solver, *, donate: bool = True):
    """One full optimization step as a single jitted program:
    linearize → solve(lambda) → apply. Returns
    ``step(data, estimates, lam) -> (new_estimates, chi2_robust, chi2)``.

    Works single-device or SPMD (pass sharded ``data``/``estimates``)."""
    solve_fn = solver._solve_fn

    def step(data, estimates, lam, aux):
        lin = problem.linearize_fn(data, estimates)
        dx = solve_fn(data, lin, lam, aux)
        new_est = problem.apply_update_fn(data, estimates, dx)
        return new_est, lin.chi2_robust, lin.chi2

    step_jit = jax.jit(step, donate_argnums=(1,) if donate else ())

    def run(data, estimates, lam):
        return step_jit(data, estimates, lam, solver.aux)

    return run
