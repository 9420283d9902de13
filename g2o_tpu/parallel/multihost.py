"""Multi-host (multi-process) execution helpers.

The reference has no distributed backend at all (SURVEY.md §5.8 — OpenMP
shared memory only); this module is the scale-out axis across processes.
The recipe follows the standard JAX SPMD model:

1. every process calls :func:`initialize_distributed` with the
   coordinator address, the process count and its process id (nothing in
   a plain GPU machine tells JAX of a cluster, so they are given
   explicitly);
2. :func:`make_global_mesh` builds a mesh over ALL devices of the job —
   1-D (``edges``) for pure data-parallel edge sharding, or 2-D
   (``hosts × edges``) via ``hosts_axis=True`` so cross-host traffic rides
   the host network only for the small replicated reductions while the
   heavy edge-batch segment sums stay on the NVLink between the cards of
   one host;
3. shard with :func:`~g2o_tpu.parallel.sharded.shard_problem_data` and run
   the same jitted step — GSPMD inserts the collectives.

Process-local array creation uses ``jax.make_array_from_process_local_data``
so each host only materializes its own edge shard (the dataset can be
loaded host-sharded, the analogue of a distributed data loader).
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from g2o_tpu.core.problem import EdgeBatchData, ProblemData
from g2o_tpu.parallel.sharded import EDGE_AXIS

HOST_AXIS = "hosts"


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           local_device_ids=None) -> None:
    """Bring up the JAX distributed runtime (no-op when already up).

    With an explicit ``coordinator_address`` every failure is raised: a
    misconfigured launch (wrong address, mismatched process count) must
    not degrade silently to one process.  Only the "already initialized"
    error of a repeated call is swallowed.  Without one, a failure to find
    a cluster means a single-process run, and is ignored.

    NOTE: do NOT probe ``jax.process_count()`` first — it initializes the
    LOCAL backend, after which ``jax.distributed.initialize`` raises."""
    kw = {}
    if coordinator_address is not None:
        kw["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kw["num_processes"] = int(num_processes)
    if process_id is not None:
        kw["process_id"] = int(process_id)
    if local_device_ids is not None:
        kw["local_device_ids"] = local_device_ids
    try:
        jax.distributed.initialize(**kw)
    except (RuntimeError, ValueError) as e:
        if "should only be called once" in str(e):
            return
        if coordinator_address is not None:
            raise


def make_global_mesh(*, hosts_axis: bool = False) -> Mesh:
    """Mesh over every device in the job.

    ``hosts_axis=False``: 1-D ``(edges,)`` over all devices.
    ``hosts_axis=True``: 2-D ``(hosts, edges)`` with the host axis outermost
    — shard the edge dimension over BOTH axes (``P(('hosts', 'edges'))``)
    and keep estimates replicated; the gradient/Hessian reductions then
    reduce over the cards of a host first, across hosts last."""
    devs = np.asarray(jax.devices())
    if not hosts_axis:
        return Mesh(devs, (EDGE_AXIS,))
    nproc = jax.process_count()
    per_host = len(devs) // nproc
    return Mesh(devs.reshape(nproc, per_host), (HOST_AXIS, EDGE_AXIS))


def edge_partition_spec(mesh: Mesh) -> P:
    """PartitionSpec sharding the edge batch dimension over every mesh axis."""
    if len(mesh.axis_names) == 1:
        return P(mesh.axis_names[0])
    return P(tuple(mesh.axis_names))


def shard_problem_data_global(data: ProblemData, mesh: Mesh) -> ProblemData:
    """Multi-host variant of
    :func:`~g2o_tpu.parallel.sharded.shard_problem_data`: edge batches are
    assembled from process-local rows (each host contributes its slice of
    the globally-concatenated edge arrays), everything else replicated."""
    spec = edge_partition_spec(mesh)
    edge_sh = NamedSharding(mesh, spec)
    repl = NamedSharding(mesh, P())

    def put_edges(x):
        x = np.asarray(x)
        if jax.process_count() == 1:
            return jax.device_put(x, edge_sh)
        # every process holds the full (globally identical) edge arrays;
        # hand JAX only this process's contiguous row slice — the edge axis
        # is sharded over (hosts, edges) with the host axis outermost, so
        # process p owns rows [p*per, (p+1)*per)
        nproc, pid = jax.process_count(), jax.process_index()
        per = x.shape[0] // nproc
        local = x[pid * per:(pid + 1) * per]
        return jax.make_array_from_process_local_data(
            edge_sh, local, global_shape=x.shape)

    def shard_batch(b: EdgeBatchData) -> EdgeBatchData:
        return EdgeBatchData(*[put_edges(x) for x in b])

    return ProblemData(
        edges={k: shard_batch(b) for k, b in data.edges.items()},
        fixed={k: jax.device_put(np.asarray(v), repl)
               for k, v in data.fixed.items()},
        offsets={k: jax.device_put(np.asarray(v), repl)
                 for k, v in data.offsets.items()},
        fixed_flat=jax.device_put(np.asarray(data.fixed_flat), repl),
        plans={k: {kk: jax.device_put(np.asarray(vv), repl)
                   for kk, vv in d.items()}
               for k, d in data.plans.items()},
    )
