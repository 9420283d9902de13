"""Distributed Schur: landmark/observation-sharded solve on the 8-device
CPU mesh must match the single-device solve exactly."""

import jax
import numpy as np
import pytest

from g2o_tpu.core.lm_fused import optimize_fused
from g2o_tpu.core.solvers import SchurSolver
from g2o_tpu.parallel import make_mesh, replicate_estimates, shard_problem_data
from g2o_tpu.sim.generators import create_ba_scene


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_schur_matches_single():
    n_dev = 8
    g, _ = create_ba_scene(n_cameras=10, n_points=150, pixel_noise=0.5,
                           point_noise=0.3, seed=21)
    p1 = g.compile()
    p2 = g.compile(pad_edges_to_multiple=n_dev)

    s1 = SchurSolver().setup(p1)
    lin1 = p1.linearize_jit(p1.data, p1.estimates)
    dx1 = np.asarray(s1.solve(p1.data, lin1, 1e-3))

    mesh = make_mesh(n_dev)
    data_sh = shard_problem_data(p2.data, mesh)
    est_sh = replicate_estimates(p2.estimates, mesh)
    s2 = SchurSolver(mesh=mesh).setup(p2)
    lin2 = p2.linearize_jit(data_sh, est_sh)
    dx2 = np.asarray(s2.solve(data_sh, lin2, 1e-3))

    assert dx1.shape == dx2.shape
    np.testing.assert_allclose(dx1, dx2, atol=1e-9)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_schur_full_lm():
    n_dev = 8
    g, truth = create_ba_scene(n_cameras=10, n_points=150, pixel_noise=0.0,
                               point_noise=0.3, seed=22)
    p = g.compile(pad_edges_to_multiple=n_dev)
    mesh = make_mesh(n_dev)
    p.data = shard_problem_data(p.data, mesh)
    p.estimates = replicate_estimates(p.estimates, mesh)
    res = optimize_fused(p, SchurSolver(mesh=mesh), 10)
    assert res["chi2_final"] < 1e-6 * max(res["chi2_per_iteration"][0], 1.0)


def test_sharded_implicit_schur_matches_unsharded():
    """The matrix-free Schur CG consumes only data.edges + lin, so GSPMD
    edge-sharding must reproduce the single-device step exactly (the
    distributed analogue of the reference's OpenMP Schur loop,
    ``block_solver.hpp:339-393``)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from g2o_tpu.core.solvers.schur_implicit import ImplicitSchurSolver
    from g2o_tpu.parallel import (make_fused_step, make_mesh,
                                  replicate_estimates, shard_problem_data)
    from g2o_tpu.sim.generators import create_ba_scene

    n_dev = len(jax.devices())
    g, _ = create_ba_scene(n_cameras=6, n_points=80, pixel_noise=0.5,
                           point_noise=0.2, seed=3)
    p = g.compile(pad_edges_to_multiple=n_dev)
    solver = ImplicitSchurSolver(max_iter=30, tol=1e-10).setup(p)
    step = make_fused_step(p, solver, donate=False)
    e0, c0, _ = step(p.data, p.estimates, jnp.asarray(1e-3, p.dtype))
    mesh = make_mesh(n_dev)
    data = shard_problem_data(p.data, mesh)
    est = replicate_estimates(p.estimates, mesh)
    e1, c1, _ = step(data, est, jnp.asarray(1e-3, p.dtype))
    np.testing.assert_allclose(float(c0), float(c1), rtol=1e-12)
    for t in e0:
        np.testing.assert_allclose(np.asarray(e0[t]), np.asarray(e1[t]),
                                    rtol=1e-9, atol=1e-11)


def test_sharded_bucketed_implicit_schur_matches_unsharded():
    """The compile-time bucketed layout (slab reductions + one-hot
    matmuls) must also survive GSPMD edge-sharding: dense per-slab
    reductions shard along the slab axis, one-hot matmuls reduce the
    sharded contraction dimension with a psum."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from g2o_tpu.core.solvers.schur_implicit import ImplicitSchurSolver
    from g2o_tpu.parallel import (make_fused_step, make_mesh,
                                  replicate_estimates, shard_problem_data)
    from g2o_tpu.sim.generators import create_ba_scene

    n_dev = len(jax.devices())
    g, _ = create_ba_scene(n_cameras=6, n_points=80, pixel_noise=0.5,
                           point_noise=0.2, seed=3)
    p = g.compile(bucket_landmarks=True, pad_edges_to_multiple=n_dev)
    solver = ImplicitSchurSolver(max_iter=30, tol=1e-10).setup(p)
    assert p.bucket_specs  # auto layout rides the compile-time plan
    step = make_fused_step(p, solver, donate=False)
    e0, c0, _ = step(p.data, p.estimates, jnp.asarray(1e-3, p.dtype))
    mesh = make_mesh(n_dev)
    data = shard_problem_data(p.data, mesh)
    est = replicate_estimates(p.estimates, mesh)
    e1, c1, _ = step(data, est, jnp.asarray(1e-3, p.dtype))
    np.testing.assert_allclose(float(c0), float(c1), rtol=1e-12)
    for t in e0:
        np.testing.assert_allclose(np.asarray(e0[t]), np.asarray(e1[t]),
                                   rtol=1e-8, atol=1e-10)


def test_multihost_helpers_single_process():
    """Multi-host helpers degrade gracefully to single-process: global mesh
    over all local devices, edge spec covering every axis, sharded step
    matching the single-device result."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from g2o_tpu.core.solvers import PCGSolver
    from g2o_tpu.parallel import (edge_partition_spec, initialize_distributed,
                                  make_fused_step, make_global_mesh,
                                  replicate_estimates,
                                  shard_problem_data_global)
    from g2o_tpu.sim.generators import create_manhattan

    initialize_distributed()          # no-op single-process
    mesh = make_global_mesh()
    n_dev = mesh.devices.size
    assert n_dev == len(jax.devices())
    g = create_manhattan(n_poses=64, seed=21)
    p = g.compile(pad_edges_to_multiple=n_dev)
    solver = PCGSolver(max_iter=30, tol=1e-10).setup(p)
    step = make_fused_step(p, solver, donate=False)
    e0, c0, _ = step(p.data, p.estimates, jnp.asarray(1e-4, p.dtype))
    data = shard_problem_data_global(p.data, mesh)
    est = replicate_estimates(p.estimates, mesh)
    e1, c1, _ = step(data, est, jnp.asarray(1e-4, p.dtype))
    np.testing.assert_allclose(float(c0), float(c1), rtol=1e-12)
    for t in e0:
        np.testing.assert_allclose(np.asarray(e0[t]), np.asarray(e1[t]),
                                    rtol=1e-9, atol=1e-11)
    assert edge_partition_spec(mesh) is not None


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_chunk2_pcg_matches_single():
    """The headline manhattan config (two-level Schwarz ``chunk2``
    preconditioner, host-built chunk/intra/coarse index maps) under GSPMD
    edge-sharding must match the single-device solve exactly — the chunk
    preconditioner build consumes sharded ``lin.jacs``/``lin.weights``
    through one-hot reductions whose partial sums GSPMD completes with
    collectives."""
    from g2o_tpu.core.solvers import PCGSolver
    from g2o_tpu.sim.generators import create_manhattan

    n_dev = 8
    g = create_manhattan(n_poses=120, seed=3)
    p1 = g.compile()
    p2 = g.compile(pad_edges_to_multiple=n_dev)

    s1 = PCGSolver(max_iter=25, tol=1e-10, precond="chunk2",
                   chunk_size=8).setup(p1)
    lin1 = p1.linearize_jit(p1.data, p1.estimates)
    dx1 = np.asarray(s1.solve(p1.data, lin1, 1e-3))

    mesh = make_mesh(n_dev)
    data_sh = shard_problem_data(p2.data, mesh)
    est_sh = replicate_estimates(p2.estimates, mesh)
    s2 = PCGSolver(max_iter=25, tol=1e-10, precond="chunk2",
                   chunk_size=8).setup(p2)
    lin2 = p2.linearize_jit(data_sh, est_sh)
    dx2 = np.asarray(s2.solve(data_sh, lin2, 1e-3))

    assert dx1.shape == dx2.shape
    np.testing.assert_allclose(dx1, dx2, atol=1e-9)


def test_initialize_distributed_raises_with_explicit_coordinator():
    """A misconfigured launch must not degrade silently to one process:
    with an explicit coordinator the error is raised (here: the backend is
    already up, so JAX refuses to start the distributed runtime)."""
    import pytest

    import jax

    from g2o_tpu.parallel import initialize_distributed

    jax.devices()
    with pytest.raises(RuntimeError):
        initialize_distributed(coordinator_address="localhost:1",
                               num_processes=2, process_id=0)
