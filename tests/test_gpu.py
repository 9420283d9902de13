"""Checks that only mean something on the card: the precision XLA's GPU
libraries give the solvers' dense kernels.  Marked ``gpu``; they skip on
any other platform.  Run with ``JAX_PLATFORMS=cuda python -m pytest tests
-m gpu``."""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("sd", [144, 1152])
def test_batched_cholesky_full_f32_on_card(gpu, sd):
    """cuSOLVER's batched Cholesky and triangular solve stay full f32 past
    96 columns (the supernodal fronts reach 144 at sphere2500; the chunk2
    coarse system of a 6-dof graph passes a thousand).  Tolerance: a few
    f32 ulps of the largest entry, as on the CPU."""
    import jax.numpy as jnp

    from g2o_tpu.core.solvers.supernodal import (_chol_batched,
                                                 _solve_lower_batched,
                                                 _solve_upper_batched)

    rng = np.random.default_rng(sd)
    S = 4
    A = rng.standard_normal((S, sd, sd))
    D = A @ A.transpose(0, 2, 1) / sd + np.eye(sd)
    B = rng.standard_normal((S, sd, 3))
    L = _chol_batched(jnp.asarray(D, jnp.float32))
    Lref = np.linalg.cholesky(D)
    tol = 2e-5
    assert np.abs(np.asarray(L, np.float64) - Lref).max() \
        <= tol * np.abs(Lref).max()
    X = _solve_upper_batched(L, _solve_lower_batched(
        L, jnp.asarray(B, jnp.float32)))
    Xref = np.linalg.solve(D, B)
    assert np.abs(np.asarray(X, np.float64) - Xref).max() \
        <= 10 * tol * np.abs(Xref).max()


def test_onehot_highest_is_exact_f32_on_card(gpu):
    """At HIGHEST the one-hot segment sum is exact f32 on the card (no
    TF32 rounding of the values): it matches ``segment_sum`` to f32
    accumulation noise, at a camera count and width of the venice scene."""
    import jax
    import jax.numpy as jnp

    from g2o_tpu.ops.onehot import onehot_scatter_add

    rng = np.random.default_rng(0)
    n, s, d = 200_000, 800, 9
    rows = jnp.asarray(rng.standard_normal((n, d)), jnp.float32)
    idx = jnp.asarray(rng.integers(0, s, n), jnp.int32)
    got = np.asarray(jax.jit(onehot_scatter_add, static_argnums=2)(
        idx, rows, s), np.float64)
    ref = np.zeros((s, d))
    np.add.at(ref, np.asarray(idx), np.asarray(rows, np.float64))
    # ~250 rows per segment: f32 accumulation error ~ sqrt(250)*eps*|row|
    assert np.abs(got - ref).max() <= 1e-4


def test_supernodal_solve_on_card(gpu):
    """A supernodal solve on the card equals the dense solve (f64)."""
    import jax.numpy as jnp

    import g2o_tpu.types  # noqa: F401
    from g2o_tpu.core.solvers import DenseSolver
    from g2o_tpu.core.solvers.supernodal import SupernodalCholeskySolver
    from g2o_tpu.sim.generators import create_sphere

    p = create_sphere(nodes_per_level=20, laps=10, radius=20.0,
                      seed=0).compile(dtype=jnp.float64)
    lin = p.linearize_jit(p.data, p.estimates)
    lam = jnp.asarray(1e-3, p.dtype)
    dx_s = np.asarray(SupernodalCholeskySolver().setup(p).solve(
        p.data, lin, lam))
    dx_d = np.asarray(DenseSolver().setup(p).solve(p.data, lin, lam))
    assert np.linalg.norm(dx_s - dx_d) <= 1e-8 * np.linalg.norm(dx_d)
