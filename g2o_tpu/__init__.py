"""g2o_tpu — a JAX graph-optimization framework.

A from-scratch JAX/XLA reimagining of sparse nonlinear least-squares on
hyper-graphs (SLAM pose graphs, bundle adjustment) with the capabilities of
the reference C++ framework surveyed in ``SURVEY.md``:

* typed manifold vertices (SE2, SE3, Sim3, points, cameras) and error edges
  with robust kernels,
* Gauss-Newton / Levenberg-Marquardt / Dogleg iterations,
* Schur-complement marginalisation of landmarks,
* dense / block-Jacobi-PCG / square-root-CGLS linear solvers,
* ``.g2o`` text-format IO and dataset simulators,

re-designed array-first: the graph compiles to a structure-of-arrays problem
spec, residuals and Jacobians are vmapped + jacfwd'ed per edge type, H/b
assembly is segment-sum, and multi-chip scaling shards edges and landmark
blocks over a ``jax.sharding.Mesh``.
"""

from g2o_tpu.core.graph import Graph
from g2o_tpu.core.optimizer import (
    GaussNewton,
    LevenbergMarquardt,
    Dogleg,
    SparseOptimizer,
)
from g2o_tpu.core.lm_fused import (
    FusedLevenbergMarquardt,
    optimize_fused,
    optimize_fused_gn,
)
from g2o_tpu.core.solvers import DenseSolver, PCGSolver, SchurSolver
from g2o_tpu.core.solvers.cgls import CGLSSolver
from g2o_tpu.core.solvers.sparse_chol import SparseCholeskySolver
from g2o_tpu.core.solvers.supernodal import SupernodalCholeskySolver

__version__ = "0.1.0"

__all__ = [
    "Graph",
    "GaussNewton",
    "LevenbergMarquardt",
    "FusedLevenbergMarquardt",
    "Dogleg",
    "SparseOptimizer",
    "optimize_fused",
    "optimize_fused_gn",
    "DenseSolver",
    "PCGSolver",
    "SchurSolver",
    "CGLSSolver",
    "SparseCholeskySolver",
    "SupernodalCholeskySolver",
]
