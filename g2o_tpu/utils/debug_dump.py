"""Failure-diagnostics dump — JAX analogue of the reference's
``writeDebug`` (``g2o/core/solver.h:128-131``; csparse failure branch
``g2o/solvers/csparse/linear_solver_csparse.h:128-132`` writes the Hessian
as an Octave-loadable text file when a Cholesky factorization fails).

Our solvers never "fail a factorization" in-band (damped iterative solves
always return something); the observable failure is a non-finite candidate
chi2 or an LM step that exhausts all trials.  At that point we dump the
offending *linearized system* — per-type Hessian diagonal blocks, the
gradient b, lambda, iteration and chi2 — to a compressed ``.npz`` that a
user can load with ``numpy.load`` to post-mortem conditioning problems.
"""

from __future__ import annotations

import os
import sys

import numpy as np


def dump_failed_system(problem, lin, lam, iteration, directory,
                       reason="", chi2=None):
    """Write ``<directory>/g2o_tpu_debug_it<N>.npz`` with the linearized
    system at a failed step.  Returns the written path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"g2o_tpu_debug_it{int(iteration)}.npz")
    payload = {
        "iteration": np.asarray(int(iteration)),
        "lambda": np.asarray(float(lam)),
        "reason": np.asarray(reason),
    }
    if chi2 is not None:
        payload["chi2"] = np.asarray(float(chi2))
    if getattr(lin, "b", None) is not None:
        payload["b"] = np.asarray(lin.b)
    diag = getattr(lin, "diag", None) or {}
    for t, blocks in diag.items():
        payload[f"H_diag_{t}"] = np.asarray(blocks)
    fixed = getattr(getattr(problem, "data", None), "fixed", None) or {}
    for t, f in fixed.items():
        payload[f"fixed_{t}"] = np.asarray(f)
    # flat tangent offsets so users can map b back to vertices
    for t, vt in getattr(problem, "vertex_types", {}).items():
        payload[f"tangent_dim_{t}"] = np.asarray(int(vt.tangent_dim))
    np.savez_compressed(path, **payload)
    print(f"g2o_tpu: step failed ({reason}); wrote debug system to {path}",
          file=sys.stderr)
    return path
