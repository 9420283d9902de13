"""BAL bundle adjustment — analogue of the reference
``examples/bal/bal_example.cpp``: read a BAL dataset (9-dof Rodrigues
cameras with radial distortion — where the reference uses ceres autodiff
``bal_example.cpp:65-285``, here ``jax.jacfwd`` differentiates the same
model exactly), optimize with LM, write the point cloud.

Run: python examples/bal_example.py [problem.txt] [iterations]
A synthetic Ladybug-like problem is generated when no file is given.
"""

import io
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    path = sys.argv[1] if len(sys.argv) > 1 else None
    iters = int(sys.argv[2]) if len(sys.argv) > 2 else 20

    from g2o_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()

    from g2o_tpu.core.lm_fused import optimize_fused
    from g2o_tpu.core.solvers import SchurSolver
    from g2o_tpu.io.bal import load_bal_problem, make_synthetic_bal

    if path is None:
        print("no input file: generating a synthetic Ladybug-like problem")
        src = io.StringIO(make_synthetic_bal(n_cameras=49, n_points=2000,
                                             n_obs_per_point=6))
    else:
        src = path
    p = load_bal_problem(src, huber=1.0)
    n_cams = p.counts["VERTEX_CAMERA_BAL"]
    n_pts = p.counts["VERTEX_TRACKXYZ"]
    print(f"loaded: {n_cams} cameras, {n_pts} points")

    res = optimize_fused(p, SchurSolver(), iters)
    chis = res["chi2_per_iteration"]
    print(f"chi2 {chis[0]:.1f} -> {res['chi2_final']:.2f} "
          f"in {res['iterations']} LM iterations ({res['wall_s']:.2f}s)")

    # write the optimized point cloud like the reference's PLY dump
    # (``bal_example.cpp`` WriteToPLYFile)
    out = (path or "synthetic_bal") + ".ply"
    import numpy as np
    pts = np.asarray(p.estimates["VERTEX_TRACKXYZ"])
    with open(out, "w") as fh:
        fh.write("ply\nformat ascii 1.0\n"
                 f"element vertex {len(pts)}\n"
                 "property float x\nproperty float y\nproperty float z\n"
                 "end_header\n")
        for q in pts:
            fh.write(f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f}\n")
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
