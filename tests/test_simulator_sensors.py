"""Simulator sensor suite — measurement-model consistency, round-trip,
and optimization for every sensor kind (reference
``apps/g2o_simulator/sensor_*``).

Each sensor must satisfy:
(a) zero-noise graph → chi2 == 0 at the generated estimates (the generator
    and the registered residual implement the SAME measurement model);
(b) the noisy graph optimizes (chi2 drops substantially);
(c) `.g2o` save/load round-trip preserves chi2.
"""

import io

import numpy as np
import pytest

import g2o_tpu
import g2o_tpu.types  # noqa: F401
from g2o_tpu.core.lm_fused import optimize_fused
from g2o_tpu.core.solvers import PCGSolver
from g2o_tpu.io import g2o_format
from g2o_tpu.sim.generators import create_simulator2d, create_simulator3d

SENSORS_2D = ["pose", "pointxy", "bearing", "pointxy_offset", "segment",
              "segment_line", "segment_pointline", "line2d"]
SENSORS_3D = ["pose", "pose_offset", "se3prior", "trackxyz", "depth",
              "disparity", "line3d", "plane"]


def _chi2(g):
    p = g.compile()
    chi, _ = p.chi2_jit(p.data, p.estimates)
    return float(chi), p


def _make(dim, sensor, noise):
    if dim == 2:
        return create_simulator2d(
            n_poses=40, n_landmarks=25, sensors=("odometry", sensor),
            n_segments=10, n_lines=8, noise_scale=noise, seed=7)
    return create_simulator3d(
        n_poses=30, n_landmarks=40, sensors=("odometry", sensor),
        n_lines=8, n_planes=6, noise_scale=noise, seed=7)


@pytest.mark.parametrize("sensor", SENSORS_2D)
def test_sensor2d_zero_noise_chi2_zero(sensor):
    chi, p = _chi2(_make(2, sensor, 0.0))
    assert p.num_edges > 40, "sensor produced no observations"
    assert chi == pytest.approx(0.0, abs=1e-12)


@pytest.mark.parametrize("sensor", SENSORS_3D)
def test_sensor3d_zero_noise_chi2_zero(sensor):
    chi, p = _chi2(_make(3, sensor, 0.0))
    assert p.num_edges > 30, "sensor produced no observations"
    assert chi == pytest.approx(0.0, abs=1e-10)


@pytest.mark.parametrize("dim,sensor", [(2, s) for s in SENSORS_2D]
                         + [(3, s) for s in SENSORS_3D])
def test_sensor_roundtrip_and_optimize(dim, sensor):
    g = _make(dim, sensor, 1.0)
    chi0, p0 = _chi2(g)
    # round-trip preserves chi2
    buf = io.StringIO()
    g2o_format.save(g, buf)
    g2 = g2o_format.loads(buf.getvalue())
    chi1, _ = _chi2(g2)
    assert chi1 == pytest.approx(chi0, rel=1e-6)
    # optimization makes real progress (graph is well-posed)
    res = optimize_fused(p0, PCGSolver(max_iter=150, tol=1e-8), 15)
    assert res["chi2_final"] < 0.7 * chi0
    assert np.isfinite(res["chi2_final"])
