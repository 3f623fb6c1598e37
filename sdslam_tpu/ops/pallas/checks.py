"""Each hand-written kernel against the plain XLA path, at the tracker's
widths (configs/TUM1.yaml intrinsics; pose solves over 1024 keypoints).

Used by chip_smoke.py (phase 2) and scripts/card_ab.py on the card; the
same problems run in interpret mode in tests/test_pallas_kernels.py. Each
check returns the largest disagreement, its tolerance with the reason, and
the median time of both versions.
"""

from __future__ import annotations

import statistics
import time

import jax
import jax.numpy as jnp
import numpy as np

from sdslam_tpu.geometry import lie
from sdslam_tpu.geometry.camera import CameraModel

# configs/TUM1.yaml intrinsics
FX, FY, CX, CY, BF = 517.306408, 516.469215, 318.643040, 255.313989, 40.0


def median_us(fn, *args, reps=30, warm=3):
    for _ in range(warm):
        jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts) * 1e6


def pose_problem(rng, N=1024, n_outlier=40, stereo_frac=0.5,
                 cam=(FX, FY, CX, CY, BF)):
    """Reprojection edges of a known pose with noise, gross outliers, mixed
    mono/stereo edges and per-octave information; returns
    (cam tuple, X, uv, ur, isig, valid, T_true)."""
    fx, fy, cx, cy, bf = cam
    X = rng.uniform([-1.5, -1.0, 2.0], [1.5, 1.0, 6.0], (N, 3)).astype(np.float32)
    T_true = np.asarray(lie.se3_exp(jnp.asarray(
        [0.05, -0.03, 0.08, 0.02, -0.015, 0.01], jnp.float32)))
    Xc = X @ T_true[:3, :3].T + T_true[:3, 3]
    u = fx * Xc[:, 0] / Xc[:, 2] + cx
    v = fy * Xc[:, 1] / Xc[:, 2] + cy
    uv = np.stack([u, v], -1) + rng.normal(0, 0.4, (N, 2))
    ur = u - bf / Xc[:, 2] + rng.normal(0, 0.4, N)
    ur = np.where(rng.uniform(size=N) < stereo_frac, ur, -1.0)
    out_idx = rng.choice(N, n_outlier, replace=False)
    uv[out_idx] += rng.normal(0, 30.0, (n_outlier, 2))
    oct_ = rng.integers(0, 4, N)
    isig = (1.0 / 2.0 ** (2.0 * oct_)).astype(np.float32)
    valid = rng.uniform(size=N) > 0.1
    return (cam, X, uv.astype(np.float32), ur.astype(np.float32), isig,
            valid, T_true)


def pose_check(n_edges: int = 1024):
    """Pose solve at the tracker's edge count and default schedule, with the
    alignment prior: kernel vs optimize_pose's XLA loop."""
    from sdslam_tpu.solvers import pose_opt

    rng = np.random.default_rng(11)
    (fx, fy, cx, cy, bf), X, uv, ur, isig, valid, _ = pose_problem(
        rng, N=n_edges)
    cam = CameraModel(fx=fx, fy=fy, cx=cx, cy=cy, width=640, height=480,
                      bf=bf)
    T0 = jnp.asarray(np.asarray(lie.se3_exp(jnp.asarray(
        [0.04, -0.02, 0.07, 0.015, -0.012, 0.008], jnp.float32))))
    args = [jnp.asarray(a) for a in (X, uv, isig, valid, ur)]
    xla = jax.jit(lambda T, X, uv, isig, valid, ur: pose_opt._optimize_pose_xla(
        cam, T, X, uv, isig, valid, ur, 4, 10, T, 100.0, 4.0).Tcw)
    kern = jax.jit(lambda T, X, uv, isig, valid, ur: pose_opt._optimize_pose_kernel(
        cam, T, X, uv, isig, valid, ur, 4, 10, T, 100.0, 4.0).Tcw)
    a = np.asarray(xla(T0, *args))
    b = np.asarray(kern(T0, *args))
    return {
        "err": float(np.abs(a - b).max()), "tol": 1e-4,
        "why": "float32 both, HIGHEST in XLA; 40 GN steps, Cholesky vs LU "
               "and another summation order",
        "t_kernel_us": median_us(kern, T0, *args),
        "t_xla_us": median_us(xla, T0, *args),
    }


CHECKS = [("pose_solve", pose_check)]
