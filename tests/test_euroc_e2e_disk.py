"""End-to-end EuRoC dataset-path regression that runs EVERYWHERE:

render a synthetic sequence, write it in the exact EuRoC MAV layout
(mav0/cam0/data.csv + nanosecond-stamp PNGs, mav0/imu0/data.csv with
gyro+accel rows), then drive the REAL production stack — `cli.py fusion` +
EuRoC-style YAML + EuRoCDataset (CSV parse, ns timestamps, PNG decode, IMU
association) — in a subprocess, and gate Sim3-aligned ATE against the
renderer's ground truth (monocular scale is free).

A real EuRoC sequence activates tests/test_euroc_regression.py unchanged;
this proves the identical code path on the identical format.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

pytestmark = pytest.mark.heavy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

YAML = """%YAML:1.0

Camera.fx: 320.0
Camera.fy: 320.0
Camera.cx: 159.5
Camera.cy: 119.5
Camera.Width: 320
Camera.Height: 240
Camera.fps: 30.0
ORBextractor.nFeatures: 512
ORBextractor.scaleFactor: 2.0
ORBextractor.nLevels: 4
ORBextractor.thresholdFAST: 20
Map.MaxKeyframes: 32
Map.MaxPoints: 4096
"""


def test_cli_fusion_on_disk_euroc_sequence(tmp_path):
    import jax.numpy as jnp

    from sdslam_tpu.geometry import lie
    from sdslam_tpu.geometry.camera import CameraModel
    from sdslam_tpu.io.datasets import EuRoCDataset, write_euroc_sequence
    from sdslam_tpu.io.synthetic import SyntheticSequence
    from sdslam_tpu.utils.metrics import ate_rmse

    cam = CameraModel(fx=320.0, fy=320.0, cx=159.5, cy=119.5,
                      width=320, height=240)
    n = 40
    fps = 30.0
    t0 = 1700000000.0  # unix-epoch-scale stamps (the f32-precision trap)
    seq = SyntheticSequence(cam, n_frames=n, trajectory="orbit",
                            radius=0.12, yaw_amp=0.03)

    # gyro (body rates) + accel (gravity in body frame) from GT poses, at
    # 200 Hz like the real imu0 stream (several rows between frames)
    g_world = np.array([0.0, -9.81, 0.0])
    imu_rows = []
    for i in range(n):
        j = max(i - 1, 0)
        Ti = np.asarray(seq.poses[i])
        rel = Ti @ np.linalg.inv(np.asarray(seq.poses[j]))
        w = np.asarray(
            lie.so3_log(jnp.asarray(rel[:3, :3].astype(np.float32)))) * fps
        a = Ti[:3, :3] @ (-g_world)
        for k in range(6):  # ~200 Hz
            imu_rows.append(
                (t0 + i / fps + k / (6 * fps), list(w) + list(a)))

    root = tmp_path / "euroc_synthetic"
    write_euroc_sequence(
        str(root),
        ((t0 + i / fps, np.asarray(seq.frame(i)[1])) for i in range(n)),
        imu_rows=imu_rows,
    )

    # loader round-trip sanity on the written layout
    ds = EuRoCDataset(str(root))
    assert len(ds) == n
    ts0, img0 = ds.frame(0)
    assert abs(ts0 - t0) < 1e-6 and img0.shape == (240, 320)
    assert len(ds.imu_between(t0, t0 + 1 / fps)) == 6

    cfg_path = tmp_path / "synthetic_euroc.yaml"
    cfg_path.write_text(YAML)
    traj_out = tmp_path / "trajectory.txt"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    # the subprocess keeps its compile cache in the checkout (.jax_cache)
    env.pop("SDSLAM_JAX_CACHE", None)
    proc = subprocess.run(
        [sys.executable, "-m", "sdslam_tpu.cli", "fusion", str(cfg_path),
         str(root), "--traj-out", str(traj_out), "--no-loop-closing"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=3000,
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "state=OK" in proc.stdout
    assert traj_out.exists()

    # Sim3-aligned ATE against the renderer's ground truth
    est = {}
    with open(traj_out) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            v = [float(x) for x in line.split()]
            est[round(v[0] - t0, 4)] = v[1:]

    def to_Tcw(v):
        tx, ty, tz, qx, qy, qz, qw = v
        Twc = np.eye(4)
        Twc[:3, :3] = np.asarray(
            lie.quat_to_mat(jnp.asarray([qw, qx, qy, qz], jnp.float32)))
        Twc[:3, 3] = [tx, ty, tz]
        return np.linalg.inv(Twc)

    keys = sorted(est)
    assert len(keys) >= n - 2, (len(keys), n)
    idx = [int(round(t * fps)) for t in keys]
    ate = ate_rmse(
        np.stack([to_Tcw(est[t]) for t in keys]),
        np.stack([np.asarray(seq.poses[i]) for i in idx]),
        align=True, with_scale=True,
    )
    print(f"disk EuRoC e2e: ATE={ate*100:.2f}cm over {len(keys)} frames")
    assert ate < 0.06, f"Sim3-aligned ATE RMSE {ate*100:.2f} cm"
