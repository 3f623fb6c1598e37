"""Mono-only disk CLI e2e (VERDICT r3 missing #4): render a synthetic
sequence, write it in the TUM monocular layout (rgb.txt + 8-bit PNGs +
groundtruth.txt), then drive the REAL production entry point —
`cli.py monocular` + reference-style YAML + TUMMonoDataset — in a
subprocess, covering the two-view H/F bootstrap and pure-mono tracking
through the same path a user runs (reference:
/root/reference/Examples/Monocular/monocular.cc:52-196).

Monocular scale is free, so the gate is Sim3-aligned ATE.
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


def test_cli_monocular_on_disk_sequence(tmp_path):
    from sdslam_tpu.geometry.camera import CameraModel
    from sdslam_tpu.io.datasets import write_tum_sequence
    from sdslam_tpu.io.synthetic import SyntheticSequence
    from sdslam_tpu.utils.metrics import ate_rmse

    cam = CameraModel(fx=320.0, fy=320.0, cx=159.5, cy=119.5,
                      width=320, height=240)
    n = 40
    # lateral sweep gives the parallax monocular init needs (test_mono.py)
    seq = SyntheticSequence(cam, n_frames=n, trajectory="orbit",
                            radius=0.12, yaw_amp=0.03)
    root = tmp_path / "mono_dataset_synthetic"
    write_tum_sequence(
        str(root),
        ((1700000000.0 + i / 30.0,) + tuple(np.asarray(a) for a in seq.frame(i)[1:])
         for i in range(n)),
        np.asarray(seq.poses),
    )

    cfg_path = tmp_path / "synthetic_mono.yaml"
    cfg_path.write_text(YAML)
    traj_out = tmp_path / "trajectory.txt"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    # the subprocess keeps its compile cache in the checkout (.jax_cache)
    env.pop("SDSLAM_JAX_CACHE", None)
    proc = subprocess.run(
        # loop closing off for the same reason as the rgbd disk e2e: the
        # detection program is minutes per KF event on a 2-core CPU host
        [sys.executable, "-m", "sdslam_tpu.cli", "monocular", str(cfg_path),
         str(root), "--traj-out", str(traj_out), "--no-loop-closing"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=3000,
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "state=OK" in proc.stdout
    assert traj_out.exists()

    import jax.numpy as jnp

    from sdslam_tpu.geometry import lie

    def read_traj(path):
        rows = {}
        with open(path) as f:
            for line in f:
                if line.startswith("#") or not line.strip():
                    continue
                v = [float(x) for x in line.split()]
                rows[round(v[0], 4)] = v[1:]
        return rows

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
    # mono starts tracking after the two-view bootstrap; expect most frames
    assert len(common) >= n - 6, (len(common), n)
    ate = ate_rmse(
        np.stack([to_Tcw(est[t]) for t in common]),
        np.stack([to_Tcw(gt[t]) for t in common]),
        align=True, with_scale=True,
    )
    print(f"disk mono e2e: Sim3 ATE={ate*100:.2f}cm over {len(common)} frames")
    assert ate < 0.05, f"Sim3-aligned ATE RMSE {ate*100:.2f} cm"
