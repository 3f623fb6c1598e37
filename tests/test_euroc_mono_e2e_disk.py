"""Mono-EuRoC disk CLI e2e (VERDICT r4 #6 / BASELINE config 3): render a
synthetic sequence, write it in the EuRoC ASL layout (mav0/cam0/data.csv +
ns-stamped PNGs), then drive the REAL production entry point —
`cli.py monocular`, which auto-detects the ASL layout — in a subprocess:
two-view H/F mono bootstrap, direct ImageAlign tracking, a mid-sequence
KIDNAP (sensor blackout + reappearance at a previously-mapped viewpoint
under a 30-degree in-plane roll), and recovery through the relocalization
chain whose geometric fallback is EPnP (photometric alignment has no basin
for a large roll; ORB descriptors are rotation-invariant —
tests/test_relocalization.py::test_epnp_recovers_when_alignment_fails
proves the same roll is EPnP-only at the unit level).

Reference workload: /root/reference/Examples/Monocular/EuRoC.yaml +
monocular.cc:52-196 (monocular ASL, no IMU). Monocular scale is free, so
gates are Sim3-aligned.
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
Camera.fps: 20.0
ORBextractor.nFeatures: 512
ORBextractor.scaleFactor: 2.0
ORBextractor.nLevels: 4
ORBextractor.thresholdFAST: 20
Map.MaxKeyframes: 32
Map.MaxPoints: 4096
"""


def test_cli_monocular_euroc_kidnap_reloc(tmp_path):
    import jax.numpy as jnp

    from sdslam_tpu.geometry import lie
    from sdslam_tpu.geometry.camera import CameraModel
    from sdslam_tpu.io import synthetic as S
    from sdslam_tpu.io.datasets import write_euroc_sequence
    from sdslam_tpu.utils.metrics import ate_rmse

    cam = CameraModel(fx=320.0, fy=320.0, cx=159.5, cy=119.5,
                      width=320, height=240)
    n1, n_black, n2 = 28, 2, 12
    # lateral sweep for mono-init parallax (same regime as the TUM mono e2e)
    seq = S.SyntheticSequence(cam, n_frames=n1, trajectory="orbit",
                              radius=0.12, yaw_amp=0.03)
    roll = np.deg2rad(30.0)
    Rz = np.array(
        [[np.cos(roll), -np.sin(roll), 0, 0],
         [np.sin(roll), np.cos(roll), 0, 0],
         [0, 0, 1, 0], [0, 0, 0, 1]], np.float32,
    )
    # segment 2: rolled revisit of the mapped orbit (frames 8..8+n2)
    seg2_poses = [Rz @ np.asarray(seq.poses[8 + i]) for i in range(n2)]

    t0 = 1.4e9  # ns-scale unix stamps, like real EuRoC
    frames = []
    gt = {}  # timestamp -> Tcw (known segments only)
    for i in range(n1):
        ts = t0 + i / 20.0
        _, img, _ = seq.frame(i)
        frames.append((ts, np.asarray(img)))
        gt[round(ts, 4)] = np.asarray(seq.poses[i])
    for b in range(n_black):
        ts = t0 + (n1 + b) / 20.0
        frames.append((ts, np.zeros((240, 320), np.uint8)))
    for i in range(n2):
        ts = t0 + (n1 + n_black + i) / 20.0
        img, _ = S.render(seq.scene, cam, jnp.asarray(seg2_poses[i]))
        frames.append((ts, np.asarray(img)))
        gt[round(ts, 4)] = seg2_poses[i]

    root = tmp_path / "euroc_mono_synthetic"
    write_euroc_sequence(str(root), frames)

    cfg_path = tmp_path / "euroc_mono.yaml"
    cfg_path.write_text(YAML)
    traj_out = tmp_path / "trajectory.txt"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    # the subprocess keeps its compile cache in the checkout (.jax_cache)
    env.pop("SDSLAM_JAX_CACHE", None)
    proc = subprocess.run(
        [sys.executable, "-m", "sdslam_tpu.cli", "monocular", str(cfg_path),
         str(root), "--traj-out", str(traj_out), "--no-loop-closing"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=3000,
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "state=OK" in proc.stdout
    # the LAST status print (frame 40) comes after the kidnap: recovery held
    lines = [ln for ln in proc.stdout.splitlines() if "state=" in ln]
    assert "state=OK" in lines[-1], lines

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
            lie.quat_to_mat(jnp.asarray([qw, qx, qy, qz], jnp.float32)))
        Twc[:3, 3] = [tx, ty, tz]
        return np.linalg.inv(Twc)

    est = read_traj(traj_out)
    common = sorted(set(est) & set(gt))
    assert len(common) >= n1 + n2 - 8, (len(common), n1 + n2)
    # one Sim3 (scale free in mono) aligned over ALL tracked frames: the
    # post-kidnap segment can only fit if relocalization recovered the
    # rolled pose in the ORIGINAL map frame
    ate = ate_rmse(
        np.stack([to_Tcw(est[t]) for t in common]),
        np.stack([gt[t] for t in common]),
        align=True, with_scale=True,
    )
    seg2_ts = [t for t in common if t >= round(t0 + (n1 + n_black) / 20.0, 4)]
    seg1_ts = [t for t in common if t not in set(seg2_ts)]
    assert len(seg2_ts) >= n2 - 3, (len(seg2_ts), n2)
    ate1 = ate_rmse(
        np.stack([to_Tcw(est[t]) for t in seg1_ts]),
        np.stack([gt[t] for t in seg1_ts]), align=True, with_scale=True)
    ate2 = ate_rmse(
        np.stack([to_Tcw(est[t]) for t in seg2_ts]),
        np.stack([gt[t] for t in seg2_ts]), align=True, with_scale=True)
    print(f"euroc mono kidnap e2e: Sim3 ATE={ate*100:.2f}cm over "
          f"{len(common)} frames (seg1 {ate1*100:.2f}, "
          f"post-reloc seg2 {ate2*100:.2f} over {len(seg2_ts)})")
    # each segment tracks tightly; the combined one-Sim3 gate is looser —
    # a kidnap + 30-deg-rolled EPnP relocalization re-enters the map with
    # a few cm of seam error by construction (the reference accepts reloc
    # at >= 10 pose-GN inliers, Tracking.cc:1088-1093 — not zero error)
    # (a FAILED reloc parks the trajectory at the last known pose while
    # LOST — tens of cm; measured passing run: 4.6 / 5.7 / 8.4 cm)
    assert ate1 < 0.05, f"seg1 Sim3 ATE {ate1*100:.2f} cm"
    assert ate2 < 0.08, f"post-reloc Sim3 ATE {ate2*100:.2f} cm"
    assert ate < 0.12, f"combined Sim3 ATE {ate*100:.2f} cm"
