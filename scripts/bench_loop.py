"""Flagship capture WITH the async loop closer active (VERDICT r4 #7).

bench.py measures the tracker alone; the reference's 30 fps claim covers
all of its threads (Tracking + LocalMapping + LoopClosing,
/root/reference/src/LoopClosing.cc:61-87). This variant runs the SAME
640x480 / 1024-keypoint flagship workload on a loop-bearing closed-circuit
sequence (organic drift via a slowly-varying depth-scale bias, the
test_loop_organic recipe) through the full System facade — once with the
async loop closer ON (detection + consistency dispatched per KF event,
Sim3 verification async, corrections applied at drain time) and once OFF —
and reports the fps delta. Done = the async design costs <5% at capture
time.

Run alone on the card (one process per card): python scripts/bench_loop.py
"""

import sys
import time

import numpy as np

sys.path.insert(0, ".")

N_LAP = 180
N_REVISIT = 30
DEPTH_BIAS_AMP = 0.08
WARMUP = 6


def main():
    from sdslam_tpu.utils import compile_cache

    compile_cache.enable()

    from sdslam_tpu.geometry.camera import CameraModel
    from sdslam_tpu.io.synthetic import SyntheticSequence, circuit_trajectory
    from sdslam_tpu.system import RGBD, SDSlamSystem
    from sdslam_tpu.utils.config import (
        MapConfig, ORBConfig, SystemConfig, TrackingConfig,
    )

    cam = CameraModel(fx=525.0, fy=525.0, cx=319.5, cy=239.5,
                      width=640, height=480, bf=40.0)
    cfg = SystemConfig(
        camera=cam,
        orb=ORBConfig(max_keypoints=1024, n_levels=5),
        map=MapConfig(max_keyframes=64, max_points=8192,
                      max_kps_per_frame=1024),
        tracking=TrackingConfig(depth_map_factor=1000.0),
    )
    lap = np.asarray(circuit_trajectory(N_LAP, radius=0.6))
    poses = np.concatenate([lap, lap[:N_REVISIT]])
    seq = SyntheticSequence(
        cam, trajectory="custom", poses=poses,
        scene_kwargs={"closed": True, "size": 3.5},
    )
    n = len(seq)
    print(f"rendering {n} frames at 640x480 (off the clock)...", flush=True)
    frames = []
    for i in range(n):
        ts, img, depth = seq.frame(i)
        # organic drift: depth-scale bias sweeping +-8% over the lap
        bias = 1.0 + DEPTH_BIAS_AMP * np.sin(2 * np.pi * i / N_LAP)
        frames.append((
            ts,
            np.asarray(img).astype(np.uint8),
            (np.asarray(depth) * bias * 1000).astype(np.uint16),
        ))

    def run(loop_on: bool, timed: bool, detect_only: bool = False):
        sysm = SDSlamSystem(cfg, sensor=RGBD, loop_closing=loop_on)
        counts = {"kf_detect": 0, "corrections": 0}
        if detect_only:
            # isolate the per-KF async detection dispatch cost: the
            # consistency chain can never fire, so no Sim3/corrections
            sysm.loop_closer.consistency_th = 10 ** 9
        if loop_on:
            orig_dispatch = sysm.loop_closer.dispatch_keyframe
            orig_apply = sysm.loop_closer._apply_correction

            def spy_dispatch(ms, slot):
                counts["kf_detect"] += 1
                return orig_dispatch(ms, slot)

            def spy_apply(*a, **kw):
                counts["corrections"] += 1
                return orig_apply(*a, **kw)

            sysm.loop_closer.dispatch_keyframe = spy_dispatch
            sysm.loop_closer._apply_correction = spy_apply
        for i in range(WARMUP):
            ts, img, dep = frames[i]
            sysm.track_rgbd(img, dep, ts)
        t0 = time.perf_counter()
        for i in range(WARMUP, n):
            ts, img, dep = frames[i]
            sysm.track_rgbd(img, dep, ts)
        sysm.finish()
        dt = time.perf_counter() - t0
        sysm.shutdown()
        return (n - WARMUP) / dt, (counts if loop_on else {})

    # rehearsal: compile everything off the clock (all closer states)
    print("rehearsal (compiles off the clock)...", flush=True)
    run(True, timed=False)
    run(False, timed=False)

    modes = (("off", False, False), ("detect", True, True),
             ("full", True, False))
    results = {}
    for rep in range(2):  # interleaved: regime-fair
        for name, loop_on, det_only in modes:
            fps, stats = run(loop_on, timed=True, detect_only=det_only)
            results.setdefault(name, []).append(fps)
            print(f"loop_closing={name:6s}: {fps:6.1f} fps"
                  + (f"  {stats}" if stats else ""), flush=True)
    f_off = max(results["off"])
    f_det = max(results["detect"])
    f_full = max(results["full"])
    print(f"\nbest: OFF {f_off:.1f} | DETECT-ONLY {f_det:.1f} "
          f"(async dispatch cost {(1 - f_det / f_off) * 100:+.1f}%) | "
          f"FULL {f_full:.1f} ({(1 - f_full / f_off) * 100:+.1f}% incl. "
          f"actual corrections)")


if __name__ == "__main__":
    main()
