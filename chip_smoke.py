"""Smoke test of the SLAM system on one CUDA card.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the multi-device paths

Run from the root of a checkout. One process holds the card for the whole
run (JAX reserves most of a card's memory when it starts, so a second
process on the same card would fail). Phases, one card:

  1. device   — a CUDA device is required; there is no CPU fallback.
  2. kernels  — each hand-written Pallas kernel the program uses, compiled
                for the card at the widths the tracker uses, against the
                plain XLA version of the same computation.
  3. rgbd     — SDSlamSystem.track_rgbd over a synthetic orbit rendered at
                the configs/TUM1.yaml camera, pools and feature budget, with
                loop closing on; and the same sequence through the batched
                upload_batch/track_batch path. ATE/RPE gates as in
                tests/test_odometry.py.
  4. mono     — a short monocular sequence on the same configuration: the
                two-view initializer and triangulation-only map growth.
  5. tests    — the `gpu`-marked tests, in this process.

Phases 3 (both paths) and 4 run side by side in threads: the run is
compile-bound, and XLA compiles outside the GIL, so their compiles overlap.
Their frame rates are therefore informational only; each phase's lines are
printed when all three have ended.

With --four-cards only the multi-device paths run, each against its
one-card result: distributed BA, distributed Sim3 pose graph, distributed
align scan (production shapes), and the pipelined tracker (tracking on
card 0, mapping on card 1) against the one-card tracker. The pipelined
tracker runs first, beside its one-card reference (tracker programs only,
as in the one-card phases); the distributed programs then run one at a
time with nothing else in flight: NCCL's set-up synchronizes each card,
which breaks another thread's CUDA graph capture on it.

Every phase that fails makes the script exit non-zero. The last line of
standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# ATE / RPE gates of the CPU suite (tests/test_odometry.py)
ATE_GATE = 0.02
RPE_GATE = 0.01
RGBD_FRAMES = 150
RGBD_CHUNK = 48  # 6 per-frame warm-up frames + 3 chunks = 150
MONO_FRAMES = 30


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def card_line():
    """Card name and power limit, read by a child process that stays off
    JAX (one JAX process per card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def tum1_config():
    """configs/TUM1.yaml as the user loads it, with the lens distortion
    zeroed: the synthetic renderer is a pinhole camera, so distortion
    coefficients would describe a lens the frames were not taken with."""
    from sdslam_tpu.utils.config import load_config

    cfg = load_config(os.path.join(HERE, "configs", "TUM1.yaml"))
    cam = cfg.camera._replace(k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0)
    return dataclasses.replace(cfg, camera=cam)


def render_frames(cam, n, depth_factor, **traj):
    """(sequence, [(img u8, depth u16, ts)]) rendered from a fixed seed."""
    from sdslam_tpu.io.synthetic import SyntheticSequence

    seq = SyntheticSequence(cam, n_frames=n, trajectory="orbit", seed=0,
                            **traj)
    frames = []
    for k in range(n):
        ts, img, depth = seq.frame(k)
        frames.append((
            np.asarray(img).astype(np.uint8),
            np.round(np.asarray(depth) * depth_factor).astype(np.uint16),
            float(ts),
        ))
    return seq, frames


def side_by_side(phases):
    """Run `phases` (callables taking a `say` function) in threads; print
    each one's lines in order once all have ended; re-raise the first
    failure."""
    outs = [[] for _ in phases]
    errs = [None] * len(phases)

    def go(k):
        try:
            phases[k](outs[k].append)
        except BaseException as e:  # re-raised below, in the main thread
            errs[k] = e

    threads = [threading.Thread(target=go, args=(k,))
               for k in range(len(phases))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for lines in outs:
        for line in lines:
            print(line)
    for e in errs:
        if e is not None:
            raise e


def trajectory_errors(est, gt):
    from sdslam_tpu.utils import metrics

    est = np.stack([np.asarray(p) for p in est])
    ate = metrics.ate_rmse(est, gt, align=False)
    rpe_t, _ = metrics.rpe(est, gt)
    return ate, rpe_t


# -- phases -----------------------------------------------------------------


def phase_device(jax, want_count):
    devs = jax.devices()
    d = devs[0]
    check(d.platform == "gpu",
          f"no CUDA device: JAX found {d.platform} ({d.device_kind})")
    check(len(devs) >= want_count,
          f"needs {want_count} cards, JAX found {len(devs)}")
    card = card_line()
    print(f"device: platform={d.platform} kind={d.device_kind} "
          f"count={len(devs)}")
    print(f"card: {card}")
    print(f"jax {jax.__version__}  XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    return devs, card


def phase_kernels(jax):
    """Each kept hand-written kernel against its plain XLA version."""
    from sdslam_tpu.ops.pallas.checks import CHECKS

    for name, fn in CHECKS:
        r = fn()
        print(
            f"kernel {name}: max|err|={r['err']:.3e} (tol {r['tol']:.0e}, "
            f"{r['why']}); kernel {r['t_kernel_us']:.1f} us, "
            f"xla {r['t_xla_us']:.1f} us"
        )
        check(r["err"] <= r["tol"], f"kernel {name} disagrees with XLA")


def rgbd_sequence():
    cfg = tum1_config()
    seq, frames = render_frames(cfg.camera, RGBD_FRAMES,
                                cfg.tracking.depth_map_factor,
                                radius=0.06, yaw_amp=0.04)
    return cfg, frames, np.asarray(seq.poses)


def phase_rgbd(say, card, cfg, frames, gt):
    """Per-frame SDSlamSystem.track_rgbd, loop closing on."""
    from sdslam_tpu.system import RGBD, SDSlamSystem

    cam = cfg.camera
    say(
        f"rgbd config: TUM1.yaml {cam.width}x{cam.height}, "
        f"{cfg.orb.n_features} features / {cfg.orb.max_keypoints} capacity, "
        f"{cfg.orb.n_levels} levels, K={cfg.map.max_keyframes} "
        f"P={cfg.map.max_points}, distortion zeroed (pinhole renderer)"
    )
    slam = SDSlamSystem(cfg, sensor=RGBD, loop_closing=True)
    n_warm = 3
    t0 = time.perf_counter()
    for img, dep, ts in frames[:n_warm]:
        slam.track_rgbd(img, dep, ts)
    slam.tracker.flush()
    t_compile = time.perf_counter() - t0
    t1 = time.perf_counter()
    for img, dep, ts in frames[n_warm:]:
        slam.track_rgbd(img, dep, ts)
    slam.finish()  # every pose drained to the host
    t_run = time.perf_counter() - t1
    fps = (len(frames) - n_warm) / t_run
    n_kf = int(slam.tracker.ms.n_keyframes())
    ate, rpe_t = trajectory_errors(slam.tracker.trajectory, gt)
    say(f"rgbd track_rgbd: {len(frames)} frames, first {n_warm} frames "
        f"(compile) {t_compile:.1f} s, then {fps:.2f} frames/s on {card} "
        f"(informational: includes later compiles, beside other phases)")
    say(f"rgbd track_rgbd: keyframes={n_kf} status="
        f"{slam.tracker.st.status} ATE={ate * 100:.3f} cm "
        f"(gate {ATE_GATE * 100:.0f}) RPE_t={rpe_t * 100:.3f} cm "
        f"(gate {RPE_GATE * 100:.0f})")
    check(slam.tracker.st.status == "OK", "RGB-D tracking lost")
    check(n_kf >= 4, f"only {n_kf} keyframes: no keyframe passes ran")
    check(ate < ATE_GATE and rpe_t < RPE_GATE, "RGB-D accuracy gate")


def phase_batch(say, cfg, frames, gt):
    """Batched ingestion (the benchmark's path): per-frame warm-up, then
    chunks whose upload is in flight while the previous chunk runs."""
    from sdslam_tpu.pipeline.tracking import RGBDTracker

    tr = RGBDTracker(cfg)
    warm = len(frames) % RGBD_CHUNK
    t0 = time.perf_counter()
    for img, dep, ts in frames[:warm]:
        tr.track(img, dep, ts)
    chunks = [frames[k:k + RGBD_CHUNK]
              for k in range(warm, len(frames), RGBD_CHUNK)]
    up = tr.upload_batch(chunks[0])
    for k, ch in enumerate(chunks):
        nxt = tr.upload_batch(chunks[k + 1]) if k + 1 < len(chunks) else None
        tr.track_batch(ch, uploaded=up)
        up = nxt
    tr.flush()
    t_batch = time.perf_counter() - t0
    ate_b, rpe_b = trajectory_errors(tr.trajectory, gt)
    say(f"rgbd track_batch: {len(chunks)} chunks of {RGBD_CHUNK} in "
        f"{t_batch:.1f} s (compile included) keyframes="
        f"{int(tr.ms.n_keyframes())} ATE={ate_b * 100:.3f} cm "
        f"RPE_t={rpe_b * 100:.3f} cm")
    check(tr.st.status == "OK", "batched RGB-D tracking lost")
    check(ate_b < ATE_GATE and rpe_b < RPE_GATE, "batched accuracy gate")


def phase_mono(say):
    from sdslam_tpu.system import MONOCULAR, SDSlamSystem
    from sdslam_tpu.utils import metrics

    cfg = tum1_config()
    seq, frames = render_frames(cfg.camera, MONO_FRAMES, 1.0,
                                radius=0.12, yaw_amp=0.03)
    slam = SDSlamSystem(cfg, sensor=MONOCULAR, loop_closing=False)
    t0 = time.perf_counter()
    for img, _, ts in frames:
        slam.track_monocular(img, ts)
    slam.finish()
    t = time.perf_counter() - t0
    tr = slam.tracker
    n_kf = int(tr.ms.n_keyframes())
    est = np.stack([np.asarray(p) for p in tr.trajectory])
    ate = metrics.ate_rmse(est, np.asarray(seq.poses), align=True,
                           with_scale=True)
    say(f"mono: {len(frames)} frames in {t:.1f} s (compile included) "
        f"status={tr.st.status} keyframes={n_kf} "
        f"points={int(tr.ms.n_points())} "
        f"ATE(sim3-aligned)={ate * 100:.3f} cm")
    check(tr.st.status == "OK", "monocular tracking did not initialize/track")
    check(n_kf >= 3, "no keyframe beyond the two-view initialization")


def phase_tests():
    import pytest

    os.environ["SDSLAM_TESTS_ON_CARD"] = "1"
    rc = pytest.main([
        os.path.join(HERE, "tests"), "-q", "-m", "gpu",
        "-p", "no:cacheprovider", "-p", "no:randomly",
    ])
    print(f"tests: pytest -m gpu exit code {int(rc)}")
    check(int(rc) == 0, "card-only tests failed")


def phase_four_cards(n=4):
    """Multi-device paths, each against its one-card result."""
    from concurrent.futures import ThreadPoolExecutor

    sys.path.insert(0, HERE)
    import __graft_entry__ as ge
    from sdslam_tpu.pipeline.tracking import RGBDTracker

    try:
        # first the pipelined tracker (cards 0 and 1) beside its one-card
        # reference: tracker programs only, no collective
        with ThreadPoolExecutor(1) as ex:
            one_card = ex.submit(
                lambda: ge.track_orbit(RGBDTracker, 20)[0])
            r = ge.check_pipelined(20, ref=one_card)
        print(f"pipelined tracker (track on {r['track_device']}, map on "
              f"{r['map_device']}): ATE={r['ate'] * 100:.3f} cm vs "
              f"one-card {r['ate_ref'] * 100:.3f} cm, max pose gap "
              f"{r['max_gap'] * 100:.3f} cm, keyframes {r['n_kf']}",
              flush=True)
        # then the distributed programs and their one-card runs, one at a
        # time with nothing else in flight: setting up the NCCL
        # communicators synchronizes each card, which fails while another
        # thread is capturing a CUDA graph on it
        r = ge.check_dist_ba(n)
        print(f"dist BA K={r['K']} P={r['P']}: dT={r['dT']:.2e} "
              f"(tol 5e-4) dX={r['dX']:.2e} (tol 5e-3)", flush=True)
        r = ge.check_dist_pgo(n)
        print(f"dist PGO K={r['K']}: dS={r['dS']:.2e} (tol 5e-4), loop "
              f"gap {r['gap_before']:.4f} -> {r['gap_after']:.4f}",
              flush=True)
        r = ge.check_dist_align(n)
        print(f"dist align scan K={r['K']}: dA={r['dA']:.2e} (tol 1e-5), "
              f"self-query slot {r['winner']} (want {r['query']})",
              flush=True)
    except AssertionError as e:
        raise PhaseError(f"four-card check: {e}") from e


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device paths, on four cards")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, "sdslam_tpu")):
        print("chip_smoke.py must run from a checkout of the repository "
              "(sdslam_tpu/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    os.chdir(HERE)
    if args.four_cards:
        # correctness checks only: heuristics instead of autotuning keep
        # the compile time of the multi-device programs down
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "") + " --xla_gpu_autotune_level=0"
        ).strip()
    from sdslam_tpu.utils import compile_cache

    compile_cache.enable()
    import jax

    want = 4 if args.four_cards else 1
    try:
        devs, card = phase_device(jax, want)
        if args.four_cards:
            phase_four_cards()
        else:
            phase_kernels(jax)
            from sdslam_tpu import native

            native.load()  # build the C extension once, before the threads
            cfg, frames, gt = rgbd_sequence()
            side_by_side([
                lambda say: phase_rgbd(say, card, cfg, frames, gt),
                lambda say: phase_batch(say, cfg, frames, gt),
                phase_mono,
            ])
            peak = (devs[0].memory_stats() or {}).get("peak_bytes_in_use", -1)
            print(f"peak_bytes_in_use={peak} (phases 2-4)")
            phase_tests()
    except PhaseError as e:
        print(f"FAILED: {e}", file=sys.stderr)
        return 1
    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devs),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
