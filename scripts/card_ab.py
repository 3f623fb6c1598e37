"""On-card measurements behind the kernel and formulation decisions.

    python scripts/card_ab.py [--only hamming,kernels,step] [--out results.json]

Needs a CUDA device. Prints one line per measurement and writes them all as
JSON (default: build/card_ab_<time>.json):

  * hamming — the dense descriptor distance at matcher shapes (1024 x 1024
    frame-to-frame, 1024 x 16384 frame-to-pool) in its two forms: XOR +
    popcount, and bits unpacked to int8 + one int8 dot_general.
  * kernels — each hand-written kernel alone against its plain XLA version
    at the tracker's widths (sdslam_tpu/ops/pallas/checks.py).
  * step    — the full fused per-frame step at the configs/TUM1.yaml shapes
    (lens distortion zeroed, as in chip_smoke.py) in two variants: "kernel"
    (the pose-solve kernel) and "xla" (pose solves as the XLA loop).
    Each variant (and the kernel checks) is first compiled in its own
    worker process; the workers share the card (15% of its memory each),
    run side by side and fill the persistent compile cache (set
    JAX_COMPILATION_CACHE_DIR, or .jax_cache/ in the checkout). The
    "kernel" worker also profiles its compile (host events, no Python
    tracer) and prints where the time went. Then this process, alone
    on the card, measures the variants one at a time in the order
    kernel, xla, xla, kernel, each loaded from the cache (a cache miss
    shows as a long load time): a profiler trace of 10 frames of
    per-frame tracking (device busy ms/frame, idle share, kernels and
    device->host copies per frame) and the median wall time of
    track() + flush over 24 frames.

Times are medians after warm-up, ending in block_until_ready; the card's
name and power limit are printed beside them.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

ORDER = ("kernel", "xla")
N_WARM, N_TRACE, N_TIMED = 8, 10, 24


def set_variant(name):
    """Route the pose solve to the kernel or to the XLA loop, and drop every
    traced program so the next trace sees it."""
    import jax

    from sdslam_tpu.pipeline import tracking
    from sdslam_tpu.solvers import pose_opt

    if not hasattr(pose_opt, "_card_ab_kernel"):
        pose_opt._card_ab_kernel = pose_opt._optimize_pose_kernel
    pose_opt._optimize_pose_kernel = (
        pose_opt._optimize_pose_xla if name == "xla"
        else pose_opt._card_ab_kernel)
    jax.clear_caches()
    tracking._PROGRAM_CACHE.clear()


def hamming_ab():
    """The two forms of the dense Hamming matrix: XOR + popcount, and the
    int8 dot_general that ops/hamming.py keeps."""
    import jax
    import jax.numpy as jnp

    from sdslam_tpu.ops import hamming as ham
    from sdslam_tpu.ops.pallas.checks import median_us

    @jax.jit
    def xor(da, db):
        x = jnp.bitwise_xor(da[:, None, :], db[None, :, :])
        return jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)

    int8_dot = jax.jit(ham.hamming_matrix)
    rng = np.random.default_rng(0)
    out = []
    for qa, qb in ((1024, 1024), (1024, 16384)):
        a = jnp.asarray(rng.integers(0, 2**32, (qa, 8), dtype=np.uint64)
                        .astype(np.uint32))
        b = jnp.asarray(rng.integers(0, 2**32, (qb, 8), dtype=np.uint64)
                        .astype(np.uint32))
        same = bool((xor(a, b) == int8_dot(a, b)).all())
        r = {"shape": [qa, qb], "equal": same,
             "xor_popcount_us": median_us(xor, a, b),
             "int8_dot_us": median_us(int8_dot, a, b)}
        print(f"hamming {qa}x{qb}: xor+popcount {r['xor_popcount_us']:.1f} us,"
              f" int8 dot {r['int8_dot_us']:.1f} us, equal={same}")
        out.append(r)
    return out


def tum1_frames(n):
    import chip_smoke

    cfg = chip_smoke.tum1_config()
    _, frames = chip_smoke.render_frames(
        cfg.camera, n, cfg.tracking.depth_map_factor, radius=0.06,
        yaw_amp=0.04)
    return cfg, frames


def reduce_trace(log_dir, n_frames):
    """Device busy/idle share and the top device operations of a trace, and
    the host-side events (compile phases among them) by total time."""
    from jax.profiler import ProfileData

    path = sorted(glob.glob(os.path.join(log_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    pd = ProfileData.from_file(path)
    shutil.rmtree(log_dir, ignore_errors=True)
    ivals, by_name, host, n_ev, n_d2h = [], collections.Counter(), \
        collections.Counter(), 0, 0
    for plane in pd.planes:
        on_card = plane.name.startswith("/device:GPU:0")
        if not on_card and plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            for ev in line.events:
                if not on_card:
                    host[ev.name] += ev.duration_ns
                    continue
                ivals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                by_name[ev.name] += ev.duration_ns
                n_ev += 1
                nm = ev.name.lower()
                if "memcpy" in nm and ("dtoh" in nm or "d2h" in nm):
                    n_d2h += 1
    r = {"host_top_s": [(k, v / 1e9) for k, v in host.most_common(40)]}
    if not ivals:
        return r
    ivals.sort()
    busy, cur_s, cur_e = 0, *ivals[0]
    for s, e in ivals[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = ivals[-1][1] - ivals[0][0]
    r.update({
        "window_ms": window / 1e6, "busy_ms_per_frame": busy / 1e6 / n_frames,
        "idle_share": 1.0 - busy / window,
        "device_events_per_frame": n_ev / n_frames,
        "d2h_copies_per_frame": n_d2h / n_frames,
        "top_ops_ms_per_frame": [(k, v / 1e6 / n_frames)
                                 for k, v in by_name.most_common(25)],
    })
    return r


def warm(variant, profile):
    """Worker: compile one variant's per-frame step (or, for "kernels", the
    kernel checks) into the cache."""
    import jax

    from sdslam_tpu.pipeline.tracking import RGBDTracker

    if variant == "kernels":
        from sdslam_tpu.ops.pallas.checks import CHECKS

        t0 = time.perf_counter()
        for _, fn in CHECKS:
            fn()
        print(f"warm kernels: {time.perf_counter() - t0:.1f} s", flush=True)
        return
    cfg, frames = tum1_frames(N_WARM)
    set_variant(variant)
    t0 = time.perf_counter()
    log_dir = tempfile.mkdtemp(prefix="compile_", dir=os.path.join(HERE, "build"))
    if profile:
        opts = jax.profiler.ProfileOptions()
        opts.python_tracer_level = 0
        jax.profiler.start_trace(log_dir, profiler_options=opts)
    tr = RGBDTracker(cfg)
    for img, dep, ts in frames:
        tr.track(img, dep, ts)
    tr.flush()
    if profile:
        jax.profiler.stop_trace()
    wall = time.perf_counter() - t0
    print(f"warm {variant}: {N_WARM} frames incl. compile {wall:.1f} s",
          flush=True)
    if profile:
        host = reduce_trace(log_dir, N_WARM)["host_top_s"]
        print(f"compile profile ({variant}), host events by total time:")
        for name, s in host[:30]:
            print(f"  {s:9.2f} s  {name[:110]}")
    return {"warm_s": wall}


def warm_in_parallel(jobs):
    """The compiles of `jobs` side by side, one worker process each."""
    env = dict(os.environ, XLA_PYTHON_CLIENT_MEM_FRACTION="0.15")
    t0 = time.perf_counter()
    procs = {
        v: subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--warm", v]
            + (["--profile-compile"] if v == "kernel" else []),
            env=env,
        )
        for v in jobs
    }
    rcs = {v: p.wait() for v, p in procs.items()}
    wall = time.perf_counter() - t0
    print(f"parallel warm-up of {', '.join(jobs)}: {wall:.1f} s, "
          f"exit codes {rcs}", flush=True)
    if any(rcs.values()):
        raise SystemExit("a warm-up worker failed")
    return {"wall_s": wall}


def measure(variant, cfg, frames):
    """Steady per-frame tracking of one variant (compiled program loaded
    from the cache)."""
    import jax

    from sdslam_tpu.pipeline.tracking import RGBDTracker

    set_variant(variant)
    t0 = time.perf_counter()
    tr = RGBDTracker(cfg)
    for img, dep, ts in frames[:N_WARM]:
        tr.track(img, dep, ts)
    tr.flush()
    load_s = time.perf_counter() - t0
    log_dir = tempfile.mkdtemp(prefix="trace_", dir=os.path.join(HERE, "build"))
    with jax.profiler.trace(log_dir):
        for img, dep, ts in frames[N_WARM:N_WARM + N_TRACE]:
            tr.track(img, dep, ts)
        tr.flush()
    r = reduce_trace(log_dir, N_TRACE)
    r.pop("host_top_s")
    single = []
    for img, dep, ts in frames[N_WARM + N_TRACE:]:
        t0 = time.perf_counter()
        tr.track(img, dep, ts)
        tr.flush()
        single.append(time.perf_counter() - t0)
    r.update({
        "variant": variant, "load_s": load_s,
        "single_ms_per_frame": statistics.median(single) * 1e3,
        "single_ms": [t * 1e3 for t in single],
        "keyframes": int(tr.ms.n_keyframes()), "status": tr.st.status,
    })
    print(f"step {variant:6s}: device busy {r['busy_ms_per_frame']:.3f} "
          f"ms/frame (idle share {r['idle_share']:.3f}, "
          f"{r['device_events_per_frame']:.0f} kernels, "
          f"{r['d2h_copies_per_frame']:.1f} d2h copies per frame), "
          f"track()+flush {r['single_ms_per_frame']:.3f} ms/frame, "
          f"load {load_s:.1f} s, keyframes {r['keyframes']} {r['status']}",
          flush=True)
    return r


def step_ab():
    cfg, frames = tum1_frames(N_WARM + N_TRACE + N_TIMED)
    runs = [measure(v, cfg, frames) for v in ORDER + ORDER[::-1]]
    summary = {}
    for v in ORDER:
        rs = [r for r in runs if r["variant"] == v]
        summary[v] = {
            "busy_ms_per_frame": [r["busy_ms_per_frame"] for r in rs],
            "single_ms_per_frame": [r["single_ms_per_frame"] for r in rs],
        }
        print(f"step {v:6s}: busy {summary[v]['busy_ms_per_frame']} "
              f"ms/frame, track()+flush {summary[v]['single_ms_per_frame']} "
              f"ms/frame")
    return {"runs": runs, "summary": summary}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--only", default="kernels,step")
    ap.add_argument("--warm", choices=ORDER + ("kernels",),
                    help=argparse.SUPPRESS)
    ap.add_argument("--profile-compile", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    from sdslam_tpu.utils import compile_cache

    compile_cache.enable()
    if args.warm:
        warm(args.warm, args.profile_compile)
        return
    res = {}
    jobs = (ORDER if "step" in args.only else ()) + (
        ("kernels",) if "kernels" in args.only else ())
    if jobs:  # before this process takes the card
        res["warm"] = warm_in_parallel(jobs)

    import jax

    import chip_smoke

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a CUDA device; JAX found {dev.platform}")
    card = chip_smoke.card_line()
    print(f"card: {card}  ({dev.device_kind}, jax {jax.__version__})")
    res.update({"card": card, "device_kind": dev.device_kind})
    if "hamming" in args.only:
        res["hamming"] = hamming_ab()
    if "kernels" in args.only:
        from sdslam_tpu.ops.pallas.checks import CHECKS

        res["kernels"] = {}
        for name, fn in CHECKS:
            r = res["kernels"][name] = fn()
            print(f"kernel {name}: err {r['err']:.2e}, kernel "
                  f"{r['t_kernel_us']:.1f} us, xla {r['t_xla_us']:.1f} us")
    if "step" in args.only:
        res["step"] = step_ab()
    out = args.out or os.path.join(
        HERE, "build", f"card_ab_{int(time.time())}.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(res, f, indent=1)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
