"""Command-line front-ends, mirroring the reference's example binaries
(Examples/Monocular/monocular.cc, Examples/RGB-D/rgbd.cc,
Examples/Fusion/monocular_imu.cc):

    python -m sdslam_tpu.cli monocular <config.yaml> <image_dir> [--save-map m.npz]
    python -m sdslam_tpu.cli rgbd <config.yaml> <tum_sequence_dir>
    python -m sdslam_tpu.cli fusion <config.yaml> <euroc_dir>
    python -m sdslam_tpu.cli synthetic [--sensor rgbd|monocular] [--frames N]

Each run prints per-frame state and writes trajectory.txt (TUM format).
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def _common(sub):
    sub.add_argument("--traj-out", default="trajectory.txt")
    sub.add_argument("--save-map", default=None)
    sub.add_argument("--load-map", default=None)
    # reference-format YAML map interchange (System::Save/LoadTrajectory)
    sub.add_argument("--save-trajectory-yaml", default=None,
                     metavar="YAML", help="reference-schema map save "
                     "(PNG folder next to it)")
    sub.add_argument("--load-trajectory-yaml", default=None, metavar="YAML")
    sub.add_argument("--localization-only", action="store_true")
    sub.add_argument("--no-loop-closing", action="store_true")
    sub.add_argument("--max-frames", type=int, default=None)
    # live web viewer (the Pangolin-window equivalent, viewer_server.py)
    sub.add_argument("--viewer-port", type=int, default=None,
                     metavar="PORT", help="serve a live map/frame view at "
                     "http://127.0.0.1:PORT while tracking")


def main(argv=None):
    from sdslam_tpu.utils import compile_cache

    # the CLI's big fused programs take minutes to compile from scratch;
    # cached reruns start in seconds
    compile_cache.enable()
    ap = argparse.ArgumentParser(prog="sdslam_tpu")
    sp = ap.add_subparsers(dest="cmd", required=True)
    for name in ("monocular", "rgbd", "fusion"):
        sub = sp.add_parser(name)
        sub.add_argument("config")
        sub.add_argument("data")
        _common(sub)
    sub = sp.add_parser("synthetic")
    sub.add_argument("--sensor", default="rgbd", choices=["rgbd", "monocular"])
    sub.add_argument("--frames", type=int, default=30)
    _common(sub)
    # chessboard camera calibration from an image folder
    # (Examples/Calibration/calibration.cc: 6x4 inner corners, 30.2 mm)
    sub = sp.add_parser("calibration")
    sub.add_argument("image_dir")
    sub.add_argument("--cell-mm", type=float, default=30.2)
    sub.add_argument("--out", default="calibration.yaml")
    args = ap.parse_args(argv)

    from sdslam_tpu.system import MONOCULAR, MONOCULAR_IMU, RGBD, SDSlamSystem
    from sdslam_tpu.utils.config import load_config

    if args.cmd == "calibration":
        return _run_calibration(args)

    if args.cmd == "synthetic":
        from sdslam_tpu.geometry.camera import CameraModel
        from sdslam_tpu.io.synthetic import SyntheticSequence
        from sdslam_tpu.utils.config import MapConfig, ORBConfig, SystemConfig

        cam = CameraModel(fx=320.0, fy=320.0, cx=159.5, cy=119.5,
                          width=320, height=240, bf=32.0)
        cfg = SystemConfig(
            camera=cam,
            orb=ORBConfig(max_keypoints=512, n_levels=4),
            map=MapConfig(max_keyframes=32, max_points=4096, max_kps_per_frame=512),
        )
        sensor = RGBD if args.sensor == "rgbd" else MONOCULAR
        sysm = SDSlamSystem(cfg, sensor=sensor)
        seq = SyntheticSequence(cam, n_frames=args.frames, trajectory="orbit",
                                radius=0.06, yaw_amp=0.04)
        frames = ((seq.frame(i)) for i in range(len(seq)))
    else:
        cfg = load_config(args.config)
        if args.cmd == "monocular":
            sysm = SDSlamSystem(cfg, sensor=MONOCULAR,
                                loop_closing=not args.no_loop_closing)
            if args.data.startswith("/dev/video"):
                # live capture front-end, paced at Camera.fps
                # (reference monocular.cc:52-196 opens /dev/videoN the
                # same way when the argument is a device index)
                from sdslam_tpu.io.camera import live_frames

                fps = getattr(cfg.camera, "fps", 0) or 30.0
                frames = (
                    (ts, img, None)
                    for ts, img in live_frames(
                        args.data, cfg.camera.width, cfg.camera.height,
                        fps=fps,
                    )
                )
            elif os.path.exists(
                os.path.join(args.data, "mav0", "cam0", "data.csv")
            ):
                # EuRoC ASL layout, monocular-only (the reference's
                # Examples/Monocular/EuRoC.yaml + monocular.cc:52-196
                # workload — BASELINE config 3: direct ImageAlign tracking
                # + EPnP relocalization, no IMU)
                from sdslam_tpu.io.datasets import EuRoCDataset

                ds = EuRoCDataset(args.data)
                frames = ((ts, img, None) for ts, img in ds)
            else:
                from sdslam_tpu.io.datasets import TUMMonoDataset

                ds = TUMMonoDataset(args.data)
                frames = ((ts, img, None) for ts, img in ds)
        elif args.cmd == "rgbd":
            from sdslam_tpu.io.datasets import TUMRGBDDataset

            sysm = SDSlamSystem(cfg, sensor=RGBD,
                                loop_closing=not args.no_loop_closing)
            ds = TUMRGBDDataset(args.data, depth_factor=cfg.tracking.depth_map_factor or 5000.0)
            # RAW u8/u16 payloads (native prefetch decode): the tracker
            # applies DepthMapFactor on device, exactly like the reference
            # scales ImDepth inside GrabImageRGBD (Tracking.cc:146-152) —
            # feeding pre-scaled meters here would double-divide
            frames = ds.prefetch_iter(raw=True)
        else:
            from sdslam_tpu.io.datasets import EuRoCDataset

            sysm = SDSlamSystem(cfg, sensor=MONOCULAR_IMU,
                                loop_closing=not args.no_loop_closing)
            ds = EuRoCDataset(args.data)

            def gen():
                last_t = None
                for ts, img in ds:
                    rows = ds.imu_between(last_t, ts) if last_t else []
                    meas = rows[-1] if rows else [0.0] * 6
                    last_t = ts
                    yield ts, img, meas

            frames = gen()

    live = None
    if args.viewer_port is not None:
        from sdslam_tpu.viewer_server import LiveViewer

        live = LiveViewer(sysm)
        port = live.start(port=args.viewer_port)
        print(f"live viewer at http://127.0.0.1:{port}", flush=True)

    if args.load_map:
        sysm.load_map(args.load_map)
    if args.load_trajectory_yaml:
        sysm.load_trajectory(args.load_trajectory_yaml)
    if args.localization_only:
        sysm.activate_localization_mode()

    t0 = time.perf_counter()
    n = 0
    for item in frames:
        if args.cmd == "fusion":
            ts, img, meas = item
            sysm.track_fusion(img, meas, ts)
        elif (args.cmd == "rgbd") or (args.cmd == "synthetic" and args.sensor == "rgbd"):
            ts, img, depth = item
            sysm.track_rgbd(img, depth, ts)
        else:
            ts, img = item[0], item[1]
            sysm.track_monocular(img, ts)
        n += 1
        if n % 10 == 0:
            # st.status is the async host view (a flushing
            # get_tracking_state() here would stall the device pipeline)
            fps = n / (time.perf_counter() - t0)
            print(
                f"frame {n}: state={sysm.tracker.st.status} {fps:.1f} fps",
                flush=True,
            )
        if args.max_frames and n >= args.max_frames:
            break
        if sysm.stop_requested:
            # viewer "Stop and Save" (System::RequestStop): exit the loop;
            # the trajectory/map saves below run as on normal completion
            print("stop requested — saving and exiting", flush=True)
            break

    sysm.finish()
    if live is not None:
        live.stop()
    sysm.save_trajectory_tum(args.traj_out)
    print(f"saved {args.traj_out} ({n} poses); final state {sysm.get_tracking_state()}")
    if args.save_map:
        sysm.save_map(args.save_map)
        print(f"saved map checkpoint {args.save_map}")
    if args.save_trajectory_yaml:
        folder = os.path.splitext(args.save_trajectory_yaml)[0] + "_images"
        sysm.save_trajectory(args.save_trajectory_yaml, folder)
        print(f"saved reference-format map {args.save_trajectory_yaml}")
    sysm.shutdown()


def _run_calibration(args):
    """Chessboard calibration over every image in a folder; writes the
    estimated intrinsics as a reference-format YAML
    (Examples/Calibration/calibration.cc)."""
    import glob

    import numpy as np
    from PIL import Image

    from sdslam_tpu.features.pattern import calibrate_from_images

    paths = sorted(
        p
        for p in glob.glob(os.path.join(args.image_dir, "*"))
        if p.lower().endswith((".png", ".jpg", ".jpeg", ".bmp", ".pgm"))
    )
    if not paths:
        raise SystemExit(f"no images found in {args.image_dir}")
    imgs = [np.asarray(Image.open(p).convert("L")) for p in paths]
    cam, rms = calibrate_from_images(imgs, cell=args.cell_mm / 1000.0)
    with open(args.out, "w") as f:
        f.write("%YAML:1.0\n\n")
        f.write(f"Camera.Width: {cam.width}\n")
        f.write(f"Camera.Height: {cam.height}\n")
        f.write(f"Camera.fx: {cam.fx:.6f}\nCamera.fy: {cam.fy:.6f}\n")
        f.write(f"Camera.cx: {cam.cx:.6f}\nCamera.cy: {cam.cy:.6f}\n")
        f.write(f"Camera.k1: {cam.k1:.6f}\nCamera.k2: {cam.k2:.6f}\n")
        f.write(f"Camera.p1: {cam.p1:.6f}\nCamera.p2: {cam.p2:.6f}\n")
        f.write(f"Camera.k3: {cam.k3:.6f}\n")
    print(f"calibrated {len(imgs)} views, reprojection RMS {rms:.4f} px")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    main()
