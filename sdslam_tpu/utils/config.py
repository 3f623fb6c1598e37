"""Framework configuration.

Dataclass config with a YAML compatibility layer for the reference's config
keys (/root/reference/src/Config.{h,cc}: Camera.*, ORBextractor.*, UsePattern,
ThDepth, DepthMapFactor, Viewer.*).  All keys are optional with the same
defaults the reference compiles in (Config.cc:28-71), so a user's existing
SD-SLAM YAML (e.g. Examples/Monocular/TUM1.yaml) loads unchanged.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from typing import Optional

from sdslam_tpu.geometry.camera import CameraModel


@dataclass(frozen=True)
class ORBConfig:
    """ORB extractor settings (reference defaults: Config.cc + Example.yaml:40-46)."""

    n_features: int = 1000
    scale_factor: float = 2.0  # coarse pyramid: ImageAlign runs on levels 2-4
    n_levels: int = 5
    fast_threshold: int = 20
    # capacity the static-shape pipeline pads keypoints to (power of two >= n_features)
    max_keypoints: int = 1024
    # intensity-centroid orientation patch half-size
    half_patch: int = 15


@dataclass(frozen=True)
class TrackingConfig:
    th_depth: float = 40.0  # close/far stereo point threshold (in units of bf)
    depth_map_factor: float = 1.0
    use_pattern: bool = False
    # keyframe cadence bounds derive from fps (Tracking.cc:71-77)
    min_frames: int = 0
    max_frames: int = 30
    # image-align settings (ImageAlign.cc:36-39)
    align_max_points: int = 300
    align_fast_points: int = 100
    align_patch_half: int = 2  # 4x4 patch
    align_max_level: int = 4
    align_min_level: int = 2
    align_min_level_kf: int = 4  # KF<->KF loop check: coarsest level only
    align_iters: int = 30
    # GN/LM iteration schedules. Defaults are trimmed schedules
    # (every solve starts from the previous refined state at frame/KF
    # cadence); the reference's longer schedules — pose 4 rounds x 10
    # (Optimizer.cc:343-407), local BA 5+10 (:608-653) — are available for
    # degraded conditions, and tests/test_schedule_stress.py gates the
    # trimmed defaults against them on fast-motion sequences.
    pose_gn_schedule: tuple = ((2, 4), (2, 5))  # (rounds, iters) per solve
    ba_schedule: tuple = (3, 5)  # local BA iters before/after outlier pass


@dataclass(frozen=True)
class MapConfig:
    """Fixed-capacity pools for the array-resident map (the array
    replacement for the reference's dynamically allocated KeyFrame/MapPoint
    pointer graph)."""

    max_keyframes: int = 256
    max_points: int = 16384
    max_kps_per_frame: int = 1024
    covis_min_weight: int = 15  # covisibility edge threshold (KeyFrame.cc:325)


@dataclass(frozen=True)
class LocalMappingConfig:
    ba_max_cams: int = 32  # local BA window capacity
    ba_max_points: int = 8192
    ba_iters1: int = 5
    ba_iters2: int = 10
    triangulate_neighbors: int = 10  # covisible KFs searched (LocalMapping.cc:199)
    culling_min_found_ratio: float = 0.25
    kf_redundancy_ratio: float = 0.9  # KeyFrameCulling threshold


@dataclass(frozen=True)
class LoopClosingConfig:
    enabled: bool = True
    align_error_factor: float = 1.5  # keep candidates < 1.5x best (LoopClosing.cc)
    align_max_error: float = 0.03  # KF<->KF reject threshold (ImageAlign ctor)
    covisibility_consistency_th: int = 3
    min_sim3_matches: int = 20
    min_total_matches: int = 40
    ransac_iters: int = 64


@dataclass(frozen=True)
class SystemConfig:
    camera: CameraModel = CameraModel(
        fx=525.0, fy=525.0, cx=319.5, cy=239.5, width=640, height=480
    )
    orb: ORBConfig = ORBConfig()
    tracking: TrackingConfig = TrackingConfig()
    map: MapConfig = MapConfig()
    local_mapping: LocalMappingConfig = LocalMappingConfig()
    loop_closing: LoopClosingConfig = LoopClosingConfig()
    # ROS-ish extras kept for YAML compat
    camera_topic: str = "/camera/rgb/image_raw"
    depth_topic: str = "/camera/depth_registered/image_raw"
    imu_topic: str = "/imu"


_YAML_DIRECTIVE = re.compile(r"^%YAML.*$|^---.*$", re.MULTILINE)


def _load_yaml_text(path: str) -> dict:
    import yaml

    with open(path) as f:
        text = f.read()
    # OpenCV FileStorage YAML begins with "%YAML:1.0" which PyYAML rejects.
    text = _YAML_DIRECTIVE.sub("", text)
    text = text.replace("!!opencv-matrix", "")
    data = yaml.safe_load(text) or {}
    return data


def load_config(path: Optional[str] = None, **overrides) -> SystemConfig:
    """Build a SystemConfig, optionally from a reference-format YAML file.

    Recognized keys mirror /root/reference/src/Config.cc:73-137.
    """
    cfg = SystemConfig()
    if path is not None:
        d = _load_yaml_text(path)

        def g(key, default):
            v = d.get(key, default)
            return default if v is None else v

        cam = CameraModel(
            fx=float(g("Camera.fx", cfg.camera.fx)),
            fy=float(g("Camera.fy", cfg.camera.fy)),
            cx=float(g("Camera.cx", cfg.camera.cx)),
            cy=float(g("Camera.cy", cfg.camera.cy)),
            width=int(g("Camera.Width", cfg.camera.width)),
            height=int(g("Camera.Height", cfg.camera.height)),
            k1=float(g("Camera.k1", 0.0)),
            k2=float(g("Camera.k2", 0.0)),
            p1=float(g("Camera.p1", 0.0)),
            p2=float(g("Camera.p2", 0.0)),
            k3=float(g("Camera.k3", 0.0)),
            bf=float(g("Camera.bf", 0.0)),
            fps=float(g("Camera.fps", 30.0)),
        )
        n_feat = int(g("ORBextractor.nFeatures", 1000))
        orb = ORBConfig(
            n_features=n_feat,
            scale_factor=float(g("ORBextractor.scaleFactor", 2.0)),
            n_levels=int(g("ORBextractor.nLevels", 5)),
            fast_threshold=int(g("ORBextractor.thresholdFAST", 20)),
            # static capacity: next power of two that fits the request
            max_keypoints=max(256, 1 << (max(n_feat, 1) - 1).bit_length()),
        )
        tracking = TrackingConfig(
            th_depth=float(g("ThDepth", 40.0)),
            depth_map_factor=float(g("DepthMapFactor", 1.0)),
            use_pattern=bool(g("UsePattern", 0)),
            max_frames=int(round(cam.fps)) if cam.fps > 0 else 30,
        )
        # pool capacities (extension keys — the reference's map grows
        # unbounded; fixed-capacity pools need explicit sizing)
        map_cfg = MapConfig(
            max_keyframes=int(g("Map.MaxKeyframes", cfg.map.max_keyframes)),
            max_points=int(g("Map.MaxPoints", cfg.map.max_points)),
            max_kps_per_frame=orb.max_keypoints,
        )
        cfg = dataclasses.replace(
            cfg,
            camera=cam,
            orb=orb,
            tracking=tracking,
            map=map_cfg,
            camera_topic=str(g("ROS.CameraTopic", cfg.camera_topic)),
            depth_topic=str(g("ROS.DepthTopic", cfg.depth_topic)),
            imu_topic=str(g("ROS.IMUTopic", cfg.imu_topic)),
        )
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg
