"""RGB-D / monocular tracking front-end (the per-frame hot path).

Re-architecture of Tracking (reference src/Tracking.{h,cc}):
the same state machine (NO_IMAGES_YET -> NOT_INITIALIZED -> OK/LOST,
Tracking.h:54-60) runs on the host, but every per-frame computation is one of
a few jitted static-shape device functions:

  track_step:   EKF/velocity prediction -> direct image alignment
                (Tracking.cc:666-673) -> last-frame projection matching
                (Tracking.cc:677) -> pose GN (Tracking.cc:693) -> local-map
                search + second pose GN (TrackLocalMap, Tracking.cc:720-747)
  init_step:    RGB-D StereoInitialization (Tracking.cc:305-349) /
                monocular initialization (separate module)
  keyframe_step: KF insertion + close-point creation
                (CreateNewKeyFrame, Tracking.cc:828-888)

Match counts come back as scalars; the host reads them once per frame to
drive the state machine (the only device->host sync point).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sdslam_tpu import native
from sdslam_tpu.features import matching
from sdslam_tpu.features.frame import Frame, ORBExtractor, make_frame
from sdslam_tpu.geometry import camera as cam_mod
from sdslam_tpu.geometry import lie
from sdslam_tpu.geometry.camera import CameraModel
from sdslam_tpu.mapping import local_mapping as LM
from sdslam_tpu.mapping import map_state as M
from sdslam_tpu.ops import hamming as ham
from sdslam_tpu.pipeline import sensors
from sdslam_tpu.pipeline.relocalization import relocalize
from sdslam_tpu.solvers import ba, image_align, pose_opt
from sdslam_tpu.utils.config import SystemConfig

# pyramid levels stored per keyframe (direct alignment runs on levels >= 2;
# storing level 0/1 would cost ~15x the HBM for no consumer)
KF_STORE_MIN_LEVEL = 2


class TrackOutput(NamedTuple):
    Tcw: jnp.ndarray  # [4,4] optimized pose
    assoc: jnp.ndarray  # [N] int32 keypoint -> point id (inliers only)
    n_inliers: jnp.ndarray  # scalar int32
    n_matches: jnp.ndarray  # scalar int32 (pre-optimization)
    align_error: jnp.ndarray  # photometric alignment residual


def _track_core(
    cam: CameraModel,
    ms: M.MapState,
    # current frame
    uv_und,
    desc,
    octave,
    kp_valid,
    uright,
    pyr_cur: Tuple[jnp.ndarray, ...],
    # reference keyframe (slot in the map)
    ref_slot,
    # prediction
    T_pred,
    scale_factor: float = 2.0,
    n_levels: int = 5,
    align_min_level: int = 2,
    th_radius=1.0,  # traced: 1 mono / 3 RGB-D / 5 just-relocalized
    pose_gn_schedule=((2, 4), (2, 5)),  # (rounds, iters) for the 2 solves
) -> TrackOutput:
    # --- 1. direct sparse image alignment against the REFERENCE KEYFRAME
    # (BA-refined anchor; aligning to the drifting last frame would compound
    # its error through the velocity loop). The KF stores pyramid levels
    # >= KF_STORE_MIN_LEVEL, exactly the levels alignment runs on. ---
    T_ref = ms.kf_Tcw[ref_slot]
    ref_uv = ms.kf_uv[ref_slot]
    ref_depth = ms.kf_depth[ref_slot]
    ref_assoc = ms.kf_mp[ref_slot]
    pyr_ref = tuple(pl[ref_slot] for pl in ms.kf_pyramid)
    # alignment depth source: measured (RGB-D) where available, else the
    # bound map point's depth in the reference camera (monocular — the
    # reference's ImageAlign uses map points, ImageAlign.cc:355-421)
    map_z = lie.se3_apply(
        T_ref, ms.pt_pos[jnp.clip(ref_assoc, 0, ms.P - 1)]
    )[:, 2]
    has_map = (ref_assoc >= 0) & (map_z > 0.05)
    depth_eff = jnp.where(ref_depth > 0, ref_depth, jnp.where(has_map, map_z, -1.0))
    align_valid = ms.kf_kp_valid[ref_slot] & (depth_eff > 0)
    X_ref_cam = cam_mod.backproject(
        cam, ms.kf_uv_und[ref_slot], jnp.maximum(depth_eff, 1e-3)
    )
    T_cl_init = lie.mm(T_pred, lie.se3_inv(T_ref))
    ares = image_align.align(
        pyr_ref,
        tuple(pyr_cur[KF_STORE_MIN_LEVEL:]),
        ref_uv,
        X_ref_cam,
        align_valid,
        T_cl_init,
        cam.fx,
        cam.fy,
        cam.cx,
        cam.cy,
        scale_factor=scale_factor,
        max_level=n_levels - 1,
        min_level=align_min_level,
        start_level=KF_STORE_MIN_LEVEL,
    )
    T_init = lie.mm(ares.T_cur_ref, T_ref)

    # --- 2. project the reference KF's map points, window match (th=8px) ---
    q_pt = ref_assoc
    q_ok = (q_pt >= 0) & ms.pt_valid[jnp.clip(q_pt, 0, ms.P - 1)]
    q_pos = ms.pt_pos[jnp.clip(q_pt, 0, ms.P - 1)]
    q_desc = ms.pt_desc[jnp.clip(q_pt, 0, ms.P - 1)]
    # source-observation octave: scales the window radius and centers the
    # [-1,+1] octave gate, so coarse (octave>=2) keypoints can re-match
    # (SearchByProjection(Frame, LastFrame), ORBmatcher.cc:946-1075 —
    # previously hardcoded 0, which froze coarse features out of step 2)
    q_oct = ms.kf_octave[ref_slot]
    res1 = matching.search_by_projection(
        cam,
        T_init,
        q_pos,
        q_desc,
        q_ok,
        q_oct,
        uv_und,
        desc,
        kp_valid,
        octave,
        radius_px=8.0,
        th_desc=ham.TH_HIGH,
        scale_factor=scale_factor,
    )
    # starvation fallback (Tracking.cc:680-685): < 20 matches -> retry with a
    # doubled window from the raw prediction (alignment may have diverged)
    res1_wide = matching.search_by_projection(
        cam,
        T_pred,
        q_pos,
        q_desc,
        q_ok,
        q_oct,
        uv_und,
        desc,
        kp_valid,
        octave,
        radius_px=16.0,
        th_desc=ham.TH_HIGH,
        scale_factor=scale_factor,
    )
    starved = jnp.sum(res1.kp_to_query >= 0) < 20
    kp_to_q = jnp.where(starved, res1_wide.kp_to_query, res1.kp_to_query)
    T_init = jnp.where(starved, T_pred, T_init)
    assoc1 = jnp.where(
        kp_to_q >= 0, q_pt[jnp.clip(kp_to_q, 0, ms.N - 1)], -1
    )

    # --- 3. pose-only GN on matched map points, with the aligner's rotation
    # as a prior (it pins the low-parallax translation/rotation valley) ---
    align_ok = (ares.error < 0.01) & (ares.n_meas > 500) & (~starved)
    # prior strength scales with photometric residual: a fresh-keyframe
    # alignment (ae ~ 2e-4) earns a tight prior; as the baseline to the
    # reference KF grows the alignment degrades and its prior must weaken,
    # otherwise it drags the pose away from the (correct) reprojection answer
    quality = jnp.sqrt(jnp.maximum(ares.error, 1e-5) / 2e-4)
    rot_sigma = jnp.clip(0.003 * quality, 0.003, 0.1)
    trans_sigma = jnp.clip(0.02 * quality, 0.02, 0.5)
    rot_info = jnp.where(align_ok, 1.0 / rot_sigma**2, 0.0)
    trans_info = jnp.where(align_ok, 1.0 / trans_sigma**2, 0.0)
    inv_sigma2 = 1.0 / scale_factor ** (2.0 * octave.astype(jnp.float32))
    X1 = ms.pt_pos[jnp.clip(assoc1, 0, ms.P - 1)]
    v1 = assoc1 >= 0
    opt1 = pose_opt.optimize_pose(
        cam, T_init, X1, uv_und, inv_sigma2, v1, ur_obs=uright,
        rounds=pose_gn_schedule[0][0], iters_per_round=pose_gn_schedule[0][1],
        T_prior=T_init, prior_rot_info=rot_info, prior_trans_info=trans_info,
    )

    # --- 4. local-map search (the whole resident point pool; masked) ---
    res2 = matching.search_local_points(
        cam,
        opt1.Tcw,
        ms.pt_pos,
        ms.pt_desc,
        ms.pt_valid,
        ms.pt_normal,
        ms.pt_min_dist,
        ms.pt_max_dist,
        uv_und,
        desc,
        kp_valid,
        octave,
        # state-dependent window (Tracking.cc:926-937): th=1 mono, 3 RGB-D,
        # 5 for the 2 frames after relocalization
        th_radius=th_radius,
        scale_factor=scale_factor,
        n_levels=n_levels,
    )
    # keep existing assoc; fill gaps from the local search
    assoc2 = jnp.where(v1 & opt1.inliers, assoc1, -1)
    assoc2 = jnp.where((assoc2 < 0) & (res2.kp_to_query >= 0), res2.kp_to_query, assoc2)

    # --- 5. second pose refinement on the richer association set ---
    X2 = ms.pt_pos[jnp.clip(assoc2, 0, ms.P - 1)]
    v2 = assoc2 >= 0
    opt2 = pose_opt.optimize_pose(
        cam, opt1.Tcw, X2, uv_und, inv_sigma2, v2, ur_obs=uright,
        rounds=pose_gn_schedule[1][0], iters_per_round=pose_gn_schedule[1][1],
        T_prior=T_init, prior_rot_info=rot_info, prior_trans_info=trans_info,
    )
    final_assoc = jnp.where(v2 & opt2.inliers, assoc2, -1)
    # one packed vector = the single device->host transfer per frame
    packed = jnp.concatenate(
        [
            opt2.Tcw.ravel(),
            jnp.stack(
                [
                    opt2.n_inliers.astype(jnp.float32),
                    jnp.sum(v1).astype(jnp.float32),
                    ares.error,
                ]
            ),
        ]
    )
    return TrackOutput(
        Tcw=opt2.Tcw,
        assoc=final_assoc,
        n_inliers=opt2.n_inliers,
        n_matches=jnp.sum(v1),
        align_error=ares.error,
    ), packed


track_step = functools.partial(
    jax.jit, static_argnames=("cam", "scale_factor", "n_levels",
                              "align_min_level", "pose_gn_schedule")
)(_track_core)


@functools.partial(jax.jit, static_argnames=("cam", "scale_factor", "n_levels"))
def keyframe_step(
    cam: CameraModel,
    ms: M.MapState,
    slot,
    Tcw,
    uv,
    uv_und,
    octave,
    angle,
    desc,
    kp_valid,
    depth,
    uright,
    assoc,
    stored_pyr: Tuple[jnp.ndarray, ...],
    frame_id,
    timestamp,
    parent,
    scale_factor: float = 2.0,
    n_levels: int = 5,
) -> M.MapState:
    """Insert a keyframe with its tracked associations only
    (CreateNewKeyFrame part 1, Tracking.cc:828-836). Point creation happens
    separately AFTER local BA (spawn_points): new points must inherit the
    BA-refined pose, otherwise their depth edges anchor the keyframe to its
    own pre-refinement error and drift compounds across keyframes."""
    ms = M.insert_keyframe(
        ms, slot, Tcw, uv, uv_und, octave, angle, desc, kp_valid,
        depth, uright, assoc, stored_pyr, frame_id, timestamp, parent,
    )
    return M.finalize_point_statistics(ms, scale_factor, n_levels)


@functools.partial(
    jax.jit, static_argnames=("cam", "scale_factor", "n_levels", "update_stats")
)
def spawn_points(
    cam: CameraModel,
    ms: M.MapState,
    slot,
    close_depth_th,
    scale_factor: float = 2.0,
    n_levels: int = 5,
    update_stats: bool = True,
) -> M.MapState:
    """Create map points from the keyframe's close depth readings, using its
    (BA-refined) pose (CreateNewKeyFrame part 2, Tracking.cc:837-888)."""
    Tcw = ms.kf_Tcw[slot]
    depth = ms.kf_depth[slot]
    uv_und = ms.kf_uv_und[slot]
    assoc = ms.kf_mp[slot]
    kp_valid = ms.kf_kp_valid[slot]
    candidate = kp_valid & (assoc < 0) & (depth > 0)
    want = candidate & (depth < close_depth_th)
    # reference fallback (Tracking.cc:858-872): if fewer than 100 close
    # points, create the 100 nearest candidates regardless of the threshold
    MIN_CLOSE = 100
    need_fallback = jnp.sum(want) < MIN_CLOSE
    nearness = jnp.where(candidate, -depth, -jnp.inf)
    kth = jax.lax.top_k(nearness, min(MIN_CLOSE, nearness.shape[0]))[0][-1]
    nearest = candidate & (-depth >= kth)
    want = jnp.where(need_fallback, want | nearest, want)
    Xc = cam_mod.backproject(cam, uv_und, jnp.maximum(depth, 1e-3))
    pos_w = lie.se3_apply(lie.se3_inv(Tcw), Xc)
    ms, _ = M.create_points(ms, slot, want, pos_w)
    if update_stats:
        ms = M.finalize_point_statistics(ms, scale_factor, n_levels)
    return ms




def _kf_core(
    cam: CameraModel,
    ms: M.MapState,
    Tcw,
    uv,
    uv_und,
    octave,
    angle,
    desc,
    kp_valid,
    depth,
    uright,
    assoc,
    stored_pyr: Tuple[jnp.ndarray, ...],
    frame_id,
    timestamp,
    parent,
    close_depth_th,
    scale_factor: float = 2.0,
    n_levels: int = 5,
    covis_min: int = 15,
    ba_schedule=(3, 5),
):
    """The whole keyframe-cadence mapping pass as ONE device program:
    slot allocation -> insertion -> neighbor fusion -> statistics ->
    local BA -> depth spawning -> epipolar triangulation -> counters ->
    point/KF culling. Fusing it removes 8 host<->device boundaries.

    Returns (ms, slot, new_assoc_row, Tcw_refined)."""
    slot = jnp.argmin(ms.kf_valid)  # first free slot (pool guarded by host)
    ms = M.insert_keyframe(
        ms, slot, Tcw, uv, uv_und, octave, angle, desc, kp_valid,
        depth, uright, assoc, stored_pyr, frame_id, timestamp, parent,
    )
    new_kf_id = ms.next_kf_id  # pt_first_kf stamp of points created below
    # incidence + covisibility computed ONCE and reused by fusion/BA/
    # triangulation/statistics (they change only marginally within the
    # pass; the final state is re-derived next keyframe). The [K*N]-element
    # incidence scatter is the shared fixed cost every derived structure
    # (covis matmul, observer counts, local/frontier masks, touched-point
    # mask) would otherwise pay separately.
    inc = M.incidence_matrix(ms)
    covis = M.covisibility(ms, inc=inc)
    ms = LM.fuse_neighbors(
        cam, ms, slot, scale_factor=scale_factor, covis=covis,
        obs_cnt=M.point_obs_count_from_inc(ms, inc),
    )
    ms = ba.local_ba(
        cam, ms, slot, scale_factor=scale_factor, covis_min=covis_min,
        covis=covis, inc=inc, iters1=ba_schedule[0], iters2=ba_schedule[1],
    )
    ms = spawn_points(
        cam, ms, slot, close_depth_th, scale_factor=scale_factor,
        n_levels=n_levels, update_stats=False,
    )
    ms = LM.triangulate_new_points(
        cam, ms, slot, scale_factor=scale_factor, n_levels=n_levels,
        covis=covis, update_stats=False,
    )
    ms = M.update_tracking_counters(ms, cam, ms.kf_Tcw[slot], ms.kf_mp[slot])
    # ONE per-point observation-list build shared by point culling (count
    # thresholds <= the M cap), KF culling, and the statistics pass (stale
    # entries are masked by the consumers' kf_mp/kf_valid checks)
    obs_lists = M.build_obs_lists(ms, 16)
    obs_cnt = jnp.sum(obs_lists[0] >= 0, axis=1)
    ms = LM.cull_points(ms, obs_cnt=obs_cnt)
    rows = (covis[slot] > 0) | (jnp.arange(ms.K) == slot)
    # redundancy culling exists to bound map growth; with fixed-capacity
    # pools it only has an effect worth its cost once the pool is
    # filling up — below half occupancy the branch is skipped (lax.cond
    # executes one side). The reference culls every pass because its map
    # grows without bound (LocalMapping.cc:580).
    ms = jax.lax.cond(
        jnp.sum(ms.kf_valid) > ms.K // 2,
        lambda m: LM.cull_keyframes(
            m, slot, obs_lists=obs_lists, rows_mask=rows, covis=covis
        ),
        lambda m: m,
        ms,
    )
    # ONE statistics pass for the whole mapping step, restricted to points
    # observed by the keyframe rows this pass touched (the new KF + its
    # covisible window — the only rows whose bindings/positions changed).
    # The O(P*M^2) recompute previously ran 3x over the full pool.
    # Touched set from the SHARED incidence (one matmul) instead of a
    # fresh [K*N] scatter; the stale-inc holes are patched explicitly:
    # points bound in the new KF's current row (fuse additions, depth
    # spawns, merge winners) and points created this pass (triangulation
    # binds some only into neighbor rows).
    touched = (
        jnp.dot(
            rows.astype(jnp.bfloat16), inc,
            preferred_element_type=jnp.float32,
        )
        > 0
    )
    row_now = ms.kf_mp[slot]
    touched = touched.at[
        jnp.where(row_now >= 0, row_now, ms.P)
    ].set(True, mode="drop")
    touched = touched | (ms.pt_first_kf == new_kf_id)
    ms = M.finalize_point_statistics_local(
        ms, rows, scale_factor, n_levels, obs_lists=obs_lists,
        touched=touched,
    )
    return ms, slot, ms.kf_mp[slot], ms.kf_Tcw[slot]


kf_pipeline = functools.partial(
    jax.jit, static_argnames=("cam", "scale_factor", "n_levels", "covis_min",
                              "ba_schedule")
)(_kf_core)


# jitted program cache shared across tracker instances, keyed by
# (tracker class, camera, config reprs) — see RGBDTracker.__init__
_PROGRAM_CACHE: dict = {}


def pack_frame(img_u8, depth_u16, timestamp: float):
    """Pack (u8 intensity [H,W], u16 depth [H,W], f32 timestamp) into one
    u8 buffer [H + H//2 + 1, W] for a single host->device upload.

    Transport format (v2, half the v1 payload):
      rows 0..H-1          intensity image
      rows H..H+H//2-1     depth DECIMATED 2x2 (u16): per row, W//2
                           low bytes then W//2 high bytes
      last row             f32 timestamp in the first 4 bytes
    Decimation keeps exact sensor values; per-keypoint nearest sampling
    moves at most one full-res pixel (depth maps are locally smooth; the
    reference itself reads the raw pixel under the keypoint,
    Frame::ComputeStereoFromRGBD, Frame.cc:399-417). The disk e2e ATE
    gates (<2 cm TUM / EuRoC) validate the diet end to end."""
    H, W = img_u8.shape
    assert H % 2 == 0 and W % 2 == 0, "camera dims must be even"
    Hh, Wh = H // 2, W // 2
    buf = np.empty((H + Hh + 1, W), np.uint8)
    nat = native.load()  # single-pass packer (native/loader.c)
    if nat is not None and hasattr(nat, "pack_frame2"):
        nat.pack_frame2(
            np.ascontiguousarray(img_u8),
            np.ascontiguousarray(depth_u16),
            float(timestamp), buf, H, W,
        )
        return buf
    buf[:H, :W] = img_u8
    dh = np.ascontiguousarray(depth_u16[::2, ::2])
    buf[H : H + Hh, :Wh] = (dh & 0xFF).astype(np.uint8)
    buf[H : H + Hh, Wh : 2 * Wh] = (dh >> 8).astype(np.uint8)
    buf[H + Hh, :4] = np.frombuffer(
        np.float32(timestamp).tobytes(), dtype=np.uint8
    )
    buf[H + Hh, 4:] = 0  # deterministic payload (np.empty above)
    return buf


class DeviceState(NamedTuple):
    """Per-frame tracker state that lives ON DEVICE across frames, so the
    host never has to synchronize to run the next frame.
    Replaces the host-side pieces of the reference's Tracking members
    (mVelocity/EKF state, mnLastKeyFrameId, Tracking.h:139-176)."""

    ekf: sensors.EKFState
    imu: sensors.IMUState  # 16-state device IMU filter (fusion sensor)
    last_kf_slot: jnp.ndarray  # int32
    frames_since_kf: jnp.ndarray  # int32
    ref_kf_inliers: jnp.ndarray  # int32: inliers when the ref KF was made
    frame_id: jnp.ndarray  # int32
    last_ts: jnp.ndarray  # float32


# layout of the packed per-frame readback vector (one async D2H per frame)
PACK_POSE = slice(0, 16)
PACK_INLIERS = 16
PACK_MATCHES = 17
PACK_ALIGN_ERR = 18
PACK_NEED_KF = 19
PACK_KF_SLOT = 20
PACK_N_KFS = 21
PACK_N_PTS = 22
PACK_LEN = 23


@dataclasses.dataclass
class TrackerState:
    status: str = "NOT_INITIALIZED"
    T_last: Optional[jnp.ndarray] = None
    velocity: Optional[jnp.ndarray] = None  # retained for introspection
    last_ts: float = 0.0
    last_frame: Optional[Frame] = None
    last_assoc: Optional[jnp.ndarray] = None
    frames_since_kf: int = 0
    frame_id: int = 0
    last_kf_slot: int = -1
    ref_kf_inliers: int = 0  # inlier count when the reference KF was created


class RGBDTracker:
    """Host-side orchestration of RGB-D SLAM.

    Architecture: the ENTIRE per-frame computation — ORB
    extraction, EKF prediction, photometric alignment, matching, pose GN,
    the keyframe decision, and (conditionally, via lax.cond) the whole
    mapping pass — is ONE jitted device program carrying a DeviceState
    pytree across frames. The host only streams frames in and drains a
    small packed result vector out, ASYNCHRONOUSLY, a few frames behind.
    Rationale: the reference's host-driven state machine
    (Tracking.cc:185-300) would synchronize with the device on every
    frame, leaving the device idle for each round trip.
    """

    _HAS_DEPTH = True
    # frames in flight before the host inspects results: deep enough that a
    # drain rarely catches a keyframe pass still executing (KF cadence is
    # ~1-in-4 frames), shallow enough to bound the device queue
    PIPELINE_DEPTH = 4
    # high-water mark forcing a blocking drain burst: draining in bursts
    # amortizes the blocking device->host sync. Between bursts, results
    # whose transfer already completed are drained via is_ready().
    DRAIN_HIGH_WATER = 7
    LOST_PATIENCE = 1  # <10-inlier frames before reloc (immediate, Tracking.cc:235-238)
    # TrackLocalMap search radius (Tracking.cc:926-937): 3 for RGB-D
    # (MonoTracker overrides with 1); 5 for the 2 frames after relocalization
    TH_RADIUS = 3.0
    TH_RADIUS_RELOC = 5.0

    def __init__(self, cfg: SystemConfig):
        self.cfg = cfg
        cam = cfg.camera
        self.cam = cam
        self.extractor = ORBExtractor(cam, cfg.orb)
        sf = cfg.orb.scale_factor
        shapes = []
        h, w = cam.height, cam.width
        for lvl in range(cfg.orb.n_levels):
            if lvl >= KF_STORE_MIN_LEVEL:
                shapes.append((h, w))
            h, w = (h + 1) // 2, (w + 1) // 2
        self.ms = M.init_map(
            cfg.map.max_keyframes,
            cfg.map.max_points,
            cfg.orb.max_keypoints,
            tuple(shapes),
        )
        self.st = TrackerState()
        self.dst: Optional[DeviceState] = None
        self.mapping_enabled = True  # False = localization-only mode
        self.trajectory: List[np.ndarray] = []
        self.timestamps: List[float] = []
        # close-point threshold in meters: bf*ThDepth/fx (Tracking.cc:101-104)
        if cam.bf > 0:
            self.close_depth = cam.bf * cfg.tracking.th_depth / cam.fx
        else:
            self.close_depth = float("inf")
        # async readback queue: (trajectory index, packed device array)
        self._pending: List[Tuple[int, jnp.ndarray]] = []
        self._lost_streak = 0
        self.kf_events: List[int] = []  # drained slots of new KFs (loop closing)
        self._imu_meas = np.zeros(6, np.float32)  # [gyro(3), accel(3)]
        self._use_imu = False
        self._reloc_boost_until = -1  # frame id bound for the th=5 window
        # device timestamps are RELATIVE to the first frame: TUM/EuRoC use
        # unix-epoch stamps (~1.7e9 s) whose float32 resolution is ~128 s —
        # packing them raw destroys every on-device dt (EKF prediction)
        self._t0: Optional[float] = None
        self._flags_host = None
        self._flags_dev = None
        self._fused_packed = None  # set by _build_fused when supported
        # program cache SHARED ACROSS TRACKER INSTANCES: the fused step is a
        # pure function of (tracker class, camera, config) — rebuilding it
        # per instance re-TRACES the whole per-frame graph (seconds of host
        # time for each fresh tracker), even
        # though the XLA executable cache then hits. Benchmarks, resets and
        # multi-sequence runs construct many trackers with one config.
        key = (
            type(self).__name__, repr(cam), repr(cfg.orb), repr(cfg.map),
            repr(cfg.tracking),
        )
        progs = _PROGRAM_CACHE.get(key)
        if progs is None:
            self._fused = self._build_fused()
            progs = {
                "fused": self._fused,
                "fused_packed": self._fused_packed,
                # subclasses (pipelined) may not define the packed scan core
                "step_core": getattr(self, "_step_packed_core", None),
                "scan": {},
            }
            _PROGRAM_CACHE[key] = progs
        else:
            self._fused = progs["fused"]
            self._fused_packed = progs["fused_packed"]
            self._step_packed_core = progs["step_core"]
        self._fused_scan_cache = progs["scan"]

    def _rel_ts(self, timestamp: float) -> float:
        """Device-bound timestamp, relative to the tracker's first frame
        (float32-safe for unix-epoch dataset stamps)."""
        if self._t0 is None:
            self._t0 = float(timestamp)
        return float(timestamp) - self._t0

    # -- fused per-frame device program ------------------------------------

    def _build_fused(self):
        cam = self.cam
        cfg = self.cfg
        sf = cfg.orb.scale_factor
        nl = cfg.orb.n_levels
        aml = cfg.tracking.align_min_level
        covis_min = cfg.map.covis_min_weight
        pose_sched = tuple(tuple(x) for x in cfg.tracking.pose_gn_schedule)
        ba_sched = tuple(cfg.tracking.ba_schedule)
        kf_interval = max(3, cfg.tracking.max_frames // 10)
        depth_factor = float(cfg.tracking.depth_map_factor)
        close_depth = self.close_depth if np.isfinite(self.close_depth) else 1e9
        core = self.extractor.core
        has_depth = self._HAS_DEPTH

        def step(ms, dst, img, depth_img, ts, mapping_enabled, imu_meas,
                 use_imu, th_radius):
            feats, pyramid, d, uright = core(
                img, depth_img if has_depth else None, depth_factor
            )
            dt = jnp.maximum(ts - dst.last_ts, 1e-4)
            gyro, accel = imu_meas[:3], imu_meas[3:6]
            ekf = dst.ekf
            # IMU fusion (TrackFusion): gyro rate overrides the filter's
            # angular twist before prediction (Tracking.cc:215-227 style)
            ekf = ekf._replace(
                x=jnp.where(use_imu, ekf.x.at[3:6].set(gyro), ekf.x)
            )
            ekf, T_pred_cv = sensors.ekf_predict(ekf, dt)
            # 16-state device IMU filter: predicts the CURRENT frame's pose
            # with zero lag and fuses both gyro+accel after tracking (the
            # reference's same-frame EKF cycle, EKF.cc:44-104 /
            # Tracking.cc:215-245; a host filter would lag PIPELINE_DEPTH
            # frames)
            imu_s, T_pred_imu = sensors.imu_predict(dst.imu, dt)
            T_pred = jnp.where(
                use_imu & dst.imu.updated, T_pred_imu, T_pred_cv
            )
            out, _ = _track_core(
                cam, ms,
                feats.uv_und, feats.desc, feats.octave, feats.valid,
                uright, pyramid, dst.last_kf_slot, T_pred,
                scale_factor=sf, n_levels=nl, align_min_level=aml,
                th_radius=th_radius, pose_gn_schedule=pose_sched,
            )
            n_inl = out.n_inliers
            track_ok = n_inl >= 10
            # keyframe policy (NeedNewKeyFrame, Tracking.cc:753-826), fully
            # on-device: healthy pose + association decayed or interval stale
            healthy = n_inl >= 20
            free = jnp.any(~ms.kf_valid)
            fskf = dst.frames_since_kf
            decayed = n_inl.astype(jnp.float32) < 0.9 * dst.ref_kf_inliers.astype(jnp.float32)
            need_kf = (
                mapping_enabled & track_ok & healthy & free
                & (fskf >= 2) & (decayed | (fskf >= kf_interval))
            )
            stored_pyr = tuple(pyramid[KF_STORE_MIN_LEVEL:])

            def kf_branch(ms):
                ms2, slot, _, Tcw_ref = _kf_core(
                    cam, ms, out.Tcw,
                    feats.uv, feats.uv_und, feats.octave, feats.angle,
                    feats.desc, feats.valid, d, uright, out.assoc, stored_pyr,
                    dst.frame_id, ts, dst.last_kf_slot,
                    jnp.asarray(close_depth, jnp.float32),
                    scale_factor=sf, n_levels=nl, covis_min=covis_min,
                    ba_schedule=ba_sched,
                )
                return ms2, slot, Tcw_ref

            def skip_branch(ms):
                return ms, dst.last_kf_slot, out.Tcw

            ms, slot, Tcw_fin = jax.lax.cond(need_kf, kf_branch, skip_branch, ms)
            # reported pose: last accepted pose while tracking is failing
            # (the reference reports the last known pose when LOST)
            T_report = jnp.where(track_ok, Tcw_fin, ekf.last_pose)
            ekf = sensors.ekf_update(ekf, Tcw_fin, dt, track_ok)
            imu_s = sensors.imu_update(
                imu_s, Tcw_fin, gyro, accel, dt, track_ok & use_imu
            )
            dst2 = DeviceState(
                ekf=ekf,
                imu=imu_s,
                last_kf_slot=jnp.where(need_kf, slot, dst.last_kf_slot),
                frames_since_kf=jnp.where(need_kf, 0, fskf + 1),
                ref_kf_inliers=jnp.where(need_kf, n_inl, dst.ref_kf_inliers),
                frame_id=dst.frame_id + 1,
                last_ts=ts,
            )
            packed = jnp.concatenate(
                [
                    T_report.ravel(),
                    jnp.stack(
                        [
                            n_inl.astype(jnp.float32),
                            out.n_matches.astype(jnp.float32),
                            out.align_error,
                            need_kf.astype(jnp.float32),
                            slot.astype(jnp.float32),
                            jnp.sum(ms.kf_valid).astype(jnp.float32),
                            jnp.sum(ms.pt_valid).astype(jnp.float32),
                        ]
                    ),
                ]
            )
            return ms, dst2, packed, T_report, feats, pyramid, d, uright

        H, W = cam.height, cam.width

        def step_packed(ms, dst, buf, mapping_enabled, imu_meas, use_imu,
                        th_radius):
            """Packed-frame variant: ONE u8 upload [H+H//2+1, W] carries the
            intensity image, the 2x2-decimated u16 depth (lo|hi half-rows)
            and the f32 timestamp (first 4 bytes of the trailer row): one
            host->device transfer per frame instead of three, and half the
            depth payload."""
            Hh, Wh = H // 2, W // 2
            img = buf[:H, :W]
            dep = buf[H : H + Hh, :Wh].astype(jnp.uint16) | (
                buf[H : H + Hh, Wh : 2 * Wh].astype(jnp.uint16) << 8
            )
            tsw = buf[H + Hh, :4].astype(jnp.uint32)
            ts_bits = tsw[0] | (tsw[1] << 8) | (tsw[2] << 16) | (tsw[3] << 24)
            ts = jax.lax.bitcast_convert_type(ts_bits, jnp.float32)
            return step(ms, dst, img, dep, ts, mapping_enabled, imu_meas,
                        use_imu, th_radius)

        self._fused_packed = jax.jit(step_packed, donate_argnums=(0, 1))
        self._step_packed_core = step_packed  # unjitted body for scan fusion
        return jax.jit(step, donate_argnums=(0, 1))

    # -- async readback ------------------------------------------------------

    @staticmethod
    def _wait_ready(x, poll_s: float = 0.002):
        """Sleep-poll until a device value is computed before fetching it,
        so the fetch itself never blocks on a running program."""
        try:
            while not x.is_ready():
                time.sleep(poll_s)
        except AttributeError:
            pass  # backend without is_ready

    def _drain_one(self):
        idx, packed = self._pending.pop(0)
        self._wait_ready(packed)
        p = np.asarray(packed)  # [PACK_LEN] or [B, PACK_LEN] (track_batch)
        rows = p[None] if p.ndim == 1 else p
        for b, row in enumerate(rows):
            self._apply_packed_row(idx + b, row)

    def _drain_burst(self, k: int):
        """Drain k pending entries with ONE device->host fetch: the burst
        stacks the per-frame result vectors on device first.
        Consecutive batch (track_batch) entries of the same chunk size are
        likewise concatenated into one fetch."""
        k = min(k, len(self._pending))
        singles = []
        while k > 0 and self._pending:
            idx, packed = self._pending[0]
            if packed.ndim != 1:
                break  # batch entry: handled below
            singles.append(self._pending.pop(0))
            k -= 1
        if len(singles) == 1:
            self._pending.insert(0, singles[0])
            self._drain_one()
        elif singles:
            stacked_d = jnp.stack([p for _, p in singles])
            self._wait_ready(stacked_d)
            stacked = np.asarray(stacked_d)
            for (idx, _), row in zip(singles, stacked):
                self._apply_packed_row(idx, row)
        # consecutive same-width batch entries: one concatenated fetch
        batches = []
        while k > 0 and self._pending and self._pending[0][1].ndim == 2 and (
            not batches
            or self._pending[0][1].shape == batches[0][1].shape
        ):
            batches.append(self._pending.pop(0))
            k -= 1
        if len(batches) == 1:
            self._pending.insert(0, batches[0])
            self._drain_one()
        elif batches:
            cat_d = jnp.concatenate([p for _, p in batches], axis=0)
            self._wait_ready(cat_d)
            cat = np.asarray(cat_d)
            r = 0
            for idx, p in batches:
                for b in range(p.shape[0]):
                    self._apply_packed_row(idx + b, cat[r])
                    r += 1
        if k > 0 and self._pending:
            self._drain_one()

    def _apply_packed_row(self, idx, p):
        n_inl = int(p[PACK_INLIERS])
        pose = p[PACK_POSE].reshape(4, 4)
        self.trajectory[idx] = pose
        self.st.T_last = pose
        if bool(p[PACK_NEED_KF]):
            slot = int(p[PACK_KF_SLOT])
            self.st.last_kf_slot = slot
            self.st.ref_kf_inliers = n_inl
            self.kf_events.append(slot)
        if n_inl < 10:
            self._lost_streak += 1
            if self._lost_streak >= self.LOST_PATIENCE and self.mapping_enabled:
                self.st.status = "LOST"
            elif not self.mapping_enabled:
                # localization mode relocalizes immediately (no map to damage)
                self.st.status = "LOST"
        else:
            self._lost_streak = 0
            if self.st.status != "NOT_INITIALIZED":
                self.st.status = "OK"

    def flush(self):
        """Drain every in-flight frame (call before reading host state)."""
        while self._pending:
            self._drain_burst(len(self._pending))

    # -- host API ------------------------------------------------------------

    def inject_imu(self, gyro, accel=None):
        """Feed the raw IMU measurement for the NEXT tracked frame
        (TrackFusion path; Tracking.cc:215-245): the device-resident
        16-state EKF fuses it with the frame's tracked pose zero-lag."""
        m = np.zeros(6, np.float32)
        m[:3] = np.asarray(gyro, np.float32).reshape(3)
        if accel is not None:
            m[3:6] = np.asarray(accel, np.float32).reshape(3)
        self._imu_meas = m
        self._use_imu = True

    def inject_angular_rate(self, w):
        """Gyro-only variant of inject_imu."""
        self.inject_imu(w)

    def reset_reference(self, slot: int, Tcw=None):
        """Re-anchor tracking after an external map update (loop closure):
        new reference KF + restart the motion filter from its pose."""
        self.flush()
        T = jnp.asarray(Tcw) if Tcw is not None else self.ms.kf_Tcw[slot]
        self.st.last_kf_slot = int(slot)
        # host state holds HOST values: a device array here could alias the
        # donated DeviceState pytree and be deleted by the next tracker step
        self.st.T_last = np.asarray(T)
        if self.dst is not None:
            self.dst = self.dst._replace(
                ekf=sensors.ekf_init(T),
                imu=sensors.imu_init(),
                last_kf_slot=jnp.asarray(slot, jnp.int32),
            )

    def _stored_pyr(self, frame: Frame):
        return tuple(frame.pyramid[KF_STORE_MIN_LEVEL:])

    def _free_kf_slot(self) -> int:
        free = np.flatnonzero(~np.asarray(self.ms.kf_valid))
        if len(free) == 0:
            raise RuntimeError("keyframe pool exhausted (culling not yet active)")
        return int(free[0])

    def _initialize(self, frame: Frame, timestamp: float):
        f = frame.features
        slot = self._free_kf_slot()
        assoc = jnp.full((f.capacity,), -1, jnp.int32)
        self.ms = keyframe_step(
            self.cam, self.ms, slot, frame.Tcw,
            f.uv, f.uv_und, f.octave, f.angle, f.desc, f.valid,
            frame.depth, frame.uright, assoc, self._stored_pyr(frame),
            jnp.asarray(self.st.frame_id, jnp.int32),
            jnp.asarray(self._rel_ts(timestamp), jnp.float32),
            jnp.asarray(-1, jnp.int32),
            scale_factor=self.cfg.orb.scale_factor, n_levels=self.cfg.orb.n_levels,
        )
        self.ms = spawn_points(
            self.cam, self.ms, jnp.asarray(slot),
            jnp.asarray(self.close_depth, jnp.float32),
            scale_factor=self.cfg.orb.scale_factor, n_levels=self.cfg.orb.n_levels,
        )
        # last-frame assoc: keypoints bound to the points just created
        self.st.last_assoc = self.ms.kf_mp[slot]
        self.st.last_kf_slot = slot
        self.st.T_last = np.asarray(frame.Tcw)
        self.st.velocity = jnp.eye(4)
        self.st.last_ts = timestamp
        self.st.last_frame = frame
        self.st.status = "OK"
        self.st.frames_since_kf = 0
        self.st.ref_kf_inliers = int(jnp.sum(self.st.last_assoc >= 0))
        self._start_device_state(slot, frame.Tcw, timestamp)

    def _start_device_state(self, slot: int, Tcw, timestamp: float):
        self.dst = DeviceState(
            ekf=sensors.ekf_init(Tcw),
            imu=sensors.imu_init(),  # restarts on reloc (Tracking.cc:1126)
            last_kf_slot=jnp.asarray(slot, jnp.int32),
            frames_since_kf=jnp.asarray(0, jnp.int32),
            ref_kf_inliers=jnp.asarray(self.st.ref_kf_inliers, jnp.int32),
            frame_id=jnp.asarray(self.st.frame_id, jnp.int32),
            last_ts=jnp.asarray(self._rel_ts(timestamp), jnp.float32),
        )

    def track(self, img, depth_img, timestamp: float):
        if self.st.status == "NOT_INITIALIZED":
            frame = make_frame(
                self.extractor, img, depth_img=depth_img,
                depth_factor=self.cfg.tracking.depth_map_factor,
            )
            self._initialize(frame, timestamp)
            pose = self.st.T_last if self.st.status == "OK" else frame.Tcw
            self.trajectory.append(np.asarray(pose))
            self.timestamps.append(timestamp)
            self.st.frame_id += 1
            return self.trajectory[-1]

        if self.st.status == "LOST":
            return self._relocalize_step(img, depth_img, timestamp)

        st = self.st
        th_radius = (
            self.TH_RADIUS_RELOC
            if st.frame_id < self._reloc_boost_until
            else self.TH_RADIUS
        )
        # cache rarely-changing scalars on device (4 fewer H2D per frame)
        flags = (self.mapping_enabled, self._use_imu,
                 self._imu_meas.tobytes(), th_radius)
        if flags != self._flags_host:
            self._flags_host = flags
            self._flags_dev = (
                jnp.asarray(self.mapping_enabled),
                jnp.asarray(self._imu_meas),
                jnp.asarray(self._use_imu),
                jnp.asarray(th_radius, jnp.float32),
            )
        mapping_d, imu_d, use_imu_d, th_d = self._flags_dev
        # packed path: one u8 H2D carrying img + depth + ts (u8 intensity +
        # u16 depth payloads only; anything else falls back)
        if (
            self._fused_packed is not None
            and self._HAS_DEPTH
            and isinstance(img, np.ndarray)
            and isinstance(depth_img, np.ndarray)
            and img.dtype == np.uint8
            and depth_img.dtype == np.uint16
        ):
            buf = pack_frame(img, depth_img, self._rel_ts(timestamp))
            self.ms, self.dst, packed, T_report, feats, pyramid, d, uright = (
                self._fused_packed(
                    self.ms, self.dst, jnp.asarray(buf),
                    mapping_d, imu_d, use_imu_d, th_d,
                )
            )
        else:
            img_d = jnp.asarray(img)
            dep_d = jnp.asarray(depth_img) if self._HAS_DEPTH else img_d
            self.ms, self.dst, packed, T_report, feats, pyramid, d, uright = (
                self._fused(
                    self.ms, self.dst, img_d, dep_d,
                    jnp.asarray(self._rel_ts(timestamp), jnp.float32),
                    mapping_d, imu_d, use_imu_d, th_d,
                )
            )
        self._use_imu = False
        # start the D2H copy of the result vector NOW; inspect it
        # PIPELINE_DEPTH frames later, when it has long arrived
        try:
            packed.copy_to_host_async()
        except AttributeError:
            pass
        self.trajectory.append(T_report)  # device array; drain replaces w/ np
        self.timestamps.append(timestamp)
        idx = len(self.trajectory) - 1
        self._pending.append((idx, packed))
        st.last_frame = Frame(feats, tuple(pyramid), d, uright, T_report)
        st.last_ts = timestamp
        st.frame_id += 1
        # drain in stacked bursts of >= 3: k results are fetched as ONE
        # stacked array, one blocking sync per burst
        k = len(self._pending) - self.PIPELINE_DEPTH
        if k >= 3 and (
            len(self._pending) > self.DRAIN_HIGH_WATER or self._head_ready()
        ):
            self._drain_burst(k)
        return self.trajectory[idx]

    def _head_ready(self) -> bool:
        try:
            return bool(self._pending[0][1].is_ready())
        except AttributeError:
            return True  # backend without is_ready: preserve old behavior

    # -- batched (offline/dataset) ingestion ---------------------------------

    def _get_fused_scan(self, B: int):
        """One device program tracking B frames via lax.scan over the packed
        step body — for offline/dataset throughput, where per-frame dispatch
        overhead dominates. Live pipelines should use
        track() (per-frame latency)."""
        if not hasattr(self, "_fused_scan_cache"):
            self._fused_scan_cache = {}
        if B not in self._fused_scan_cache:
            body = self._step_packed_core

            def scan_fn(ms, dst, bufs, mapping_enabled, imu_meas, use_imu,
                        th_radius):
                def f(carry, buf):
                    ms, dst = carry
                    ms, dst, packed, T_report, *_ = body(
                        ms, dst, buf, mapping_enabled, imu_meas, use_imu,
                        th_radius
                    )
                    return (ms, dst), (packed, T_report)

                (ms, dst), (packs, Ts) = jax.lax.scan(f, (ms, dst), bufs)
                return ms, dst, packs, Ts

            self._fused_scan_cache[B] = jax.jit(scan_fn, donate_argnums=(0, 1))
        return self._fused_scan_cache[B]

    def upload_batch(self, items):
        """Pack a chunk's frames and START their host->device transfer now.
        Returns a handle for `track_batch(..., uploaded=handle)`.

        Double-buffering hook: device transfers are asynchronous, so
        uploading chunk k+1 while the device still scans chunk k overlaps
        transfer with compute (max instead of sum of the two costs)."""
        items = list(items)
        bufs = np.stack(
            [pack_frame(img, dep, self._rel_ts(ts)) for (img, dep, ts) in items]
        )
        return (jnp.asarray(bufs), items)

    def track_batch(self, items, uploaded=None):
        """Track a list of (img_u8, depth_u16, timestamp) frames in ONE
        device dispatch (sequential on device, exact per-frame semantics).
        Results drain in one device->host sync per batch. Frames before
        initialization (or while LOST) fall back to per-frame track().
        `uploaded`: a matching handle from upload_batch (device transfer
        already in flight); ignored if tracking is not in the OK state."""
        if uploaded is not None:
            bufs_dev, up_items = uploaded
            items = list(items)
            # a stale/mismatched handle would silently track the wrong
            # frames: fail loudly unless the handle covers exactly `items`.
            # Identity comparison, not timestamps — two different chunks
            # can share timestamps (e.g. a sequence restarted at t=0).
            if len(up_items) != len(items) or any(
                u is not i for u, i in zip(up_items, items)
            ):
                raise ValueError(
                    "uploaded handle does not match items (count or "
                    "identity differ) — pass the handle returned by "
                    "upload_batch for this exact chunk"
                )
            if self.st.status == "OK":
                return self._track_batch_scan(list(up_items), bufs_dev)
            # not in the OK state: the in-flight upload cannot be consumed
            # (init/reloc run per-frame); fall through to the per-frame path
        items = list(items)
        out_idx = []
        i = 0
        while i < len(items) and self.st.status != "OK":
            img, dep, ts = items[i]
            self.track(img, dep, ts)
            out_idx.append(len(self.trajectory) - 1)
            i += 1
        rest = items[i:]
        if not rest:
            return out_idx
        bufs = np.stack(
            [pack_frame(img, dep, self._rel_ts(ts)) for (img, dep, ts) in rest]
        )
        return out_idx + self._track_batch_scan(rest, jnp.asarray(bufs))

    def _track_batch_scan(self, rest, bufs_dev):
        B = len(rest)
        flags = (self.mapping_enabled, self._use_imu,
                 self._imu_meas.tobytes(), self.TH_RADIUS)
        if flags != self._flags_host:
            self._flags_host = flags
            self._flags_dev = (
                jnp.asarray(self.mapping_enabled),
                jnp.asarray(self._imu_meas),
                jnp.asarray(self._use_imu),
                jnp.asarray(self.TH_RADIUS, jnp.float32),
            )
        mapping_d, imu_d, use_imu_d, th_d = self._flags_dev
        self.ms, self.dst, packs, Ts = self._get_fused_scan(B)(
            self.ms, self.dst, bufs_dev,
            mapping_d, imu_d, use_imu_d, th_d,
        )
        try:
            packs.copy_to_host_async()
        except AttributeError:
            pass
        out_idx = []
        idx0 = len(self.trajectory)
        for b, (img, dep, ts) in enumerate(rest):
            # placeholder; the drain writes the numpy pose (slicing Ts here
            # would cost one ~ms device dispatch per frame). Poses
            # materialize on drain/flush.
            self.trajectory.append(None)
            self.timestamps.append(ts)
            out_idx.append(idx0 + b)
        self._pending.append((idx0, packs))  # one entry drains B rows
        self.st.frame_id += B
        self.st.last_ts = rest[-1][2]
        while (
            len(self._pending) > self.PIPELINE_DEPTH and self._head_ready()
        ):
            self._drain_one()
        if len(self._pending) > self.DRAIN_HIGH_WATER:
            while len(self._pending) > self.PIPELINE_DEPTH:
                self._drain_one()
        return out_idx

    def _relocalize_step(self, img, depth_img, timestamp: float):
        """Recovery via batched relocalization against all keyframes
        (Tracking.cc:1064-1097; the O(N_KF) scan is one vmapped align)."""
        self.flush()
        st = self.st
        frame = make_frame(
            self.extractor, img, depth_img=depth_img,
            depth_factor=self.cfg.tracking.depth_map_factor,
        )
        f = frame.features
        self._reloc_seed = getattr(self, "_reloc_seed", 0) + 1
        rr = relocalize(
            self.cam, self.ms,
            f.uv_und, f.desc, f.octave, f.valid, frame.uright, frame.pyramid,
            key=jax.random.key(self._reloc_seed),
            scale_factor=self.cfg.orb.scale_factor,
            n_levels=self.cfg.orb.n_levels,
            store_min_level=KF_STORE_MIN_LEVEL,
        )
        if bool(rr.success):
            Tcw = rr.Tcw
            frame = frame._replace(Tcw=Tcw)
            st.status = "OK"
            st.last_kf_slot = int(rr.best_kf)
            st.last_assoc = rr.assoc
            st.T_last = np.asarray(Tcw)
            st.last_frame = frame
            st.frames_since_kf = 0
            st.ref_kf_inliers = max(int(jnp.sum(rr.assoc >= 0)), 1)
            self._lost_streak = 0
            # coarser local-map search for the next 2 frames
            # (mnLastRelocFrameId window, Tracking.cc:934-936)
            self._reloc_boost_until = st.frame_id + 1 + 2
            self._start_device_state(int(rr.best_kf), Tcw, timestamp)
        # while lost, report the last known pose
        st.frame_id += 1
        st.last_ts = timestamp
        pose = np.asarray(frame.Tcw if bool(rr.success) else st.T_last)
        self.trajectory.append(pose)
        self.timestamps.append(timestamp)
        return self.trajectory[-1]


class MonoTracker(RGBDTracker):
    """Monocular front-end: two-view bootstrap (H/F RANSAC) + map growth by
    epipolar triangulation. Scale is set by normalizing the initial map's
    median depth to 1 (CreateInitialMapMonocular, Tracking.cc:458-504)."""

    _HAS_DEPTH = False
    TH_RADIUS = 1.0  # monocular local-map window (Tracking.cc:931)

    def __init__(self, cfg: SystemConfig):
        super().__init__(cfg)
        self._init_frame: Optional[Frame] = None
        self._init_ts: float = 0.0

    def track(self, img, timestamp: float):  # type: ignore[override]
        return super().track(img, None, timestamp)

    def _pattern_initialize(self, frame: Frame, timestamp: float) -> bool:
        """Metric-scale monocular bootstrap from a chessboard
        (Tracking::PatternInitialization, Tracking.cc:506-568): the first
        frame that sees the pattern becomes the identity-pose keyframe and
        every keypoint whose ray hits the board rectangle spawns a metric
        map point."""
        from sdslam_tpu.features import pattern as pat

        f = frame.features
        img = np.asarray(frame.pyramid[0])
        res = pat.detect_pattern(
            np.clip(img, 0, 255).astype(np.uint8), self.cam
        )
        if not res.found:
            return False
        uv = np.asarray(f.uv_und)
        inside, X_cam = pat.metric_points_on_board(res, self.cam, uv)
        inside &= np.asarray(f.valid)
        if inside.sum() < 20:
            return False
        slot = self._free_kf_slot()
        assoc = jnp.full((f.capacity,), -1, jnp.int32)
        self.ms = keyframe_step(
            self.cam, self.ms, slot, jnp.eye(4),
            f.uv, f.uv_und, f.octave, f.angle, f.desc, f.valid,
            frame.depth, frame.uright, assoc, self._stored_pyr(frame),
            jnp.asarray(self.st.frame_id, jnp.int32),
            jnp.asarray(self._rel_ts(timestamp), jnp.float32),
            jnp.asarray(-1, jnp.int32),
            scale_factor=self.cfg.orb.scale_factor,
            n_levels=self.cfg.orb.n_levels,
        )
        # frame pose = identity, so camera-frame points ARE world points
        self.ms, _ = M.create_points(
            self.ms, jnp.asarray(slot), jnp.asarray(inside),
            jnp.asarray(X_cam),
        )
        self.ms = M.finalize_point_statistics(
            self.ms, self.cfg.orb.scale_factor, self.cfg.orb.n_levels
        )
        self.st.last_assoc = self.ms.kf_mp[slot]
        self.st.last_kf_slot = slot
        self.st.T_last = np.eye(4, dtype=np.float32)
        self.st.last_ts = timestamp
        self.st.status = "OK"
        self.st.frames_since_kf = 0
        self.st.ref_kf_inliers = int(jnp.sum(self.st.last_assoc >= 0))
        self._start_device_state(slot, jnp.eye(4), timestamp)
        return True

    def _initialize(self, frame: Frame, timestamp: float):
        from sdslam_tpu.solvers import initializer as init_mod

        f = frame.features
        if self.cfg.tracking.use_pattern:
            # UsePattern config (Tracking.cc:121,198-199): chessboard metric
            # init replaces the two-view bootstrap entirely
            self._pattern_initialize(frame, timestamp)
            return
        if self._init_frame is None:
            self._init_frame = frame
            self._init_ts = timestamp
            return
        f0 = self._init_frame.features
        res = matching.search_for_initialization(
            f0.uv_und, f0.desc, f0.valid, f0.octave, f0.angle,
            f.uv_und, f.desc, f.valid, f.octave, f.angle,
        )
        kp_to_q = res.kp_to_query  # frame kp -> init-frame kp
        n_matches = int(res.count())
        if n_matches < 100:
            # too little overlap: restart from this frame (Tracking.cc:376-383)
            self._init_frame = frame
            self._init_ts = timestamp
            return
        # aligned match arrays indexed by current-frame keypoints
        q = jnp.clip(kp_to_q, 0, f0.capacity - 1)
        uv1 = f0.uv_und[q]
        uv2 = f.uv_und
        valid = kp_to_q >= 0
        self._seed = getattr(self, "_seed", 0) + 1
        ires = init_mod.initialize_two_view(
            self.cam, uv1, uv2, valid, jax.random.key(self._seed)
        )
        if not bool(ires.success):
            return
        # scale: median triangulated depth -> 1 (Tracking.cc:497-503)
        inl = ires.inliers
        z = jnp.where(inl, ires.X1[:, 2], jnp.nan)
        med = jnp.nanmedian(z)
        X1 = ires.X1 / med
        T2 = lie.se3_from_Rt(ires.R21, ires.t21 / med)

        # keyframe 1 (the stored init frame, identity pose)
        slot1 = self._free_kf_slot()
        fr0 = self._init_frame
        self.ms = keyframe_step(
            self.cam, self.ms, slot1, jnp.eye(4),
            f0.uv, f0.uv_und, f0.octave, f0.angle, f0.desc, f0.valid,
            fr0.depth, fr0.uright, jnp.full((f0.capacity,), -1, jnp.int32),
            self._stored_pyr(fr0),
            jnp.asarray(self.st.frame_id - 1, jnp.int32),
            jnp.asarray(self._rel_ts(self._init_ts), jnp.float32),
            jnp.asarray(-1, jnp.int32),
            scale_factor=self.cfg.orb.scale_factor, n_levels=self.cfg.orb.n_levels,
        )
        # keyframe 2 (current frame) with triangulated points bound to both
        slot2 = self._free_kf_slot()
        self.ms = keyframe_step(
            self.cam, self.ms, slot2, T2,
            f.uv, f.uv_und, f.octave, f.angle, f.desc, f.valid,
            frame.depth, frame.uright, jnp.full((f.capacity,), -1, jnp.int32),
            self._stored_pyr(frame),
            jnp.asarray(self.st.frame_id, jnp.int32),
            jnp.asarray(self._rel_ts(timestamp), jnp.float32),
            jnp.asarray(slot1, jnp.int32),
            scale_factor=self.cfg.orb.scale_factor, n_levels=self.cfg.orb.n_levels,
        )
        # create the triangulated points bound to KF2's keypoints (X1 is in
        # KF1 camera frame == world, since KF1 = identity)
        self.ms, ids = M.create_points(
            self.ms, jnp.asarray(slot2), inl & valid, X1
        )
        # bind KF1-side observations through the match mapping
        created = ids >= 0
        row1 = self.ms.kf_mp[slot1]
        row1 = row1.at[jnp.where(created, q, self.ms.N)].set(
            jnp.where(created, ids, -1), mode="drop"
        )
        self.ms = self.ms._replace(kf_mp=self.ms.kf_mp.at[slot1].set(row1))
        self.ms = M.finalize_point_statistics(
            self.ms, self.cfg.orb.scale_factor, self.cfg.orb.n_levels
        )
        # full BA on the initial two-view map (GlobalBundleAdjustemnt(20),
        # Tracking.cc:458)
        self.ms = ba.global_ba(
            self.cam, self.ms, fixed_kf=int(slot1),
            scale_factor=self.cfg.orb.scale_factor, iters=20,
        )

        self.st.last_assoc = self.ms.kf_mp[slot2]
        self.st.last_kf_slot = int(slot2)
        self.st.T_last = np.asarray(self.ms.kf_Tcw[slot2])
        self.st.velocity = jnp.eye(4)
        self.st.last_ts = timestamp
        self.st.last_frame = frame
        self.st.status = "OK"
        self.st.frames_since_kf = 0
        self.st.ref_kf_inliers = int(jnp.sum(self.st.last_assoc >= 0))
        self._start_device_state(int(slot2), self.st.T_last, timestamp)
        self._init_frame = None
