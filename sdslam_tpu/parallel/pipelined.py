"""Tracking-vs-mapping pipelining across devices.

The reference decouples per-frame Tracking (caller's thread) from
LocalMapping (its own thread, /root/reference/src/System.cc:61-62) so the
camera loop never blocks on bundle adjustment; they share the map under
`Map::mMutexMapUpdate`. The equivalent here re-expresses that thread
decoupling as DEVICE decoupling (SURVEY.md §2.9):

  * device T runs the per-frame fused tracking program (extract + align +
    match + pose GN) against an immutable MapState SNAPSHOT;
  * device M runs the keyframe mapping pass (fuse + local BA + spawn +
    triangulate + cull + stats) concurrently on its own snapshot;
  * when a mapping pass completes, its refreshed MapState is swapped in as
    tracking's next snapshot (one async device->device transfer).

There are no mutexes by construction: tracking only READS the map, mapping
produces a new value. Staleness semantics match the reference: between a
keyframe's creation and the end of its mapping pass, tracking runs on the
pre-keyframe map (the reference's tracking likewise proceeds on whatever
the map contained when it grabbed the mutex).

Single-host multi-device only (jax.device_put between local devices); the
cross-host version rides the same MapState pytree over the network via
jax.device_put with a cross-process sharding.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sdslam_tpu.mapping import map_state as M
from sdslam_tpu.pipeline import sensors
from sdslam_tpu.pipeline.tracking import (
    KF_STORE_MIN_LEVEL,
    PACK_INLIERS,
    PACK_NEED_KF,
    RGBDTracker,
    _kf_core,
    _track_core,
    DeviceState,
)
from sdslam_tpu.utils.config import SystemConfig


class PipelinedRGBDTracker(RGBDTracker):
    """RGB-D tracker with the keyframe mapping pass offloaded to a second
    device. API-compatible with RGBDTracker (track/flush/trajectory).

    The tracking device program is the same fused step minus the inline
    kf branch; when its packed readback reports need_kf, the retained frame
    tensors are shipped to the mapping device, the mapping pass dispatched
    asynchronously, and the refreshed map swapped in when done.
    """

    def __init__(self, cfg: SystemConfig, track_device=None, map_device=None):
        devs = jax.devices()
        self.track_device = track_device or devs[0]
        self.map_device = map_device or devs[min(1, len(devs) - 1)]
        super().__init__(cfg)
        self.ms = jax.device_put(self.ms, self.track_device)
        # in-flight mapping job: (ms_new_on_M, slot, frame_idx) or None
        self._map_job: Optional[Tuple[M.MapState, jnp.ndarray]] = None
        # retained per-frame tensors for potential KF promotion, keyed by
        # trajectory index (kept for PIPELINE_DEPTH+1 frames)
        self._retained = {}
        self._kf_fn = self._build_kf_fn()

    # -- device programs ----------------------------------------------------

    def _build_fused(self):
        """Tracking-only fused step (no kf branch): extraction + EKF +
        track core + keyframe DECISION (executed later on the map device)."""
        cam = self.cam
        cfg = self.cfg
        sf = cfg.orb.scale_factor
        nl = cfg.orb.n_levels
        aml = cfg.tracking.align_min_level
        kf_interval = max(3, cfg.tracking.max_frames // 10)
        depth_factor = float(cfg.tracking.depth_map_factor)
        core = self.extractor.core
        has_depth = self._HAS_DEPTH

        def step(ms, dst, img, depth_img, ts, mapping_enabled, imu_meas,
                 use_imu, th_radius):
            feats, pyramid, d, uright = core(
                img, depth_img if has_depth else None, depth_factor
            )
            dt = jnp.maximum(ts - dst.last_ts, 1e-4)
            ekf = dst.ekf
            gyro, accel = imu_meas[:3], imu_meas[3:6]
            ekf = ekf._replace(
                x=jnp.where(use_imu, ekf.x.at[3:6].set(gyro), ekf.x)
            )
            ekf, T_pred_cv = sensors.ekf_predict(ekf, dt)
            imu_s, T_pred_imu = sensors.imu_predict(dst.imu, dt)
            T_pred = jnp.where(use_imu & dst.imu.updated, T_pred_imu, T_pred_cv)
            out, _ = _track_core(
                cam, ms,
                feats.uv_und, feats.desc, feats.octave, feats.valid,
                uright, pyramid, dst.last_kf_slot, T_pred,
                scale_factor=sf, n_levels=nl, align_min_level=aml,
                th_radius=th_radius,
            )
            n_inl = out.n_inliers
            track_ok = n_inl >= 10
            healthy = n_inl >= 20
            free = jnp.any(~ms.kf_valid)
            fskf = dst.frames_since_kf
            decayed = n_inl.astype(jnp.float32) < 0.9 * dst.ref_kf_inliers.astype(
                jnp.float32
            )
            need_kf = (
                mapping_enabled & track_ok & healthy & free
                & (fskf >= 2) & (decayed | (fskf >= kf_interval))
            )
            T_report = jnp.where(track_ok, out.Tcw, ekf.last_pose)
            ekf = sensors.ekf_update(ekf, out.Tcw, dt, track_ok)
            imu_s = sensors.imu_update(
                imu_s, out.Tcw, gyro, accel, dt, track_ok & use_imu
            )
            dst2 = DeviceState(
                ekf=ekf,
                imu=imu_s,
                last_kf_slot=dst.last_kf_slot,
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
                            jnp.asarray(-1.0),  # slot assigned on map device
                            jnp.sum(ms.kf_valid).astype(jnp.float32),
                            jnp.sum(ms.pt_valid).astype(jnp.float32),
                        ]
                    ),
                ]
            )
            return (
                ms, dst2, packed, T_report, feats, pyramid, d, uright,
                out.assoc,
            )

        # placement follows the inputs (everything lives on track_device)
        return jax.jit(step, donate_argnums=(1,))

    def _build_kf_fn(self):
        cam = self.cam
        cfg = self.cfg
        sf = cfg.orb.scale_factor
        nl = cfg.orb.n_levels
        covis_min = cfg.map.covis_min_weight
        close_depth = self.close_depth if np.isfinite(self.close_depth) else 1e9

        def run(ms, Tcw, uv, uv_und, octave, angle, desc, kp_valid, d, uright,
                assoc, stored_pyr, frame_id, ts, parent):
            # the associations were tracked against an older snapshot: scrub
            # ids a since-completed mapping pass may have culled or replaced
            assoc = jnp.where(
                (assoc >= 0) & ms.pt_valid[jnp.clip(assoc, 0, ms.P - 1)],
                assoc, -1,
            )
            ms2, slot, _, _ = _kf_core(
                cam, ms, Tcw, uv, uv_und, octave, angle, desc, kp_valid,
                d, uright, assoc, stored_pyr, frame_id, ts, parent,
                jnp.asarray(close_depth, jnp.float32),
                scale_factor=sf, n_levels=nl, covis_min=covis_min,
            )
            return ms2, slot

        # placement follows the inputs (shipped to map_device by the caller)
        return jax.jit(run, donate_argnums=(0,))

    # -- host orchestration ---------------------------------------------------

    def _poll_map_job(self, block: bool = False):
        """If the in-flight mapping pass finished (or block=True), swap its
        refreshed map in as tracking's snapshot."""
        if self._map_job is None:
            return
        ms_new, slot = self._map_job
        if not block:
            try:
                if not ms_new.kf_Tcw.is_ready():
                    return
            except AttributeError:
                pass  # backend without is_ready: fall through and block
        slot_i = int(slot)  # sync on the (tiny) slot scalar
        self.ms = jax.device_put(ms_new, self.track_device)
        if self.dst is not None:
            self.dst = self.dst._replace(
                last_kf_slot=jnp.asarray(slot_i, jnp.int32)
            )
        self.st.last_kf_slot = slot_i
        self.kf_events.append(slot_i)
        self._map_job = None

    def _dispatch_kf(self, idx: int, pose: np.ndarray):
        """Promote retained frame `idx` to a keyframe on the map device."""
        if idx not in self._retained:
            return
        # only one mapping pass in flight (the reference's LocalMapping also
        # drains its queue one keyframe at a time); a still-running job means
        # this keyframe is skipped — the next decayed frame will retrigger
        if self._map_job is not None:
            self._poll_map_job()
            if self._map_job is not None:
                return
        feats, pyramid, d, uright, ts, assoc = self._retained[idx]
        dev = self.map_device
        put = functools.partial(jax.device_put, device=dev)
        stored = tuple(put(p) for p in pyramid[KF_STORE_MIN_LEVEL:])
        ms_m = jax.device_put(self.ms, dev)
        ms_new, slot = self._kf_fn(
            ms_m, put(jnp.asarray(pose)), put(feats.uv), put(feats.uv_und),
            put(feats.octave), put(feats.angle), put(feats.desc),
            put(feats.valid), put(d), put(uright),
            put(assoc), stored,
            put(jnp.asarray(idx, jnp.int32)), put(jnp.asarray(ts, jnp.float32)),
            put(jnp.asarray(self.st.last_kf_slot, jnp.int32)),
        )
        self._map_job = (ms_new, slot)

    def _drain_one(self):
        idx, packed = self._pending.pop(0)
        self._wait_ready(packed)
        p = np.asarray(packed)
        n_inl = int(p[PACK_INLIERS])
        pose = p[:16].reshape(4, 4)
        self.trajectory[idx] = pose
        self.st.T_last = pose
        if bool(p[PACK_NEED_KF]) and self.mapping_enabled:
            self._dispatch_kf(idx, pose)
        self._retained.pop(idx, None)
        if n_inl < 10:
            self._lost_streak += 1
            if self._lost_streak >= self.LOST_PATIENCE:
                self.st.status = "LOST"
        else:
            self._lost_streak = 0
            if self.st.status != "NOT_INITIALIZED":
                self.st.status = "OK"

    def track(self, img, depth_img, timestamp: float):
        self._poll_map_job()
        if self.st.status == "NOT_INITIALIZED":
            out = super().track(img, depth_img, timestamp)
            self.ms = jax.device_put(self.ms, self.track_device)
            return out
        if self.st.status == "LOST":
            self._poll_map_job(block=True)
            return self._relocalize_step(img, depth_img, timestamp)

        st = self.st
        img_d = jax.device_put(jnp.asarray(img), self.track_device)
        dep_d = (
            jax.device_put(jnp.asarray(depth_img), self.track_device)
            if self._HAS_DEPTH
            else img_d
        )
        th_radius = (
            self.TH_RADIUS_RELOC
            if st.frame_id < self._reloc_boost_until
            else self.TH_RADIUS
        )
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
        (self.ms, self.dst, packed, T_report, feats, pyramid, d, uright,
         assoc) = self._fused(
            self.ms, self.dst, img_d, dep_d,
            jnp.asarray(self._rel_ts(timestamp), jnp.float32),
            mapping_d, imu_d, use_imu_d, th_d,
        )
        self._use_imu = False
        try:
            packed.copy_to_host_async()
        except AttributeError:
            pass
        self.trajectory.append(T_report)
        self.timestamps.append(timestamp)
        idx = len(self.trajectory) - 1
        # a tracked frame might be promoted to a keyframe when its packed
        # result drains: retain its tensors (incl. the tracked keypoint ->
        # point associations the mapping pass binds) until then
        self._retained[idx] = (feats, pyramid, d, uright,
                               self._rel_ts(timestamp), assoc)
        self._pending.append((idx, packed))
        st.last_ts = timestamp
        st.frame_id += 1
        if len(self._pending) > self.PIPELINE_DEPTH:
            self._drain_one()
        return self.trajectory[idx]

    def flush(self):
        super().flush()
        self._poll_map_job(block=True)
