"""Relocalization: recover a lost camera against the whole keyframe pool.

Reference behavior (Tracking::Relocalization, Tracking.cc:1064-1097): iterate
keyframes newest->oldest, run fast direct image alignment (100 points,
early-exit error > 0.01, ImageAlign.cc:106-164), then projection matching
(>= 20 matches) and pose optimization (>= 10 inliers).

Shape: the O(N_KF) sequential scan becomes ONE batched alignment —
vmap the coarse-level aligner over every valid keyframe simultaneously, rank
candidates by photometric error, then verify the best few with matching +
pose GN. No vocabulary (the reference dropped DBoW2; so do we).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from sdslam_tpu.features import matching
from sdslam_tpu.geometry import camera as cam_mod
from sdslam_tpu.geometry import lie
from sdslam_tpu.geometry.camera import CameraModel
from sdslam_tpu.mapping import map_state as M
from sdslam_tpu.ops import hamming as ham
from sdslam_tpu.solvers import epnp, image_align, pose_opt

RELOC_ALIGN_MAX_ERROR = 0.01  # fast-mode accept threshold (ImageAlign.cc:36-39)


class RelocResult(NamedTuple):
    success: jnp.ndarray  # bool scalar
    Tcw: jnp.ndarray  # [4,4]
    assoc: jnp.ndarray  # [N] keypoint -> point id
    n_inliers: jnp.ndarray
    best_kf: jnp.ndarray  # int32 slot of the matched keyframe
    align_errors: jnp.ndarray  # [K] per-keyframe photometric errors


@functools.partial(
    jax.jit,
    static_argnames=("cam", "scale_factor", "n_levels", "store_min_level", "n_verify"),
)
def relocalize(
    cam: CameraModel,
    ms: M.MapState,
    uv_und,  # current frame keypoints (undistorted)
    desc,
    octave,
    kp_valid,
    uright,
    pyr_cur: Tuple[jnp.ndarray, ...],  # full pyramid of the current frame
    key=None,  # PRNG key for the EPnP-RANSAC fallback
    scale_factor: float = 2.0,
    n_levels: int = 5,
    store_min_level: int = 2,
    n_verify: int = 3,
) -> RelocResult:
    """Batched alignment against every keyframe, then verify top candidates.

    Two-stage verification per candidate:
      1. photometric: coarse align seeds projection matching + pose GN
         (the reference's only path, Tracking.cc:1064-1097);
      2. geometric fallback: brute-force descriptor matching against the
         keyframe's bound map points + vmapped EPnP-RANSAC + pose GN —
         the reference's PnPsolver capability (PnPsolver.cc:445, dead code
         there) made live per SURVEY.md §2.3. It recovers when photometric
         alignment diverges (large viewpoint change / in-plane rotation:
         alignment is seeded at the keyframe pose and has a narrow basin,
         while ORB descriptors are rotation-invariant).
    The photometric result wins when both succeed (tighter radius)."""
    if key is None:
        key = jax.random.key(0)
    K = ms.K
    cur_sub = tuple(pyr_cur[store_min_level:])

    def align_one(slot):
        ref_uv = ms.kf_uv[slot]
        ref_depth = ms.kf_depth[slot]
        valid = ms.kf_kp_valid[slot] & (ref_depth > 0) & (ms.kf_mp[slot] >= 0)
        X_ref = cam_mod.backproject(
            cam, ms.kf_uv_und[slot], jnp.maximum(ref_depth, 1e-3)
        )
        pyr_ref = tuple(pl[slot] for pl in ms.kf_pyramid)
        res = image_align.align(
            pyr_ref,
            cur_sub,
            ref_uv,
            X_ref,
            valid,
            jnp.eye(4),  # seed: same pose as the keyframe (Tracking.cc:1073)
            cam.fx,
            cam.fy,
            cam.cx,
            cam.cy,
            scale_factor=scale_factor,
            max_level=n_levels - 1,
            min_level=n_levels - 2,  # coarse-only fast mode
            iters=15,
            start_level=store_min_level,
        )
        # a keyframe with (almost) no alignable points yields a vacuous
        # 0/0 -> 0 "perfect" error; it must rank LAST, not first
        err = jnp.where(res.n_meas >= 50, res.error, jnp.inf)
        return res.T_cur_ref, err

    T_rels, errors = jax.vmap(align_one)(jnp.arange(K))
    errors = jnp.where(ms.kf_valid, errors, jnp.inf)

    # verify the best n_verify candidates with matching + pose optimization
    order = jnp.argsort(errors)[:n_verify]

    inv_sigma2 = 1.0 / scale_factor ** (2.0 * octave.astype(jnp.float32))

    def verify_one(slot):
        T_init = lie.mm(T_rels[slot], ms.kf_Tcw[slot])
        q_pt = ms.kf_mp[slot]
        q_ok = (q_pt >= 0) & ms.pt_valid[jnp.clip(q_pt, 0, ms.P - 1)]
        res = matching.search_by_projection(
            cam,
            T_init,
            ms.pt_pos[jnp.clip(q_pt, 0, ms.P - 1)],
            ms.pt_desc[jnp.clip(q_pt, 0, ms.P - 1)],
            q_ok,
            jnp.zeros_like(q_pt),
            uv_und,
            desc,
            kp_valid,
            octave,
            radius_px=8.0,
            th_desc=ham.TH_HIGH,
            scale_factor=scale_factor,
        )
        assoc = jnp.where(
            res.kp_to_query >= 0, q_pt[jnp.clip(res.kp_to_query, 0, ms.N - 1)], -1
        )
        n_matches = jnp.sum(assoc >= 0)
        opt = pose_opt.optimize_pose(
            cam,
            T_init,
            ms.pt_pos[jnp.clip(assoc, 0, ms.P - 1)],
            uv_und,
            inv_sigma2,
            assoc >= 0,
            ur_obs=uright,
            rounds=4,
        )
        # ORBdist second chance (the reference's relocalization matcher
        # variant, ORBmatcher.cc:1306-1421 / Tracking.cc:1064-1097 context):
        # when the first GN keeps < 50 inliers, search AGAIN from the
        # refined pose with a wider window (th=10) and the relaxed
        # ORBdist=100 descriptor gate, excluding keypoints/points already
        # matched, then re-optimize over the merged set. Computed
        # branchlessly and selected by jnp.where (reloc is rare; an extra
        # masked pass is cheaper than a lax.cond's second trace).
        assoc1 = jnp.where((assoc >= 0) & opt.inliers, assoc, -1)
        used_pt = jnp.zeros((ms.P,), bool).at[
            jnp.where(assoc1 >= 0, assoc1, ms.P)
        ].set(True, mode="drop")
        q_ok2 = q_ok & ~used_pt[jnp.clip(q_pt, 0, ms.P - 1)]
        res2 = matching.search_by_projection(
            cam,
            opt.Tcw,
            ms.pt_pos[jnp.clip(q_pt, 0, ms.P - 1)],
            ms.pt_desc[jnp.clip(q_pt, 0, ms.P - 1)],
            q_ok2,
            ms.kf_octave[slot],
            uv_und,
            desc,
            kp_valid & (assoc1 < 0),
            octave,
            radius_px=10.0,
            th_desc=100,  # ORBdist (ORBmatcher.cc:1310)
            scale_factor=scale_factor,
        )
        extra = jnp.where(
            res2.kp_to_query >= 0,
            q_pt[jnp.clip(res2.kp_to_query, 0, ms.N - 1)], -1,
        )
        merged = jnp.where(assoc1 >= 0, assoc1, extra)
        opt2 = pose_opt.optimize_pose(
            cam,
            opt.Tcw,
            ms.pt_pos[jnp.clip(merged, 0, ms.P - 1)],
            uv_und,
            inv_sigma2,
            merged >= 0,
            ur_obs=uright,
            rounds=2,
        )
        retry = opt.n_inliers < 50
        n_inl = jnp.where(retry, opt2.n_inliers, opt.n_inliers)
        Tcw = jnp.where(retry, opt2.Tcw, opt.Tcw)
        final = jnp.where(
            retry,
            jnp.where((merged >= 0) & opt2.inliers, merged, -1),
            jnp.where((assoc >= 0) & opt.inliers, assoc, -1),
        )
        ok = (n_matches >= 20) & (n_inl >= 10) & (
            errors[slot] < RELOC_ALIGN_MAX_ERROR * 3
        )
        return ok, Tcw, final, n_inl

    oks, Ts, assocs, inls = jax.vmap(verify_one)(order)
    # pick the verified candidate with most inliers
    score = jnp.where(oks, inls, -1)
    best = jnp.argmax(score)
    align_success = score[best] > 0

    # --- EPnP-RANSAC geometric fallback over the same candidates ---
    def epnp_one(slot, k):
        row = ms.kf_mp[slot]
        v_kf = (
            ms.kf_kp_valid[slot]
            & (row >= 0)
            & ms.pt_valid[jnp.clip(row, 0, ms.P - 1)]
        )
        res = matching.search_brute_force(
            ms.kf_desc[slot], v_kf, desc, kp_valid,
            th_desc=ham.TH_LOW, ratio=0.75,
        )
        m = res.kp_to_query  # current-frame kp -> keyframe kp
        pt = jnp.where(m >= 0, row[jnp.clip(m, 0, ms.N - 1)], -1)
        ok = (pt >= 0) & kp_valid
        Xw = ms.pt_pos[jnp.clip(pt, 0, ms.P - 1)]
        pr = epnp.ransac_epnp(cam, Xw, uv_und, ok, k, n_hypotheses=64)
        T0 = lie.se3_from_Rt(pr.R, pr.t)
        opt = pose_opt.optimize_pose(
            cam, T0, Xw, uv_und, inv_sigma2, ok & pr.inliers,
            ur_obs=uright, rounds=4,
        )
        good = pr.success & (opt.n_inliers >= 10)
        final = jnp.where(ok & pr.inliers & opt.inliers, pt, -1)
        return good, opt.Tcw, final, opt.n_inliers

    keys = jax.random.split(key, order.shape[0])
    e_oks, e_Ts, e_assocs, e_inls = jax.vmap(epnp_one)(order, keys)
    e_score = jnp.where(e_oks, e_inls, -1)
    e_best = jnp.argmax(e_score)
    epnp_success = e_score[e_best] > 0

    use_align = align_success
    pick = jnp.where(use_align, best, e_best)
    return RelocResult(
        success=align_success | epnp_success,
        Tcw=jnp.where(use_align, Ts[best], e_Ts[e_best]),
        assoc=jnp.where(use_align, assocs[best], e_assocs[e_best]),
        n_inliers=jnp.where(use_align, inls[best], e_inls[e_best]),
        best_kf=order[pick],
        align_errors=errors,
    )
