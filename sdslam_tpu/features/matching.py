"""Geometric descriptor-matching routines (ORBmatcher equivalents).

Each routine is a dense masked computation over fixed-capacity arrays:
project -> geometric gating mask -> masked Hamming matrix -> per-query best
-> per-target conflict resolution -> rotation-consistency filter.  This is
the array form of the reference's 9 windowed searches
(/root/reference/src/ORBmatcher.cc: SearchByProjection x4, Fuse x2,
SearchForInitialization, SearchForTriangulation, SearchByPoints).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from sdslam_tpu.geometry import camera as cam_mod
from sdslam_tpu.geometry import lie
from sdslam_tpu.geometry.camera import CameraModel
from sdslam_tpu.ops import hamming as ham


class MatchResult(NamedTuple):
    """Assignment target-keypoint -> query index (-1 = unmatched)."""

    kp_to_query: jnp.ndarray  # [N] int32
    kp_dist: jnp.ndarray  # [N] int32 (BIG where unmatched)

    @property
    def matched(self):
        return self.kp_to_query >= 0

    def count(self):
        return jnp.sum(self.matched)


def window_match(
    uv_proj,  # [Q,2] projected query positions (undistorted pixel coords)
    q_desc,  # [Q,8] uint32
    q_valid,  # [Q] bool
    kp_uv,  # [N,2] keypoint undistorted coords
    kp_desc,  # [N,8]
    kp_valid,  # [N] bool
    radius,  # [Q] or scalar: search window half-size in px
    th_desc: int,
    q_octave=None,  # [Q] predicted octave
    kp_octave=None,  # [N]
    octave_window: Optional[Tuple[int, int]] = None,  # (lo_off, hi_off)
    ratio: Optional[float] = None,  # best < ratio * second-best
    q_angle=None,  # [Q] source keypoint angles for rotation consistency
    kp_angle=None,  # [N]
    use_rotation: bool = False,
) -> MatchResult:
    """Core windowed projection match; all reference search routines reduce
    to this with different gating parameters."""
    Q = q_desc.shape[0]
    N = kp_desc.shape[0]
    radius = jnp.broadcast_to(jnp.asarray(radius, jnp.float32), (Q,))

    du = jnp.abs(uv_proj[:, None, 0] - kp_uv[None, :, 0])
    dv = jnp.abs(uv_proj[:, None, 1] - kp_uv[None, :, 1])
    mask = (du <= radius[:, None]) & (dv <= radius[:, None])
    mask &= q_valid[:, None] & kp_valid[None, :]
    if octave_window is not None and q_octave is not None and kp_octave is not None:
        lo, hi = octave_window
        mask &= (kp_octave[None, :] >= q_octave[:, None] + lo) & (
            kp_octave[None, :] <= q_octave[:, None] + hi
        )

    dist = ham.masked_dist(q_desc, kp_desc, mask)
    d1, j1, d2 = ham.best2(dist)
    ok = q_valid & (d1 <= th_desc)
    if ratio is not None:
        ok &= d1.astype(jnp.float32) < ratio * d2.astype(jnp.float32)
    kp_to_q, kp_d = ham.resolve_to_targets(j1, d1, ok, N)

    if use_rotation and q_angle is not None and kp_angle is not None:
        matched = kp_to_q >= 0
        qa = q_angle[jnp.clip(kp_to_q, 0, Q - 1)]
        dtheta = qa - kp_angle
        keep = ham.rotation_consistency(dtheta, matched)
        kp_to_q = jnp.where(keep, kp_to_q, -1)
        kp_d = jnp.where(keep, kp_d, ham.BIG)
    return MatchResult(kp_to_q, kp_d)


def search_by_projection(
    cam: CameraModel,
    Tcw,
    q_pos_w,  # [Q,3] world positions of query map points
    q_desc,
    q_valid,
    q_octave,
    kp_uv,
    kp_desc,
    kp_valid,
    kp_octave,
    radius_px: float,
    th_desc: int = ham.TH_HIGH,
    scale_factor: float = 2.0,
    octave_window: Tuple[int, int] = (-1, 1),
    q_angle=None,
    kp_angle=None,
    use_rotation: bool = False,
    border: float = 5.0,
) -> MatchResult:
    """Project world points into the frame and window-match.

    Covers SearchByProjection(Frame, LastFrame/KeyFrame)
    (ORBmatcher.cc:946-1075, 1077-1207): window scaled by the query point's
    octave, octave gate [oct-1, oct+1].
    """
    Xc = lie.se3_apply(Tcw, q_pos_w)
    uv, z = cam_mod.project(cam, Xc)
    vis = q_valid & (z > 0.05) & cam_mod.in_image(cam, uv, border)
    radius = radius_px * scale_factor ** q_octave.astype(jnp.float32)
    return window_match(
        uv,
        q_desc,
        vis,
        kp_uv,
        kp_desc,
        kp_valid,
        radius,
        th_desc,
        q_octave=q_octave,
        kp_octave=kp_octave,
        octave_window=octave_window,
        q_angle=q_angle,
        kp_angle=kp_angle,
        use_rotation=use_rotation,
    )


def predict_octave(dist, max_dist, scale_factor: float, n_levels: int):
    """MapPoint::PredictScale (/root/reference/src/MapPoint.cc:355-383):
    octave from the ratio of max scale-invariance distance to current
    distance."""
    ratio = jnp.maximum(max_dist / jnp.maximum(dist, 1e-6), 1.0)
    lvl = jnp.ceil(jnp.log(ratio) / jnp.log(scale_factor)).astype(jnp.int32)
    return jnp.clip(lvl, 0, n_levels - 1)


def search_local_points(
    cam: CameraModel,
    Tcw,
    p_pos_w,  # [P,3]
    p_desc,
    p_valid,
    p_normal,  # [P,3] mean viewing direction
    p_min_dist,  # [P]
    p_max_dist,  # [P]
    kp_uv,
    kp_desc,
    kp_valid,
    kp_octave,
    th_radius: float,
    scale_factor: float,
    n_levels: int,
    th_desc: int = ham.TH_HIGH,
    ratio: float = 0.8,
    view_cos_limit: float = 0.5,
) -> MatchResult:
    """TrackLocalMap search: frustum + view-angle + scale-band gating then
    windowed match (Frame::isInFrustum Frame.cc:215-269 +
    ORBmatcher::SearchByProjection ORBmatcher.cc:43-119)."""
    Xc = lie.se3_apply(Tcw, p_pos_w)
    uv, z = cam_mod.project(cam, Xc)
    Twc = lie.se3_inv(Tcw)
    PO = p_pos_w - lie.se3_t(Twc)[None, :]
    dist = jnp.linalg.norm(PO, axis=-1)
    view_cos = jnp.sum(PO * p_normal, axis=-1) / jnp.maximum(dist, 1e-6)
    vis = (
        p_valid
        & (z > 0.05)
        & cam_mod.in_image(cam, uv, 5.0)
        & (dist >= p_min_dist * 0.8)
        & (dist <= p_max_dist * 1.2)
        & (view_cos > view_cos_limit)
    )
    oct_pred = predict_octave(dist, p_max_dist, scale_factor, n_levels)
    # RadiusByViewingCos (ORBmatcher.cc:121-127): tighter window head-on
    r = jnp.where(view_cos > 0.998, 2.5, 4.0) * th_radius
    radius = r * scale_factor ** oct_pred.astype(jnp.float32)
    return window_match(
        uv,
        p_desc,
        vis,
        kp_uv,
        kp_desc,
        kp_valid,
        radius,
        th_desc,
        q_octave=oct_pred,
        kp_octave=kp_octave,
        octave_window=(-1, 1),
        ratio=ratio,
    )


def search_for_initialization(
    f1_uv,
    f1_desc,
    f1_valid,
    f1_octave,
    f1_angle,
    f2_uv,
    f2_desc,
    f2_valid,
    f2_octave,
    f2_angle,
    window: float = 100.0,
    th_desc: int = ham.TH_LOW,
    ratio: float = 0.9,
) -> MatchResult:
    """Monocular-initialization window search around identical coordinates,
    level-0 keypoints only (ORBmatcher::SearchForInitialization,
    ORBmatcher.cc:256-357). Returns f2-kp -> f1-kp assignment."""
    v1 = f1_valid & (f1_octave == 0)
    v2 = f2_valid & (f2_octave == 0)
    return window_match(
        f1_uv,
        f1_desc,
        v1,
        f2_uv,
        f2_desc,
        v2,
        window,
        th_desc,
        ratio=ratio,
        q_angle=f1_angle,
        kp_angle=f2_angle,
        use_rotation=True,
    )


def search_by_sim3(
    cam: CameraModel,
    S12,  # [4,4] Sim3 mapping cam-2 coordinates into cam-1
    uv1,  # [N,2] KF1 keypoint coords (undistorted)
    desc1,
    valid1,  # [N] bool: keypoint bound to a map point
    oct1,
    X1c,  # [N,3] bound map-point positions in KF1 camera frame
    uv2,
    desc2,
    valid2,
    oct2,
    X2c,
    radius_px: float = 7.5,
    th_desc: int = ham.TH_HIGH,
    scale_factor: float = 2.0,
) -> MatchResult:
    """Mutual Sim3-guided matching between two keyframes' bound map points
    (ORBmatcher::SearchBySim3, ORBmatcher.cc:734-944): project each KF's
    points into the other image through the candidate Sim3, window-match in
    both directions, and keep only mutually-agreeing pairs.

    Returns KF2-keypoint -> KF1-keypoint assignment (same layout as the
    brute-force loop matcher, so results merge directly)."""
    S21 = lie.sim3_inv(S12)
    # direction A: KF2 points into image 1 (targets = KF1 keypoints)
    X2_in1 = lie.sim3_apply(S12, X2c)
    uvA, zA = cam_mod.project(cam, X2_in1)
    visA = valid2 & (zA > 0.05) & cam_mod.in_image(cam, uvA, 5.0)
    radA = radius_px * scale_factor ** oct2.astype(jnp.float32)
    rA = window_match(
        uvA, desc2, visA, uv1, desc1, valid1, radA, th_desc,
        q_octave=oct2, kp_octave=oct1, octave_window=(-1, 1),
    )
    # direction B: KF1 points into image 2 (targets = KF2 keypoints)
    X1_in2 = lie.sim3_apply(S21, X1c)
    uvB, zB = cam_mod.project(cam, X1_in2)
    visB = valid1 & (zB > 0.05) & cam_mod.in_image(cam, uvB, 5.0)
    radB = radius_px * scale_factor ** oct1.astype(jnp.float32)
    rB = window_match(
        uvB, desc1, visB, uv2, desc2, valid2, radB, th_desc,
        q_octave=oct1, kp_octave=oct2, octave_window=(-1, 1),
    )
    # mutual agreement (ORBmatcher.cc:920-940): kp2 i -> kp1 j survives only
    # if direction A also assigned kp1 j -> kp2 i
    N1 = desc1.shape[0]
    j = rB.kp_to_query
    agree = (j >= 0) & (
        rA.kp_to_query[jnp.clip(j, 0, N1 - 1)] == jnp.arange(desc2.shape[0])
    )
    return MatchResult(
        jnp.where(agree, j, -1), jnp.where(agree, rB.kp_dist, ham.BIG)
    )


def search_brute_force(
    q_desc,
    q_valid,
    t_desc,
    t_valid,
    th_desc: int = ham.TH_LOW,
    ratio: float = 0.75,
    mutual: bool = True,
) -> MatchResult:
    """Brute-force descriptor matching (SearchByPoints, ORBmatcher.cc:1209-1304,
    the no-BoW loop-candidate matcher). Returns target -> query assignment."""
    mask = q_valid[:, None] & t_valid[None, :]
    dist = ham.masked_dist(q_desc, t_desc, mask)
    d1, j1, d2 = ham.best2(dist)
    ok = q_valid & (d1 <= th_desc)
    if ratio is not None:
        ok &= d1.astype(jnp.float32) < ratio * d2.astype(jnp.float32)
    if mutual:
        # target-side best must point back
        i1 = jnp.argmin(dist, axis=0)
        ok &= i1[j1] == jnp.arange(q_desc.shape[0])
    return MatchResult(*ham.resolve_to_targets(j1, d1, ok, t_desc.shape[0]))
