"""Local mapping: observation fusion, map-point culling, keyframe culling.

Array equivalents of the LocalMapping thread's map-maintenance passes
(/root/reference/src/LocalMapping.{h,cc}):

  fuse_neighbors     <- SearchInNeighbors (LocalMapping.cc:422-511) +
                        ORBmatcher::Fuse (ORBmatcher.cc:477-615): project map
                        points between a new keyframe and its covisible
                        neighbors, adding cross-observations and merging
                        duplicates.  This is what stiffens bundle adjustment:
                        without cross-links every keyframe's points are only
                        anchored to their creator and BA can drag the map.
  cull_points        <- MapPointCulling (LocalMapping.cc:161-188): drop
                        points with found-ratio < 0.25 or too few
                        observations shortly after creation.
  cull_keyframes     <- KeyFrameCulling (LocalMapping.cc:580-634): drop KFs
                        whose points are >= 90% observed by >= 3 other KFs at
                        the same or finer scale.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from sdslam_tpu.features import matching
from sdslam_tpu.geometry import camera as cam_mod
from sdslam_tpu.geometry import lie
from sdslam_tpu.geometry.camera import CameraModel
from sdslam_tpu.mapping import map_state as M
from sdslam_tpu.ops import hamming as ham


def _fuse_into_kf(
    cam: CameraModel,
    ms: M.MapState,
    kf_slot,
    q_pt_ids,  # [Q] point ids to project into this KF (-1 padded)
    scale_factor: float,
    obs_cnt=None,  # [P] observation counts (computed if None)
    radius: float = 3.0,
    th_desc: int = ham.TH_LOW,
    prefer_query: bool = False,
):
    """Project candidate points into one keyframe; bind matched keypoints.

    Returns (new kf_mp row [N], replace_map update [P] int32 with -1 default).
    A matched keypoint that is free gets the point; a matched keypoint that
    already holds a different point merges the two (fewer-observations loses,
    MapPoint::Replace semantics). With prefer_query=True the projected QUERY
    point always wins the merge — the Fuse(vpReplacePoint) loop variant
    (ORBmatcher.cc:617-732), where loop-side landmarks replace current-side
    duplicates unconditionally (LoopClosing::SearchAndFuse,
    LoopClosing.cc:535-557)."""
    P = ms.P
    q_safe = jnp.clip(q_pt_ids, 0, P - 1)
    q_ok = (q_pt_ids >= 0) & ms.pt_valid[q_safe]
    row = ms.kf_mp[kf_slot]
    # skip points already bound in this KF
    bound = jnp.zeros((P,), bool).at[jnp.where(row >= 0, row, P)].set(True, mode="drop")
    q_ok &= ~bound[q_safe]
    # dedupe query list (the same point may arrive from several neighbors)
    Q = q_pt_ids.shape[0]
    first = jnp.full((P,), Q, jnp.int32).at[jnp.where(q_ok, q_safe, P)].min(
        jnp.arange(Q, dtype=jnp.int32), mode="drop"
    )
    q_ok &= first[q_safe] == jnp.arange(Q)

    res = matching.search_by_projection(
        cam,
        ms.kf_Tcw[kf_slot],
        ms.pt_pos[q_safe],
        ms.pt_desc[q_safe],
        q_ok,
        jnp.zeros_like(q_safe),
        ms.kf_uv_und[kf_slot],
        ms.kf_desc[kf_slot],
        ms.kf_kp_valid[kf_slot],
        ms.kf_octave[kf_slot],
        radius_px=radius,
        th_desc=th_desc,
        scale_factor=scale_factor,
    )
    matched_pt = jnp.where(
        res.kp_to_query >= 0, q_pt_ids[jnp.clip(res.kp_to_query, 0, q_pt_ids.shape[0] - 1)], -1
    )  # [N] point id matched to each keypoint

    if obs_cnt is None:
        obs_cnt = M.point_obs_count(ms)
    free = (row < 0) & (matched_pt >= 0)
    new_row = jnp.where(free, matched_pt, row)

    # duplicate: keypoint already holds a different point -> merge
    dup = (row >= 0) & (matched_pt >= 0) & (row != matched_pt)
    a = jnp.clip(row, 0, P - 1)
    b = jnp.clip(matched_pt, 0, P - 1)
    if prefer_query:
        keep_row = jnp.zeros_like(dup)  # loop point replaces current point
    else:
        keep_row = obs_cnt[a] >= obs_cnt[b]
    loser = jnp.where(dup, jnp.where(keep_row, b, a), P)
    winner = jnp.where(dup, jnp.where(keep_row, a, b), -1)
    replace_map = jnp.full((P,), -1, jnp.int32).at[loser].set(winner, mode="drop")
    # if the matched point won, rebind the keypoint
    new_row = jnp.where(dup & (~keep_row), matched_pt, new_row)
    return new_row, replace_map


@functools.partial(jax.jit, static_argnames=("cam", "scale_factor", "n_neighbors"))
def fuse_neighbors(
    cam: CameraModel,
    ms: M.MapState,
    kf_slot,
    scale_factor: float = 2.0,
    n_neighbors: int = 3,
    covis=None,
    obs_cnt=None,  # [P] observer counts (derived from shared incidence)
) -> M.MapState:
    """SearchInNeighbors: two-way observation fusion between a keyframe and
    its top covisible neighbors.

    Shape: direction A is one projection search; direction B's
    per-neighbor searches are VMAPPED into a single batched search (they
    read the same pre-fuse map, so they are independent; the sequential
    variant spent 3x the kernel time for a rarely-different result). The
    per-neighbor merge bookkeeping stays sequential (cheap scatters)."""
    cov = M.covisibility(ms) if covis is None else covis
    w = cov[kf_slot].at[kf_slot].set(-1)
    _, neigh = jax.lax.top_k(w, n_neighbors)  # [C] best neighbor slots
    neigh_ok = jnp.take(w, neigh) > 0

    # direction A: neighbors' points -> this KF
    neigh_pts = ms.kf_mp[neigh].reshape(-1)  # [C*N]
    neigh_pts = jnp.where(jnp.repeat(neigh_ok, ms.N), neigh_pts, -1)
    if obs_cnt is None:
        obs_cnt = M.point_obs_count(ms)
    # dedupe against this KF happens inside _fuse_into_kf
    new_row, rep_a = _fuse_into_kf(
        cam, ms, kf_slot, neigh_pts, scale_factor, obs_cnt=obs_cnt
    )
    ms = ms._replace(kf_mp=ms.kf_mp.at[kf_slot].set(new_row))

    # direction B: this KF's points -> each neighbor, one batched search
    # (all three search the same post-A map: independent by construction).
    # Points direction A just merged away are redirected to their winners.
    own_raw = new_row
    own_win = rep_a[jnp.clip(own_raw, 0, ms.P - 1)]
    own_pts = jnp.where((own_raw >= 0) & (own_win >= 0), own_win, own_raw)
    rows_b, reps_b = jax.vmap(
        lambda s: _fuse_into_kf(
            cam, ms, s, own_pts, scale_factor, obs_cnt=obs_cnt
        )
    )(neigh)
    for i in range(n_neighbors):
        slot_i = neigh[i]
        row_i = jnp.where(neigh_ok[i], rows_b[i], ms.kf_mp[slot_i])
        ms = ms._replace(kf_mp=ms.kf_mp.at[slot_i].set(row_i))
    # compose all replace maps and apply ONCE (replace_points touches the
    # whole [K,N] table; 4 sequential applications dominated this pass).
    # With f'(p) = f(p) if f(p) >= 0 else p: total = bC' o ... o b1' o a'
    def compose(acc, rep_i):
        cur = jnp.where(acc >= 0, acc, jnp.arange(ms.P))
        nxt = rep_i[cur]
        return jnp.where(nxt >= 0, nxt, acc)

    total = rep_a
    for i in range(n_neighbors):
        rep_i = jnp.where(neigh_ok[i], reps_b[i], -1)
        total = compose(total, rep_i)
    # guard a->b->a tie cycles across maps: a self-replacement means "keep"
    total = jnp.where(total == jnp.arange(ms.P), -1, total)
    ms = M.replace_points(ms, total)
    return ms


@functools.partial(jax.jit, static_argnames=())
def cull_points(
    ms: M.MapState,
    min_found_ratio: float = 0.25,
    min_obs_after: int = 2,
    age_window: int = 2,
    obs_cnt=None,  # [P] observation counts (computed if None)
) -> M.MapState:
    """MapPointCulling: a recent point dies if its tracking found-ratio is
    below 0.25, or if it is older than `age_window` keyframes and still has
    fewer than min_obs_after observations (LocalMapping.cc:161-188)."""
    obs = M.point_obs_count(ms) if obs_cnt is None else obs_cnt
    age = ms.next_kf_id - ms.pt_first_kf  # in keyframes
    found_ratio = ms.pt_found.astype(jnp.float32) / jnp.maximum(
        ms.pt_visible.astype(jnp.float32), 1.0
    )
    young = age <= age_window + 1
    bad = (found_ratio < min_found_ratio) & (age >= 2)
    bad |= (age >= age_window) & (age <= age_window + 2) & (obs < min_obs_after)
    return M.remove_points(ms, ms.pt_valid & young & bad)


@functools.partial(jax.jit, static_argnames=("max_obs", "max_rows"))
def cull_keyframes(
    ms: M.MapState,
    protect_slot,
    redundancy: float = 0.9,
    max_obs: int = 16,
    obs_lists=None,  # optional precomputed (obs_kf, obs_kp) [P,M]
    rows_mask=None,  # [K] bool: candidate rows (default: all valid)
    max_rows: int = 16,
    covis=None,  # optional precomputed covisibility for re-parenting
) -> M.MapState:
    """KeyFrameCulling: mark a KF redundant when >= 90% of its observed
    points are seen by >= 3 other KFs at the same or finer octave
    (LocalMapping.cc:580-634). At most one KF is culled per call (the most
    redundant), keeping the spanning structure stable.

    Like the reference (which only examines the current KF's covisible
    locals, LocalMapping.cc:582), candidacy can be restricted to
    `rows_mask`, compacted to `max_rows` rows — the [K,N,M] redundancy
    gather over the whole pool was ~40% of this pass."""
    if obs_lists is None:
        obs_kf, obs_kp = M.build_obs_lists(ms, max_obs)
    else:
        obs_kf, obs_kp = obs_lists
    if rows_mask is None:
        rows_mask = ms.kf_valid
    # compact candidate rows (top covisible window)
    R = min(max_rows, ms.K)
    row_idx, row_in, _ = M.compact_indices(rows_mask & ms.kf_valid, R)
    kf_safe = jnp.clip(obs_kf, 0, ms.K - 1)
    kp_safe = jnp.clip(obs_kp, 0, ms.N - 1)
    oct_obs = ms.kf_octave[kf_safe, kp_safe]  # [P,M]
    # pack (kf, octave) so the [R,N,M] expansion is ONE gather
    pack_pm = jnp.where(
        obs_kf >= 0, (obs_kf + 1) * 16 + jnp.clip(oct_obs, 0, 15), 0
    )

    # for each candidate row r: over its bound keypoints, how many of its
    # points have >= 3 other observations at octave <= own octave + 1
    own_oct = ms.kf_octave[row_idx]  # [R,N]
    mp_r = ms.kf_mp[row_idx]  # [R,N]
    pt = jnp.clip(mp_r, 0, ms.P - 1)
    pt_has = (mp_r >= 0) & ms.kf_kp_valid[row_idx] & row_in[:, None]
    pk = pack_pm[pt]  # [R,N,M] single gather
    obs_kf_pn = pk // 16 - 1
    obs_oct_pn = pk % 16
    fine = (
        (obs_kf_pn >= 0)
        & (obs_kf_pn != row_idx[:, None, None])
        & (obs_oct_pn <= own_oct[:, :, None] + 1)
    )
    n_fine = jnp.sum(fine, axis=-1)  # [R,N]
    redundant_obs = pt_has & (n_fine >= 3)
    n_obs_kf = jnp.sum(pt_has, axis=1)
    ratio = jnp.sum(redundant_obs, axis=1) / jnp.maximum(n_obs_kf, 1)
    candidate = row_in & (ratio > redundancy) & (n_obs_kf > 0)
    candidate &= row_idx != protect_slot
    # never cull a loop-edge endpoint: the stored edge must keep entering
    # later essential-graph optimizations (the reference pins loop KFs with
    # SetNotErase, KeyFrame.cc:403-428 / LoopClosing.cc:231-238)
    is_loop_kf = jnp.zeros((ms.K + 1,), bool).at[
        jnp.where(ms.loop_edges >= 0, ms.loop_edges, ms.K).ravel()
    ].set(True, mode="drop")[: ms.K]
    candidate &= ~is_loop_kf[row_idx]
    # never cull the oldest (gauge anchor)
    oldest = jnp.argmin(jnp.where(ms.kf_valid, ms.kf_frame_id, jnp.iinfo(jnp.int32).max))
    candidate &= row_idx != oldest
    best = jnp.argmax(jnp.where(candidate, ratio, -1.0))
    kill_slot = jnp.where(jnp.any(candidate), row_idx[best], ms.K)
    kill = jnp.zeros((ms.K,), bool).at[kill_slot].set(True, mode="drop")
    return M.remove_keyframes(ms, kill, covis=covis)


def _fundamental_from_poses(cam: CameraModel, T1w, T2w):
    """F12 such that x2^T F12 x1 = 0 (ComputeF12, LocalMapping.cc:~470)."""
    # F maps image-1 points to epipolar lines in image 2: built from the
    # relative transform T21 = T2w * T1w^-1
    T21 = lie.mm(T2w, lie.se3_inv(T1w))
    R21 = T21[:3, :3]
    t21 = T21[:3, 3]
    K = cam.K
    Kinv = jnp.linalg.inv(K)
    E = lie.mm(lie.hat(t21), R21)
    return lie.mm(lie.mm(Kinv.T, E), Kinv)


@functools.partial(
    jax.jit,
    static_argnames=("cam", "scale_factor", "n_levels", "n_neighbors", "update_stats"),
)
def triangulate_new_points(
    cam: CameraModel,
    ms: M.MapState,
    kf_slot,
    scale_factor: float = 2.0,
    n_levels: int = 5,
    n_neighbors: int = 3,
    th_desc: int = ham.TH_LOW,
    covis=None,
    update_stats: bool = True,
) -> M.MapState:
    """Epipolar-search triangulation against covisible neighbors
    (CreateNewMapPoints, LocalMapping.cc:190-420): unbound keypoints of the
    new keyframe are matched along epipolar lines to unbound keypoints of
    each neighbor, DLT-triangulated, and gated by cheirality, parallax,
    reprojection and scale consistency.

    This is how a MONOCULAR map grows; RGB-D uses it in addition to direct
    depth spawning (far points beyond the depth range)."""
    from sdslam_tpu.solvers.initializer import triangulate_linear as dlt

    K_mat = cam.K
    cov = M.covisibility(ms) if covis is None else covis
    w = cov[kf_slot].at[kf_slot].set(-1)
    _, neigh = jax.lax.top_k(w, n_neighbors)
    neigh_ok_arr = jnp.take(w, neigh) > 0

    T1 = ms.kf_Tcw[kf_slot]
    uv1 = ms.kf_uv_und[kf_slot]
    d1 = ms.kf_desc[kf_slot]
    oct1 = ms.kf_octave[kf_slot]

    for i in range(n_neighbors):
        nb = neigh[i]
        T2 = ms.kf_Tcw[nb]
        # baseline vs scene depth gate (LocalMapping.cc:221-235)
        b = jnp.linalg.norm(lie.se3_t(lie.se3_inv(T1)) - lie.se3_t(lie.se3_inv(T2)))
        free1 = ms.kf_kp_valid[kf_slot] & (ms.kf_mp[kf_slot] < 0)
        free2 = ms.kf_kp_valid[nb] & (ms.kf_mp[nb] < 0)
        F12 = _fundamental_from_poses(cam, T1, T2)
        # epipolar distance of every candidate pair [N1, N2]
        ones = jnp.ones((ms.N, 1))
        p1h = jnp.concatenate([uv1, ones], -1)
        p2h = jnp.concatenate([ms.kf_uv_und[nb], ones], -1)
        lines2 = lie.mm(p1h, F12.T)  # line of kp1 in image 2
        num = jnp.abs(jnp.einsum("ni,mi->nm", lines2, p2h, precision=jax.lax.Precision.HIGHEST))  # [N1,N2]
        den = jnp.sqrt(
            jnp.maximum(lines2[:, 0] ** 2 + lines2[:, 1] ** 2, 1e-9)
        )[:, None]
        epi_d = num / den
        sigma2 = scale_factor ** (2.0 * ms.kf_octave[nb].astype(jnp.float32))
        mask = (
            free1[:, None]
            & free2[None, :]
            & (epi_d < 3.84 * jnp.sqrt(sigma2)[None, :])
        )
        dist = ham.masked_dist(d1, ms.kf_desc[nb], mask)
        dbest, jbest, d2nd = ham.best2(dist)
        okm = free1 & (dbest <= th_desc)
        j = jnp.clip(jbest, 0, ms.N - 1)

        # triangulate candidate pairs
        P1 = lie.mm(K_mat, T1[:3, :4])
        P2 = lie.mm(K_mat, T2[:3, :4])
        Xw = dlt(P1, P2, uv1, ms.kf_uv_und[nb][j])
        Xc1 = lie.se3_apply(T1, Xw)
        Xc2 = lie.se3_apply(T2, Xw)
        z1, z2 = Xc1[:, 2], Xc2[:, 2]
        # parallax
        O1 = lie.se3_t(lie.se3_inv(T1))
        O2 = lie.se3_t(lie.se3_inv(T2))
        r1 = Xw - O1
        r2 = Xw - O2
        cosp = jnp.sum(r1 * r2, -1) / jnp.maximum(
            jnp.linalg.norm(r1, axis=-1) * jnp.linalg.norm(r2, axis=-1), 1e-9
        )
        # reprojection gates
        u1 = cam.fx * Xc1[:, 0] / jnp.maximum(z1, 1e-9) + cam.cx
        v1 = cam.fy * Xc1[:, 1] / jnp.maximum(z1, 1e-9) + cam.cy
        u2 = cam.fx * Xc2[:, 0] / jnp.maximum(z2, 1e-9) + cam.cx
        v2 = cam.fy * Xc2[:, 1] / jnp.maximum(z2, 1e-9) + cam.cy
        e1 = (u1 - uv1[:, 0]) ** 2 + (v1 - uv1[:, 1]) ** 2
        e2 = (u2 - ms.kf_uv_und[nb][j, 0]) ** 2 + (v2 - ms.kf_uv_und[nb][j, 1]) ** 2
        s1 = scale_factor ** (2.0 * oct1.astype(jnp.float32))
        s2 = scale_factor ** (2.0 * ms.kf_octave[nb][j].astype(jnp.float32))
        good = (
            okm
            & neigh_ok_arr[i]
            & (z1 > 0.05)
            & (z2 > 0.05)
            & (cosp < 0.9998)
            & (e1 < 5.991 * s1)
            & (e2 < 5.991 * s2)
            & (b > 0.01)  # need real baseline
        )
        ms, ids = M.create_points(ms, kf_slot, good, Xw)
        # bind the neighbor-side observation too
        row = ms.kf_mp[nb]
        created = ids >= 0
        row = row.at[jnp.where(created, j, ms.N)].set(
            jnp.where(created, ids, -1), mode="drop"
        )
        ms = ms._replace(kf_mp=ms.kf_mp.at[nb].set(row))
    if update_stats:
        ms = M.finalize_point_statistics(ms, scale_factor, n_levels)
    return ms
