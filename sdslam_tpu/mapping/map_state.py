"""Array-resident SLAM map: fixed-capacity SoA pools + derived structures.

Array replacement for the reference's pointer-graph data model
(/root/reference/src/{Map,KeyFrame,MapPoint}.{h,cc}).  Design rules:

  * Fixed-capacity pools with validity masks (keyframes [K], points [P]);
    slots are reused after culling via cumsum-compaction allocation.
  * `kf_mp[K, N]` (keypoint -> point id, -1 none; the reference's
    mvpMapPoints, KeyFrame.h:150) is the SINGLE source of truth for the
    observation graph.  Per-point observation lists, observation counts,
    covisibility weights, spanning-tree candidates, normals/depth bands and
    representative descriptors are all *derived* batched computations — the
    reference's dual bookkeeping (MapPoint::mObservations + KeyFrame vectors,
    kept consistent by hand under 3 mutexes) collapses into segment ops.
  * Covisibility = one bf16 incidence matmul
    (counts[k1,k2] = #shared points), replacing KeyFrame::UpdateConnections
    (KeyFrame.cc:282-366) pointer walks.

All functions are pure MapState -> MapState; the host pipeline owns ordering.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from sdslam_tpu.geometry import lie
from sdslam_tpu.ops import hamming as ham


class MapState(NamedTuple):
    # --- keyframe pool [K, ...] ---
    kf_valid: jnp.ndarray  # [K] bool
    kf_Tcw: jnp.ndarray  # [K,4,4]
    kf_uv: jnp.ndarray  # [K,N,2] raw kp coords (level-0 scale)
    kf_uv_und: jnp.ndarray  # [K,N,2] undistorted
    kf_octave: jnp.ndarray  # [K,N] int32
    kf_angle: jnp.ndarray  # [K,N] float32
    kf_desc: jnp.ndarray  # [K,N,8] uint32
    kf_kp_valid: jnp.ndarray  # [K,N] bool
    kf_depth: jnp.ndarray  # [K,N] float32 (-1 none)
    kf_uright: jnp.ndarray  # [K,N] float32 (-1 none)
    kf_mp: jnp.ndarray  # [K,N] int32 keypoint -> point id (-1)
    kf_frame_id: jnp.ndarray  # [K] int32
    kf_timestamp: jnp.ndarray  # [K] float32
    kf_parent: jnp.ndarray  # [K] int32 spanning-tree parent (-1 root)
    kf_pyramid: Tuple[jnp.ndarray, ...]  # per level: [K, H_l, W_l] float32

    # --- persistent loop edges [L,2] int32 slot pairs, -1 padded ---
    # (KeyFrame::AddLoopEdge, KeyFrame.cc:401: every accepted loop closure
    # is remembered and re-enters every later essential-graph optimization,
    # Optimizer.cc:853-874)
    loop_edges: jnp.ndarray

    # --- point pool [P, ...] ---
    pt_valid: jnp.ndarray  # [P] bool
    pt_pos: jnp.ndarray  # [P,3]
    pt_desc: jnp.ndarray  # [P,8] uint32 representative descriptor
    pt_normal: jnp.ndarray  # [P,3] mean viewing direction
    pt_min_dist: jnp.ndarray  # [P]
    pt_max_dist: jnp.ndarray  # [P]
    pt_ref_kf: jnp.ndarray  # [P] int32
    pt_first_kf: jnp.ndarray  # [P] int32 (kf counter at creation, for culling)
    pt_visible: jnp.ndarray  # [P] int32 tracking visibility counter
    pt_found: jnp.ndarray  # [P] int32 tracking found counter

    # --- counters (monotonic ids, scalar int32) ---
    next_kf_id: jnp.ndarray  # total KFs ever created
    next_pt_id: jnp.ndarray  # total points ever created

    @property
    def K(self) -> int:
        return self.kf_valid.shape[0]

    @property
    def P(self) -> int:
        return self.pt_valid.shape[0]

    @property
    def N(self) -> int:
        return self.kf_mp.shape[1]

    def n_keyframes(self):
        return jnp.sum(self.kf_valid)

    def n_points(self):
        return jnp.sum(self.pt_valid)


def init_map(
    max_keyframes: int,
    max_points: int,
    max_kps: int,
    pyramid_shapes: Tuple[Tuple[int, int], ...],
    max_loop_edges: int = 32,
) -> MapState:
    K, P, N = max_keyframes, max_points, max_kps
    return MapState(
        loop_edges=jnp.full((max_loop_edges, 2), -1, jnp.int32),
        kf_valid=jnp.zeros((K,), bool),
        kf_Tcw=jnp.tile(jnp.eye(4, dtype=jnp.float32), (K, 1, 1)),
        kf_uv=jnp.zeros((K, N, 2), jnp.float32),
        kf_uv_und=jnp.zeros((K, N, 2), jnp.float32),
        kf_octave=jnp.zeros((K, N), jnp.int32),
        kf_angle=jnp.zeros((K, N), jnp.float32),
        kf_desc=jnp.zeros((K, N, 8), jnp.uint32),
        kf_kp_valid=jnp.zeros((K, N), bool),
        kf_depth=jnp.full((K, N), -1.0, jnp.float32),
        kf_uright=jnp.full((K, N), -1.0, jnp.float32),
        kf_mp=jnp.full((K, N), -1, jnp.int32),
        kf_frame_id=jnp.zeros((K,), jnp.int32),
        kf_timestamp=jnp.zeros((K,), jnp.float32),
        kf_parent=jnp.full((K,), -1, jnp.int32),
        kf_pyramid=tuple(
            jnp.zeros((K, h, w), jnp.float32) for (h, w) in pyramid_shapes
        ),
        pt_valid=jnp.zeros((P,), bool),
        pt_pos=jnp.zeros((P, 3), jnp.float32),
        pt_desc=jnp.zeros((P, 8), jnp.uint32),
        pt_normal=jnp.zeros((P, 3), jnp.float32),
        pt_min_dist=jnp.zeros((P,), jnp.float32),
        pt_max_dist=jnp.full((P,), 1e9, jnp.float32),
        pt_ref_kf=jnp.full((P,), -1, jnp.int32),
        pt_first_kf=jnp.full((P,), -1, jnp.int32),
        pt_visible=jnp.ones((P,), jnp.int32),
        pt_found=jnp.ones((P,), jnp.int32),
        next_kf_id=jnp.asarray(0, jnp.int32),
        next_pt_id=jnp.asarray(0, jnp.int32),
    )


# ---------------------------------------------------------------------------
# slot allocation
# ---------------------------------------------------------------------------

def allocate_slots(valid, want):
    """Assign the i-th wanted item to the i-th free slot.

    valid: [S] current occupancy; want: [M] bool request mask.
    Returns slots [M] int32 (-1 if pool exhausted or not wanted).
    """
    free_rank = jnp.cumsum(~valid) - 1  # rank of each free slot
    n_free = jnp.sum(~valid)
    S = valid.shape[0]
    # slot_of_rank[r] = index of r-th free slot; occupied slots scatter to
    # index S which is out of bounds and dropped (NEVER use -1 here: jax
    # scatter wraps negative indices)
    slot_of_rank = jnp.full((S,), -1, jnp.int32)
    slot_of_rank = slot_of_rank.at[jnp.where(~valid, free_rank, S)].set(
        jnp.arange(S, dtype=jnp.int32), mode="drop"
    )
    want_rank = jnp.cumsum(want) - 1
    ok = want & (want_rank < n_free)
    slots = jnp.where(ok, slot_of_rank[jnp.clip(want_rank, 0, S - 1)], -1)
    return slots.astype(jnp.int32)


# ---------------------------------------------------------------------------
# derived structures
# ---------------------------------------------------------------------------

def observation_table(ms: MapState):
    """Flattened observation table: for each (kf, kp) slot, the observed
    point id (-1 when none). Only valid KFs contribute."""
    obs = jnp.where(
        ms.kf_valid[:, None] & ms.kf_kp_valid & (ms.kf_mp >= 0), ms.kf_mp, -1
    )
    return obs  # [K,N]


def incidence_matrix(ms: MapState, dtype=jnp.bfloat16):
    """[K,P] 0/1 incidence: KF k observes point p."""
    obs = observation_table(ms)
    K, N = obs.shape
    inc = jnp.zeros((K, ms.P), dtype)
    rows = jnp.broadcast_to(jnp.arange(K)[:, None], (K, N))
    inc = inc.at[rows.ravel(), jnp.clip(obs, 0, ms.P - 1).ravel()].max(
        jnp.where(obs >= 0, 1, 0).astype(dtype).ravel(), mode="drop"
    )
    return inc


def covisibility(ms: MapState, inc=None):
    """[K,K] int32 shared-observation counts (diagonal zeroed).

    One matmul over the incidence matrix — the array form of
    KeyFrame::UpdateConnections. Pass a precomputed `inc` to share the
    [K*N]-element incidence scatter (the single biggest fixed cost of every
    consumer) across the derived
    structures of one mapping pass."""
    if inc is None:
        inc = incidence_matrix(ms)
    counts = jnp.dot(inc, inc.T, preferred_element_type=jnp.float32)
    counts = counts.astype(jnp.int32)
    counts = counts * (1 - jnp.eye(ms.K, dtype=jnp.int32))
    mask = ms.kf_valid
    return counts * (mask[:, None] & mask[None, :])


def point_obs_count(ms: MapState):
    """[P] number of keyframes observing each point.

    Per observing KEYFRAME (duplicate bindings within one row dedup to 1),
    matching MapPoint::Observations() (/root/reference/src/MapPoint.h:41-150
    — the observation map is keyed by KeyFrame*). Derived from the incidence
    matrix so standalone callers (culling thresholds, merge arbitration in
    loop_closing.fuse_loop_points) use the SAME semantics as the fused KF
    pass, which passes point_obs_count_from_inc explicitly — winner
    selection must not depend on the call site (r4 advisor finding)."""
    return point_obs_count_from_inc(ms, incidence_matrix(ms))


def point_obs_count_from_inc(ms: MapState, inc):
    """[P] observer counts derived from a precomputed incidence matrix:
    one dense [K,P] column reduction instead of a [K*N]-element scatter.
    Counts are per observing KEYFRAME (duplicate bindings within one row
    dedup to 1) — the semantics every consumer (merge arbitration, culling
    thresholds) actually wants."""
    cnt = jnp.sum(inc.astype(jnp.float32), axis=0).astype(jnp.int32)
    return cnt * ms.pt_valid


def obs_lists_from_table(obs, P: int, max_obs: int = 16):
    """Per-point observation lists from an observation table.

    obs: [R, N] point id per (row, keypoint) slot, -1 when none (rows are
    keyframes, possibly a compacted subset). Returns (obs_row [P,M],
    obs_kp [P,M]) int32, -1 padded.

    Fully parallel rank-scatter: the rank of observation (row r, point p) is
    the exclusive row-cumsum of a [R, P] incidence-count matrix — one
    scatter-add + one small cumsum + one scatter, no sequential loop and no
    [R*N] sort (a previous R-step fori_loop serialized ~R scatter rounds). Within-row duplicate
    bindings of one point (possible after fuse) keep only the first keypoint
    — benign for every consumer (they are edges of the same point).
    """
    R, N = obs.shape
    M = max_obs
    ok = obs >= 0
    ps = jnp.clip(obs, 0, P - 1)
    rows = jnp.broadcast_to(jnp.arange(R, dtype=jnp.int32)[:, None], (R, N))
    kps = jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32)[None, :], (R, N))
    # first keypoint of each (row, point) pair: scatter-min of kp index.
    # This ONE scatter also yields the incidence (first_kp < N): every
    # table op here is packed to run once.
    first_kp = jnp.full((R, P), N, jnp.int32).at[
        rows.ravel(), jnp.where(ok, ps, 0).ravel()
    ].min(jnp.where(ok, kps, N).ravel(), mode="drop")
    inc = (first_kp < N).astype(jnp.int32)  # 0/1 post-dedupe
    # rank of row r's observation of p = #observations of p in rows < r;
    # pack (rank, first_kp) so the table is gathered ONCE
    rank_rp = jnp.cumsum(inc, axis=0) - inc  # exclusive cumsum over rows
    packed_tab = rank_rp * (N + 1) + first_kp
    packed = packed_tab[rows, ps]  # [R,N] single gather
    rank = packed // (N + 1)
    keep = ok & (packed % (N + 1) == kps)
    fits = keep & (rank < M)
    tgt_p = jnp.where(fits, ps, P)
    rk = jnp.clip(rank, 0, M - 1)
    # pack (row, kp) into one value -> ONE output scatter, decode after
    val = rows * N + kps
    packed_out = jnp.full((P, M), -1, jnp.int32).at[
        tgt_p.ravel(), rk.ravel()
    ].set(val.ravel(), mode="drop")
    has = packed_out >= 0
    obs_row = jnp.where(has, packed_out // N, -1)
    obs_kp = jnp.where(has, packed_out % N, -1)
    return obs_row, obs_kp


def build_obs_lists(ms: MapState, max_obs: int = 16):
    """Derived per-point observation lists (obs_kf [P,M], obs_kp [P,M]),
    -1 padded. Replaces MapPoint::mObservations (MapPoint.h:60-66) as an
    on-demand structure."""
    return obs_lists_from_table(observation_table(ms), ms.P, max_obs)


def compact_indices(mask, L: int):
    """O(P) cumsum compaction of a boolean mask into L slots (cheaper than
    a top_k sort at pool size). Returns
    (idx [L] original ids (clipped), in_mask [L], remap [P] -> compact or -1).
    Entries beyond L are dropped (callers treat overflow as
    handled-next-pass)."""
    P = mask.shape[0]
    pos = jnp.cumsum(mask.astype(jnp.int32)) - 1  # compact slot per entry
    fits = mask & (pos < L)
    tgt = jnp.where(fits, pos, L)
    idx = jnp.full((L,), P - 1, jnp.int32).at[tgt].set(
        jnp.arange(P, dtype=jnp.int32), mode="drop"
    )
    n = jnp.minimum(jnp.sum(mask.astype(jnp.int32)), L)
    in_mask = jnp.arange(L) < n
    remap = jnp.full((P,), -1, jnp.int32)
    remap = remap.at[jnp.where(fits, jnp.arange(P), P)].set(
        pos.astype(jnp.int32), mode="drop"
    )
    return idx, in_mask, remap


def update_point_statistics(ms: MapState, max_obs: int = 16) -> MapState:
    """Recompute representative descriptors, normals and scale bands for all
    valid points from current observations.

    Replaces MapPoint::ComputeDistinctiveDescriptors (min median Hamming,
    MapPoint.cc:225-284) and UpdateNormalAndDepth (MapPoint.cc:304-343) —
    batched over the whole pool instead of per-point loops.
    """
    obs_kf, obs_kp = build_obs_lists(ms, max_obs)
    return _point_stats_core(ms, obs_kf, obs_kp, ms.pt_pos, max_obs)


def finalize_point_statistics_local(
    ms: MapState,
    rows_mask,
    scale_factor: float,
    n_levels: int,
    max_pts: int = 2048,
    max_obs: int = 16,
    obs_lists=None,  # optional precomputed (obs_kf, obs_kp) [P,M]
    touched=None,  # optional precomputed [P] bool touched-point mask
) -> MapState:
    """finalize_point_statistics restricted to the points observed by the
    keyframe rows in `rows_mask` [K] — the only points whose observations or
    positions a keyframe mapping pass can change. The O(P*M^2) median-
    descriptor/normal recompute runs on a [max_pts] compacted subset instead
    of the whole pool (the reference likewise updates only modified points,
    MapPoint.cc:225-343). Overflowing points keep their previous (valid,
    slightly stale) statistics.

    With `obs_lists` (shared full-pool per-point lists), the per-subset
    lists are just a row gather — building them per consumer was ~3 ms per
    KF pass. Entries whose KF has since been culled are masked inside
    _point_stats_core (kf_valid check)."""
    P = ms.P
    obs = observation_table(ms)  # [K,N]
    if touched is None:
        sel = rows_mask[:, None] & (obs >= 0)
        touched = jnp.zeros((P,), bool)
        touched = touched.at[jnp.where(sel, jnp.clip(obs, 0, P - 1), P)].set(
            True, mode="drop"
        )
    touched = touched & ms.pt_valid
    PL = min(max_pts, P)
    pt_idx, pt_in, pt_remap = compact_indices(touched, PL)
    if obs_lists is None:
        # full table remapped to compact ids: a touched point's observations
        # from rows OUTSIDE rows_mask still count toward its statistics
        obs_c = jnp.where(obs >= 0, pt_remap[jnp.clip(obs, 0, P - 1)], -1)
        obs_row, obs_kp = obs_lists_from_table(obs_c, PL, max_obs)
    else:
        obs_row, obs_kp = (a[pt_idx] for a in obs_lists)
    rep_desc, normal, ref_dist, ref_oct, cnt = _point_stats_core(
        ms, obs_row, obs_kp, ms.pt_pos[pt_idx], max_obs
    )
    has = (cnt > 0) & pt_in
    level_scale = scale_factor**ref_oct
    max_dist = ref_dist * level_scale
    min_dist = max_dist / (scale_factor ** (n_levels - 1))
    tgt = jnp.where(has, pt_idx, P)
    return ms._replace(
        pt_desc=ms.pt_desc.at[tgt].set(rep_desc, mode="drop"),
        pt_normal=ms.pt_normal.at[tgt].set(normal, mode="drop"),
        pt_min_dist=ms.pt_min_dist.at[tgt].set(min_dist, mode="drop"),
        pt_max_dist=ms.pt_max_dist.at[tgt].set(max_dist, mode="drop"),
    )


def _point_stats_core(ms: MapState, obs_kf, obs_kp, pt_pos, max_obs: int = 16):
    """Stats for an arbitrary point subset given its observation lists.

    obs_kf/obs_kp: [Q, M] (-1 padded, rows = original KF indices);
    pt_pos: [Q, 3]. Returns (rep_desc, normal, ref_dist, ref_oct, cnt)."""
    M = max_obs
    kf_safe = jnp.clip(obs_kf, 0, ms.K - 1)
    kp_safe = jnp.clip(obs_kp, 0, ms.N - 1)
    # mask entries whose KF has been culled since the lists were built
    has = (obs_kf >= 0) & ms.kf_valid[kf_safe]  # [P,M]

    # gather observation descriptors [P,M,8]
    descs = ms.kf_desc[kf_safe, kp_safe]
    # pairwise Hamming [P,M,M]
    x = jnp.bitwise_xor(descs[:, :, None, :], descs[:, None, :, :])
    d = jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)
    pair_ok = has[:, :, None] & has[:, None, :]
    d = jnp.where(pair_ok, d, ham.BIG)
    # median distance of each obs to the others ~= sorted row middle
    cnt = jnp.sum(has, axis=1)  # [P]
    d_sorted = jnp.sort(d, axis=-1)  # invalid BIG at end
    med_idx = jnp.clip(cnt // 2, 0, M - 1)
    med = jnp.take_along_axis(
        d_sorted, med_idx[:, None, None].repeat(M, 1), axis=-1
    )[..., 0]
    med = jnp.where(has, med, ham.BIG)
    best = jnp.argmin(med, axis=1)  # [P]
    rep_desc = jnp.take_along_axis(descs, best[:, None, None].repeat(8, -1), 1)[:, 0]

    # normals: mean direction from KF centers to point
    Twc = lie.se3_inv(ms.kf_Tcw)  # [K,4,4]
    centers = lie.se3_t(Twc)  # [K,3]
    cen = centers[kf_safe]  # [P,M,3]
    vec = pt_pos[:, None, :] - cen
    dist = jnp.linalg.norm(vec, axis=-1)
    dirn = vec / jnp.maximum(dist[..., None], 1e-9)
    nsum = jnp.sum(jnp.where(has[..., None], dirn, 0.0), axis=1)
    normal = nsum / jnp.maximum(jnp.linalg.norm(nsum, axis=-1, keepdims=True), 1e-9)

    # scale band from the reference observation (use best-descriptor obs)
    ref_kf = jnp.take_along_axis(kf_safe, best[:, None], 1)[:, 0]
    ref_kp = jnp.take_along_axis(kp_safe, best[:, None], 1)[:, 0]
    ref_dist = jnp.linalg.norm(pt_pos - centers[ref_kf], axis=-1)
    ref_oct = ms.kf_octave[ref_kf, ref_kp].astype(jnp.float32)
    return rep_desc, normal, ref_dist, ref_oct, cnt


def finalize_point_statistics(
    ms: MapState, scale_factor: float, n_levels: int, max_obs: int = 16
) -> MapState:
    """Apply update_point_statistics results into the state."""
    rep_desc, normal, ref_dist, ref_oct, cnt = update_point_statistics(ms, max_obs)
    has_obs = (cnt > 0) & ms.pt_valid
    level_scale = scale_factor**ref_oct
    max_dist = ref_dist * level_scale
    min_dist = max_dist / (scale_factor ** (n_levels - 1))
    return ms._replace(
        pt_desc=jnp.where(has_obs[:, None], rep_desc, ms.pt_desc),
        pt_normal=jnp.where(has_obs[:, None], normal, ms.pt_normal),
        pt_min_dist=jnp.where(has_obs, min_dist, ms.pt_min_dist),
        pt_max_dist=jnp.where(has_obs, max_dist, ms.pt_max_dist),
    )


# ---------------------------------------------------------------------------
# mutation ops
# ---------------------------------------------------------------------------

def insert_keyframe(
    ms: MapState,
    slot,  # int32 scalar: target KF slot (from allocate_slots)
    Tcw,
    uv,
    uv_und,
    octave,
    angle,
    desc,
    kp_valid,
    depth,
    uright,
    mp_assoc,  # [N] int32 keypoint -> existing point id (-1)
    pyramid: Tuple[jnp.ndarray, ...],
    frame_id,
    timestamp,
    parent,
) -> MapState:
    s = slot
    new_pyr = tuple(
        pool.at[s].set(img) for pool, img in zip(ms.kf_pyramid, pyramid)
    )
    return ms._replace(
        kf_valid=ms.kf_valid.at[s].set(True),
        kf_Tcw=ms.kf_Tcw.at[s].set(Tcw),
        kf_uv=ms.kf_uv.at[s].set(uv),
        kf_uv_und=ms.kf_uv_und.at[s].set(uv_und),
        kf_octave=ms.kf_octave.at[s].set(octave),
        kf_angle=ms.kf_angle.at[s].set(angle),
        kf_desc=ms.kf_desc.at[s].set(desc),
        kf_kp_valid=ms.kf_kp_valid.at[s].set(kp_valid),
        kf_depth=ms.kf_depth.at[s].set(depth),
        kf_uright=ms.kf_uright.at[s].set(uright),
        kf_mp=ms.kf_mp.at[s].set(mp_assoc),
        kf_frame_id=ms.kf_frame_id.at[s].set(frame_id),
        kf_timestamp=ms.kf_timestamp.at[s].set(timestamp),
        kf_parent=ms.kf_parent.at[s].set(parent),
        kf_pyramid=new_pyr,
        next_kf_id=ms.next_kf_id + 1,
    )


def create_points(
    ms: MapState,
    kf_slot,  # scalar int32: owning keyframe
    want,  # [N] bool: keypoints that should spawn a new point
    pos_w,  # [N,3] world positions for those keypoints
) -> Tuple[MapState, jnp.ndarray]:
    """Create new map points bound to keypoints of kf_slot.

    Returns (new_ms, point_ids [N] int32 with -1 where not created)."""
    slots = allocate_slots(ms.pt_valid, want)  # [N]
    ok = slots >= 0
    # out-of-bounds sentinel P for rejected entries -> dropped by scatter
    sl = jnp.where(ok, slots, ms.P)
    desc = ms.kf_desc[kf_slot]
    ms = ms._replace(
        pt_valid=ms.pt_valid.at[sl].set(True, mode="drop"),
        pt_pos=ms.pt_pos.at[sl].set(pos_w, mode="drop"),
        pt_desc=ms.pt_desc.at[sl].set(desc, mode="drop"),
        pt_ref_kf=ms.pt_ref_kf.at[sl].set(kf_slot, mode="drop"),
        pt_first_kf=ms.pt_first_kf.at[sl].set(ms.next_kf_id, mode="drop"),
        pt_visible=ms.pt_visible.at[sl].set(1, mode="drop"),
        pt_found=ms.pt_found.at[sl].set(1, mode="drop"),
        next_pt_id=ms.next_pt_id + jnp.sum(ok),
    )
    # bind into the keyframe's association row
    row = ms.kf_mp[kf_slot]
    row = jnp.where(ok, slots, row)
    ms = ms._replace(kf_mp=ms.kf_mp.at[kf_slot].set(row))
    return ms, jnp.where(ok, slots, -1)


def remove_points(ms: MapState, kill_mask) -> MapState:
    """Invalidate points and scrub them from every keyframe row."""
    pt_valid = ms.pt_valid & (~kill_mask)
    obs_alive = pt_valid[jnp.clip(ms.kf_mp, 0, ms.P - 1)] & (ms.kf_mp >= 0)
    return ms._replace(pt_valid=pt_valid, kf_mp=jnp.where(obs_alive, ms.kf_mp, -1))


def remove_keyframes(ms: MapState, kill_mask, covis=None) -> MapState:
    """Invalidate keyframes, preserving graph consistency:

      * children of a culled KF are re-parented (KeyFrame::SetBadFlag
        reassigns children over the candidate graph, KeyFrame.cc:430-508):
        the new parent is the child's most-covisible SURVIVING keyframe
        with a strictly earlier frame id (earlier-id parents keep the
        spanning structure acyclic by construction — the reference gets
        the same invariant from its insertion-ordered candidate growth),
        falling back to the culled KF's own parent;
      * points whose reference KF is culled are re-anchored to their
        earliest surviving observer (MapPoint::SetBadFlag analogue —
        pt_ref_kf drives loop-correction re-anchoring so it must stay
        alive);
      * persistent loop edges touching a culled KF are dropped (the
        reference instead refuses to erase loop keyframes — callers here
        additionally protect loop-edge endpoints in KeyFrameCulling).
    """
    K = ms.K
    valid_new = ms.kf_valid & (~kill_mask)
    if covis is None:
        covis = covisibility(ms)
    par = ms.kf_parent
    par_safe = jnp.clip(par, 0, K - 1)
    orphan = valid_new & (par >= 0) & kill_mask[par_safe]
    fid = ms.kf_frame_id
    earlier = fid[None, :] < fid[:, None]  # [child, cand]
    w = jnp.where(valid_new[None, :] & earlier, covis, -1)
    best = jnp.argmax(w, axis=1).astype(jnp.int32)
    has_best = jnp.take_along_axis(w, best[:, None], 1)[:, 0] > 0
    grandpa = par[par_safe]  # culled parent's own parent
    gp_ok = (grandpa >= 0) & valid_new[jnp.clip(grandpa, 0, K - 1)]
    new_par = jnp.where(has_best, best, jnp.where(gp_ok, grandpa, -1))
    kf_parent = jnp.where(orphan, new_par, par)

    # re-anchor points referencing a culled KF to their earliest survivor
    obs = jnp.where(
        valid_new[:, None] & ms.kf_kp_valid & (ms.kf_mp >= 0), ms.kf_mp, -1
    )
    rows = jnp.broadcast_to(jnp.arange(K, dtype=jnp.int32)[:, None], obs.shape)
    first_kf = jnp.full((ms.P,), K, jnp.int32).at[
        jnp.where(obs >= 0, obs, ms.P).ravel()
    ].min(rows.ravel(), mode="drop")
    ref_dead = ms.pt_valid & kill_mask[jnp.clip(ms.pt_ref_kf, 0, K - 1)] & (
        ms.pt_ref_kf >= 0
    )
    pt_ref_kf = jnp.where(
        ref_dead, jnp.where(first_kf < K, first_kf, -1), ms.pt_ref_kf
    )

    le = ms.loop_edges
    le_dead = (le < 0) | kill_mask[jnp.clip(le, 0, K - 1)]
    loop_edges = jnp.where(jnp.any(le_dead, axis=1)[:, None], -1, le)

    return ms._replace(
        kf_valid=valid_new,
        kf_mp=jnp.where(kill_mask[:, None], -1, ms.kf_mp),
        kf_parent=kf_parent,
        pt_ref_kf=pt_ref_kf,
        loop_edges=loop_edges,
    )


def add_loop_edge(ms: MapState, i, j) -> MapState:
    """Record a persistent loop edge (KeyFrame::AddLoopEdge,
    KeyFrame.cc:401). Silently drops the edge if the fixed-capacity store
    is full (callers log: the capacity covers dozens of loop closures)."""
    free = ms.loop_edges[:, 0] < 0
    slot = jnp.argmax(free)  # first free row
    slot = jnp.where(jnp.any(free), slot, ms.loop_edges.shape[0])
    pair = jnp.stack([jnp.asarray(i, jnp.int32), jnp.asarray(j, jnp.int32)])
    return ms._replace(
        loop_edges=ms.loop_edges.at[slot].set(pair, mode="drop")
    )


def replace_points(ms: MapState, replace_map) -> MapState:
    """Fuse: redirect every observation of point a to replace_map[a] (>=0),
    then invalidate the replaced points (MapPoint::Replace semantics,
    MapPoint.cc:169-202). Duplicate (kf, point) bindings that may result are
    left in place; matching/BA treat them as independent edges of the same
    point which is benign.

    The redirect and the liveness scrub are folded into ONE per-point code
    array gathered once at the [K,N] table (the redirect-then-remove
    formulation paid two ~65k-element arbitrary gathers)."""
    P = ms.P
    idx = jnp.arange(P, dtype=jnp.int32)
    killed = replace_map >= 0
    pt_valid = ms.pt_valid & (~killed)
    final = jnp.where(killed, replace_map, idx)
    # a winner that is itself dead (merge chain tail) yields -1, exactly as
    # the two-pass formulation's liveness scrub did
    code = jnp.where(pt_valid[jnp.clip(final, 0, P - 1)], final, -1)
    new_mp = jnp.where(
        ms.kf_mp >= 0, code[jnp.clip(ms.kf_mp, 0, P - 1)], ms.kf_mp
    )
    return ms._replace(pt_valid=pt_valid, kf_mp=new_mp)


def update_tracking_counters(ms: MapState, cam, Tcw, assoc) -> MapState:
    """Bump per-point visible/found counters (MapPoint::IncreaseVisible /
    IncreaseFound, driven by Tracking) — evaluated at keyframe cadence:
    visible = inside the frustum of this pose, found = associated to a
    keypoint. Feeds MapPointCulling's found-ratio."""
    from sdslam_tpu.geometry import camera as cam_mod

    Xc = lie.se3_apply(Tcw, ms.pt_pos)
    uv, z = cam_mod.project(cam, Xc)
    visible = ms.pt_valid & (z > 0.05) & cam_mod.in_image(cam, uv, 5.0)
    found = jnp.zeros((ms.P,), bool).at[
        jnp.where(assoc >= 0, assoc, ms.P)
    ].set(True, mode="drop")
    return ms._replace(
        pt_visible=ms.pt_visible + visible.astype(jnp.int32),
        pt_found=ms.pt_found + (found & ms.pt_valid).astype(jnp.int32),
    )
