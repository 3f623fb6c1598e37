"""Distributed global alignment scans: relocalization & loop detection
sharded over a device mesh.

The reference's recovery/loop paths are O(N_KF) sequential scans on one CPU
thread (Tracking::Relocalization, Tracking.cc:1064-1097; LoopClosing::
DetectLoop, LoopClosing.cc:100-222). The single-device build already
turns them into one vmapped batch (pipeline/relocalization.py,
pipeline/loop_closing.py); this module is the multi-chip form the SURVEY's
"long-context" analog calls for (SURVEY.md §5): KEYFRAMES ARE THE SEQUENCE
— the keyframe pool (poses, stored pyramids, keypoints) is sharded over
mesh axis 'dp', every device aligns the query frame against its keyframe
shard, and one argmin-combine across devices (NCCL over NVLink) picks
the winner.

Communication: the query pyramid is replicated (~300 KB); the combine is a
psum-style min over [K] error vectors — a few KB. Scaling over the pool is
near-linear: each device does K/n_dev alignments.

Verification (matching + pose GN on the few best candidates) stays
single-device: it needs the point pool and is O(n_verify), not O(K).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sdslam_tpu.geometry import camera as cam_mod
from sdslam_tpu.geometry.camera import CameraModel
from sdslam_tpu.mapping import map_state as M
from sdslam_tpu.solvers import image_align


def _align_shard(
    cam, kf_uv, kf_uv_und, kf_depth, kf_mp, kf_kp_valid, kf_valid,
    pyr_shard: Tuple[jnp.ndarray, ...],  # per level: [K_loc, H, W]
    cur_sub: Tuple[jnp.ndarray, ...],
    scale_factor, n_levels, store_min_level, min_level, iters,
):
    """Align the query against every keyframe of this shard (vmapped)."""

    def align_one(i):
        valid = kf_kp_valid[i] & (kf_depth[i] > 0) & (kf_mp[i] >= 0)
        X_ref = cam_mod.backproject(
            cam, kf_uv_und[i], jnp.maximum(kf_depth[i], 1e-3)
        )
        pyr_ref = tuple(pl[i] for pl in pyr_shard)
        res = image_align.align(
            pyr_ref, cur_sub, kf_uv[i], X_ref, valid, jnp.eye(4),
            cam.fx, cam.fy, cam.cx, cam.cy,
            scale_factor=scale_factor, max_level=n_levels - 1,
            min_level=min_level, iters=iters, start_level=store_min_level,
        )
        # vacuous alignments (no alignable points) must not look "perfect"
        return res.T_cur_ref, jnp.where(res.n_meas >= 50, res.error, jnp.inf)

    K_loc = kf_valid.shape[0]
    T_rels, errors = jax.vmap(align_one)(jnp.arange(K_loc))
    errors = jnp.where(kf_valid, errors, jnp.inf)
    return T_rels, errors


def distributed_align_scan(
    mesh: Mesh,
    cam: CameraModel,
    ms: M.MapState,
    pyr_cur: Tuple[jnp.ndarray, ...],
    scale_factor: float = 2.0,
    n_levels: int = 5,
    store_min_level: int = 2,
    min_level: int | None = None,
    iters: int = 15,
):
    """Photometric alignment of the query frame against EVERY keyframe,
    sharded over mesh axis 'dp'. Returns (T_rels [K,4,4], errors [K]) in
    original slot order (gathered — both are small).

    The keyframe pool arrays are placed with their leading (slot) axis
    sharded; K must be divisible by the mesh size (pools are sized in
    powers of two).
    """
    if min_level is None:
        min_level = n_levels - 2
    n_dev = mesh.devices.size
    K = ms.K
    assert K % n_dev == 0, "keyframe pool must divide the mesh"
    cur_sub = tuple(pyr_cur[store_min_level:])

    shard = NamedSharding(mesh, P("dp"))
    rep = NamedSharding(mesh, P())
    put_s = functools.partial(jax.device_put, device=shard)
    put_r = functools.partial(jax.device_put, device=rep)

    kf_uv = put_s(ms.kf_uv)
    kf_uv_und = put_s(ms.kf_uv_und)
    kf_depth = put_s(ms.kf_depth)
    kf_mp = put_s(ms.kf_mp)
    kf_kp_valid = put_s(ms.kf_kp_valid)
    kf_valid = put_s(ms.kf_valid)
    pyr = tuple(put_s(pl) for pl in ms.kf_pyramid)
    cur = tuple(put_r(c) for c in cur_sub)

    @jax.jit
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P("dp"), P("dp"), P("dp"), P("dp"), P("dp"), P("dp"),
            tuple(P("dp") for _ in pyr),
            tuple(P() for _ in cur),
        ),
        out_specs=(P("dp"), P("dp")),
        check_vma=False,  # constants (identity seed) enter the while carry
    )
    def scan(kf_uv, kf_uv_und, kf_depth, kf_mp, kf_kp_valid, kf_valid,
             pyr_shard, cur_rep):
        return _align_shard(
            cam, kf_uv, kf_uv_und, kf_depth, kf_mp, kf_kp_valid, kf_valid,
            pyr_shard, cur_rep,
            scale_factor, n_levels, store_min_level, min_level, iters,
        )

    T_rels, errors = scan(
        kf_uv, kf_uv_und, kf_depth, kf_mp, kf_kp_valid, kf_valid, pyr, cur
    )
    # gather to host-addressable replicated arrays (tiny)
    return jax.device_put(T_rels, rep), jax.device_put(errors, rep)
