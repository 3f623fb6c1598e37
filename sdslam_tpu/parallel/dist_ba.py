"""Distributed bundle adjustment over a device mesh.

The replacement for the reference's absent distributed layer
(SURVEY.md §2.9): landmarks + observation blocks are sharded across devices
(axis "dp"); each device computes the Schur contributions of its point
shard; the reduced camera system S [6K,6K] and gradient are combined with
one psum (an NCCL all-reduce over NVLink between the cards of a host);
the dense Cholesky solve is replicated (it is tiny
relative to the edge work); landmark back-substitution stays fully local to
each shard.  This is the BASELINE.json north-star recipe: "distributed BA
via Schur-reduced camera systems with psum of the reduced normal equations".

Communication per iteration: one psum of [6K*6K + 6K] floats (K=256 ->
9.4 MB) — independent of the number of points, so scaling over points is
near-linear until the collective dominates.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sdslam_tpu.geometry import lie
from sdslam_tpu.geometry.camera import CameraModel
from sdslam_tpu.solvers import ba as ba_mod


def make_distributed_gn_step(mesh: Mesh, cam: CameraModel, K: int,
                             scale_factor: float = 2.0,
                             use_huber: bool = True,
                             lm_lambda: float = 1e-4):
    """Build a jitted one-iteration distributed GN step.

    Sharding: point-indexed arrays over mesh axis 'dp'; camera arrays
    replicated. Returns a function
      step(kf_Tcw, pt_pos, obs_kf, obs_kp, obs_ok, kf_uv_und, kf_uright,
           kf_octave, cam_active, pt_active) -> (kf_Tcw', pt_pos')

    The per-shard edge pass IS ba._schur_terms — the same flat-[E]
    edge-level assembly as single-device BA; its contract is exactly the
    distributed split: (S0, bs, cost) are plain sums over edges (psum'd
    here), while (Hpp_inv, W_pm, ybp = Hpp^-1 bp) and the edge one-hot
    Uflat are point-local and never leave the shard."""

    def step_local(kf_Tcw, pt_pos, obs_kf, obs_kp, obs_ok, kf_uv_und,
                   kf_uright, kf_octave, cam_active, pt_active):
        es = ba_mod._prep_edges(
            obs_kf, obs_kp, kf_uv_und, kf_uright, kf_octave, scale_factor, K
        )
        S0, bs, Hpp_inv, W_pm, ybp, _cost, Uflat = ba_mod._schur_terms(
            cam, kf_Tcw, pt_pos, es, obs_ok, cam_active, pt_active,
            use_huber, lm_lambda,
        )
        # combine the reduced camera system across devices; the damping prior
        # scales with the GLOBAL diagonal trace, so it applies post-psum
        S0 = jax.lax.psum(S0, "dp")
        bs = jax.lax.psum(bs, "dp")
        dc = ba_mod._apply_prior_and_solve(S0, bs, cam_active, lm_lambda, K)
        # local landmark back-substitution on this shard
        dp = ba_mod._back_substitute(dc, Uflat, W_pm, Hpp_inv, ybp, pt_active)
        kf_Tcw_new = jnp.where(
            cam_active[:, None, None], lie.mm(lie.se3_exp(dc), kf_Tcw), kf_Tcw
        )
        return kf_Tcw_new, pt_pos + dp

    pt_sharded = P("dp")
    rep = P()
    step = jax.shard_map(
        step_local,
        mesh=mesh,
        in_specs=(rep, pt_sharded, pt_sharded, pt_sharded, pt_sharded,
                  rep, rep, rep, rep, pt_sharded),
        out_specs=(rep, pt_sharded),
        check_vma=False,
    )
    return jax.jit(step)


def distributed_bundle_adjust(mesh: Mesh, cam: CameraModel, ms, cam_active,
                              pt_active, iters: int = 10,
                              scale_factor: float = 2.0, max_obs: int = 8):
    """Full distributed BA over a MapState (host-callable convenience)."""
    from sdslam_tpu.mapping import map_state as M

    obs_kf, obs_kp = M.build_obs_lists(ms, max_obs)
    obs_ok = obs_kf >= 0
    n_obs = jnp.sum(obs_ok, axis=1)
    ur = ms.kf_uright[jnp.clip(obs_kf, 0, ms.K - 1), jnp.clip(obs_kp, 0, ms.N - 1)]
    n_stereo = jnp.sum(obs_ok & (ur >= 0), axis=1)
    pt_act = pt_active & ms.pt_valid & ((n_obs >= 2) | (n_stereo >= 1))
    obs_ok = obs_ok & pt_act[:, None]
    cam_act = cam_active & ms.kf_valid

    # global arrays: process-spanning when the mesh spans hosts (each
    # process contributes only its own devices' shards), plain device_put
    # otherwise (parallel/multihost.py)
    from sdslam_tpu.parallel.multihost import global_put

    step = make_distributed_gn_step(mesh, cam, ms.K, scale_factor)
    kf_Tcw = global_put(mesh, ms.kf_Tcw, P())
    pt_pos = global_put(mesh, ms.pt_pos, P("dp"))
    obs_kf = global_put(mesh, obs_kf, P("dp"))
    obs_kp = global_put(mesh, obs_kp, P("dp"))
    obs_ok = global_put(mesh, obs_ok, P("dp"))
    pt_act = global_put(mesh, pt_act, P("dp"))
    uv_r = global_put(mesh, ms.kf_uv_und, P())
    ur_r = global_put(mesh, ms.kf_uright, P())
    oct_r = global_put(mesh, ms.kf_octave, P())
    ca_r = global_put(mesh, cam_act, P())
    for _ in range(iters):
        kf_Tcw, pt_pos = step(
            kf_Tcw, pt_pos, obs_kf, obs_kp, obs_ok, uv_r, ur_r, oct_r,
            ca_r, pt_act,
        )
    return ms._replace(kf_Tcw=kf_Tcw, pt_pos=pt_pos)
