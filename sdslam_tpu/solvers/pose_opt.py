"""Pose-only Gauss-Newton on reprojection residuals.

Replaces Optimizer::PoseOptimization (/root/reference/src/Optimizer.cc:221-415):
a single SE3 vertex with unary mono (2D) / stereo (3D: u, v, u_right) edges,
4 rounds x 10 iterations with chi2 inlier/outlier reclassification between
rounds, Huber robust kernel dropped from round 3 on, per-octave information
weighting (inv_sigma2 = 1/scale^(2*octave)).

Design: all edges live in fixed [N] arrays with masks; a round is a
lax.fori_loop of GN steps on an accumulated 6x6 system (one einsum), rounds
are a static unrolled loop; outliers are reclassified by masking, never by
resizing — so one compiled program serves every frame. On a CUDA device the
whole solve is one Pallas kernel with the same math.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from sdslam_tpu.geometry import lie
from sdslam_tpu.geometry.camera import CameraModel
from sdslam_tpu.ops.pallas import pose_kernel as pk

CHI2_MONO = 5.991  # 95% chi2 with 2 dof (Optimizer.cc:346)
CHI2_STEREO = 7.815  # 3 dof
HUBER_MONO = 2.4477  # sqrt(5.991)
HUBER_STEREO = 2.7955  # sqrt(7.815)

class PoseOptResult(NamedTuple):
    Tcw: jnp.ndarray  # [4,4]
    inliers: jnp.ndarray  # [N] bool
    n_inliers: jnp.ndarray  # scalar int32
    chi2: jnp.ndarray  # scalar: sum of final inlier chi2


def _residuals_jac(cam: CameraModel, Tcw, X, uv_obs, ur_obs, stereo_mask):
    """Per-edge residual [N,3] and Jacobian [N,3,6] (third row only for
    stereo edges). Perturbation: Tcw <- Exp(xi) * Tcw (left, g2o convention).
    """
    Xc = lie.se3_apply(Tcw, X)
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    zi = 1.0 / jnp.maximum(z, 1e-6)
    zi2 = zi * zi
    u = cam.fx * x * zi + cam.cx
    v = cam.fy * y * zi + cam.cy
    ur = u - cam.bf * zi
    r = jnp.stack(
        [u - uv_obs[..., 0], v - uv_obs[..., 1], jnp.where(stereo_mask, ur - ur_obs, 0.0)],
        axis=-1,
    )
    # d(uvr)/dXc
    zero = jnp.zeros_like(x)
    Ju = jnp.stack([cam.fx * zi, zero, -cam.fx * x * zi2], -1)
    Jv = jnp.stack([zero, cam.fy * zi, -cam.fy * y * zi2], -1)
    Jr = jnp.stack([cam.fx * zi, zero, -cam.fx * x * zi2 + cam.bf * zi2], -1)
    JX = jnp.stack([Ju, Jv, Jr], axis=-2)  # [N,3,3]
    # dXc/dxi for left perturbation: [I | -hat(Xc)]
    dX = jnp.concatenate([jnp.broadcast_to(jnp.eye(3), Xc.shape[:-1] + (3, 3)), -lie.hat(Xc)], axis=-1)
    J = lie.mm(JX, dX)  # [N,3,6]
    # third (u_right) row only participates for stereo edges
    ones = jnp.ones_like(x)
    row_mask = jnp.stack([ones, ones, stereo_mask.astype(x.dtype)], axis=-1)
    J = J * row_mask[..., None]
    behind = z <= 0.05
    return r, J, behind


@functools.partial(
    jax.jit, static_argnames=("cam", "rounds", "iters_per_round")
)
def optimize_pose(
    cam: CameraModel,
    Tcw_init,
    X,  # [N,3] world points
    uv_obs,  # [N,2] undistorted observations
    inv_sigma2,  # [N] per-edge information (1/scale^2oct)
    valid,  # [N] bool
    ur_obs=None,  # [N] virtual right coords (or None for mono-only)
    rounds: int = 4,
    iters_per_round: int = 10,
    T_prior=None,  # [4,4] motion/alignment prior pose (optional)
    prior_rot_info: float = 0.0,  # 1/sigma^2 on rotation deviation (rad^-2)
    prior_trans_info: float = 0.0,  # 1/sigma^2 on translation deviation (m^-2)
) -> PoseOptResult:
    """With T_prior set, adds a pose-prior term — the semi-direct fusion: the
    photometric aligner pins rotation far better than sparse reprojection
    does in low-parallax scenes, so its estimate enters the optimization as
    a (typically rotation-weighted) prior rather than only an init.

    On a CUDA device the solve is one Pallas kernel
    (ops/pallas/pose_kernel.py); elsewhere the same math runs as XLA loops."""
    N = X.shape[0]
    if ur_obs is None:
        ur_obs = jnp.full((N,), -1.0, jnp.float32)
    has_prior = T_prior is not None
    if not has_prior:
        T_prior = jnp.eye(4, dtype=jnp.float32)
    args = (Tcw_init, X, uv_obs, inv_sigma2, valid, ur_obs, T_prior,
            jnp.asarray(prior_rot_info, jnp.float32),
            jnp.asarray(prior_trans_info, jnp.float32))

    def run(impl):
        return lambda *a: impl(cam, *a[:6], rounds, iters_per_round,
                               a[6] if has_prior else None, *a[7:])

    return jax.lax.platform_dependent(
        *args, cuda=run(_optimize_pose_kernel), default=run(_optimize_pose_xla)
    )


def _optimize_pose_kernel(cam, Tcw_init, X, uv_obs, inv_sigma2, valid, ur_obs,
                          rounds, iters_per_round, T_prior, prior_rot_info,
                          prior_trans_info) -> PoseOptResult:
    N = X.shape[0]
    Tp_inv = (lie.se3_inv(T_prior) if T_prior is not None
              else jnp.eye(4, dtype=jnp.float32))
    edges, scal = pk.pack(X, uv_obs, ur_obs, inv_sigma2, valid, Tcw_init,
                          Tp_inv, prior_trans_info, prior_rot_info)
    out, inl = pk.pose_solve(cam, edges, scal, rounds, iters_per_round,
                             T_prior is not None)
    T = jnp.concatenate([out[:12].reshape(3, 4),
                         jnp.asarray([[0.0, 0.0, 0.0, 1.0]], jnp.float32)])
    inliers = inl[:N] > 0
    return PoseOptResult(lie.se3_normalize(T), inliers, jnp.sum(inliers),
                         out[13])


def _optimize_pose_xla(cam, Tcw_init, X, uv_obs, inv_sigma2, valid, ur_obs,
                       rounds, iters_per_round, T_prior, prior_rot_info,
                       prior_trans_info) -> PoseOptResult:
    stereo = ur_obs >= 0
    if T_prior is not None:
        # infos may be traced scalars (e.g. gated on alignment health)
        W_prior = jnp.diag(
            jnp.concatenate(
                [
                    jnp.full((3,), prior_trans_info, jnp.float32),
                    jnp.full((3,), prior_rot_info, jnp.float32),
                ]
            )
        )
        T_prior_inv = lie.se3_inv(T_prior)

    def gn_round(T, inlier_mask, use_huber):
        def step(_, T):
            r, J, behind = _residuals_jac(cam, T, X, uv_obs, ur_obs, stereo)
            m = inlier_mask & valid & (~behind)
            w = inv_sigma2 * m
            rn = jnp.sqrt(jnp.sum(r * r, axis=-1) * inv_sigma2 + 1e-12)
            if use_huber:
                delta_h = jnp.where(stereo, HUBER_STEREO, HUBER_MONO)
                w = w * jnp.minimum(1.0, delta_h / jnp.maximum(rn, 1e-9))
            H = jnp.einsum("nri,n,nrj->ij", J, w, J, precision=jax.lax.Precision.HIGHEST)
            b = -jnp.einsum("nri,n,nr->i", J, w, r, precision=jax.lax.Precision.HIGHEST)
            if T_prior is not None:
                # residual xi = log(T T_prior^-1); d(xi)/d(left-delta) ~= I
                xi = lie.se3_log(lie.mm(T, T_prior_inv))
                H = H + W_prior
                b = b - lie.mm(W_prior, xi)
            Hr = H + 1e-6 * jnp.maximum(jnp.trace(H) / 6.0, 1e-8) * jnp.eye(6)
            delta = jnp.linalg.solve(Hr, b)
            return lie.mm(lie.se3_exp(delta), T)

        return jax.lax.fori_loop(0, iters_per_round, step, T)

    T = Tcw_init
    inliers = valid
    for rnd in range(rounds):
        T = gn_round(T, inliers, use_huber=(rnd < 2))
        r, _, behind = _residuals_jac(cam, T, X, uv_obs, ur_obs, stereo)
        chi2 = jnp.sum(r * r, axis=-1) * inv_sigma2
        th = jnp.where(stereo, CHI2_STEREO, CHI2_MONO)
        inliers = valid & (~behind) & (chi2 <= th)

    r, _, behind = _residuals_jac(cam, T, X, uv_obs, ur_obs, stereo)
    chi2 = jnp.sum(r * r, axis=-1) * inv_sigma2
    total = jnp.sum(jnp.where(inliers, chi2, 0.0))
    # ~40 chained 4x4 f32 products/frame accumulate ~1e-6 orthonormality
    # error; renormalizing here (the only place poses exit the per-frame
    # loop) keeps long sequences on SO(3)
    T = lie.se3_normalize(T)
    return PoseOptResult(T, inliers, jnp.sum(inliers), total)
