"""Sim(3) estimation between matched 3D point sets.

Replaces Sim3Solver (/root/reference/src/Sim3Solver.{h,cc}): Horn's
closed-form absolute orientation inside a 3-point RANSAC loop with symmetric
reprojection inlier checks, plus a GN refinement equivalent to
Optimizer::OptimizeSim3 (Optimizer.cc:958-1142).

Design: all RANSAC hypotheses are evaluated in one vmapped batch (the
reference iterates 5 hypotheses at a time on the host, Sim3Solver.cc:137-198);
the inlier check is a dense [B, N] computation.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from sdslam_tpu.geometry import camera as cam_mod
from sdslam_tpu.geometry import lie
from sdslam_tpu.geometry.camera import CameraModel


class Sim3Result(NamedTuple):
    R: jnp.ndarray  # [3,3]
    t: jnp.ndarray  # [3]
    s: jnp.ndarray  # scalar
    inliers: jnp.ndarray  # [N] bool
    n_inliers: jnp.ndarray


def umeyama_sim3(X, Y, mask, fix_scale: bool = False):
    """Weighted least-squares similarity Y ~ s R X + t (Umeyama/Horn).

    X, Y: [N,3]; mask: [N] bool/float weights. Returns (R, t, s).
    """
    w = mask.astype(jnp.float32)
    wsum = jnp.maximum(jnp.sum(w), 1e-6)
    mu_x = jnp.sum(X * w[:, None], 0) / wsum
    mu_y = jnp.sum(Y * w[:, None], 0) / wsum
    Xc = (X - mu_x) * w[:, None]
    Yc = Y - mu_y
    cov = jnp.einsum(
        "ni,nj->ij", Yc * w[:, None], X - mu_x, precision=jax.lax.Precision.HIGHEST
    ) / wsum
    Usvd, D, Vt = jnp.linalg.svd(cov)
    det = jnp.linalg.det(Usvd) * jnp.linalg.det(Vt)
    Sfix = jnp.diag(jnp.asarray([1.0, 1.0, jnp.sign(det)]))
    R = lie.mm(lie.mm(Usvd, Sfix), Vt)
    var_x = jnp.sum(jnp.sum((X - mu_x) ** 2, -1) * w) / wsum
    s = jnp.where(
        fix_scale,
        1.0,
        jnp.sum(D * jnp.diag(Sfix)) / jnp.maximum(var_x, 1e-9),
    )
    t = mu_y - lie.mm(s * R, mu_x)
    return R, t, s


def _sym_reproj_inliers(cam: CameraModel, R, t, s, X1, X2, th2_1, th2_2, valid):
    """Symmetric reprojection check (Sim3Solver::CheckInliers,
    Sim3Solver.cc:321-353): transform X1 (cam-1 frame) into cam 2 via S21,
    project in both directions; inlier if both reprojection errors pass."""
    X1_in2 = s * jnp.einsum("ij,nj->ni", R, X1, precision=jax.lax.Precision.HIGHEST) + t
    sinv = 1.0 / jnp.maximum(s, 1e-9)
    X2_in1 = sinv * jnp.einsum("ji,nj->ni", R, X2 - t, precision=jax.lax.Precision.HIGHEST)
    uv12, z12 = cam_mod.project(cam, X1_in2)
    uv21, z21 = cam_mod.project(cam, X2_in1)
    uv1, z1 = cam_mod.project(cam, X1)
    uv2, z2 = cam_mod.project(cam, X2)
    e2 = jnp.sum((uv12 - uv2) ** 2, -1)
    e1 = jnp.sum((uv21 - uv1) ** 2, -1)
    ok = valid & (e2 < th2_2) & (e1 < th2_1) & (z12 > 0) & (z21 > 0)
    return ok


@functools.partial(jax.jit, static_argnames=("cam", "n_hypotheses", "fix_scale"))
def ransac_sim3(
    cam: CameraModel,
    X1,  # [N,3] matched points in keyframe-1 camera frame
    X2,  # [N,3] matched points in keyframe-2 camera frame
    valid,  # [N] bool
    th2_1,  # [N] squared px thresholds (9.21 * sigma2, Sim3Solver.cc:88-95)
    th2_2,
    key,
    n_hypotheses: int = 64,
    fix_scale: bool = False,
) -> Sim3Result:
    """Batched 3-point RANSAC for S21 (maps cam-1 coords into cam-2)."""
    N = X1.shape[0]
    probs = valid.astype(jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1e-6)
    idx = jax.random.choice(key, N, shape=(n_hypotheses, 3), p=probs)

    def hyp(i3):
        m = jnp.zeros((N,), bool).at[i3].set(True)
        R, t, s = umeyama_sim3(X1, X2, m & valid, fix_scale=fix_scale)
        ok = _sym_reproj_inliers(cam, R, t, s, X1, X2, th2_1, th2_2, valid)
        return jnp.sum(ok), R, t, s

    counts, Rs, ts, ss = jax.vmap(hyp)(idx)
    best = jnp.argmax(counts)
    R, t, s = Rs[best], ts[best], ss[best]
    ok = _sym_reproj_inliers(cam, R, t, s, X1, X2, th2_1, th2_2, valid)
    # refine on the inlier set (the reference refines via OptimizeSim3)
    R, t, s = umeyama_sim3(X1, X2, ok, fix_scale=fix_scale)
    ok = _sym_reproj_inliers(cam, R, t, s, X1, X2, th2_1, th2_2, valid)
    return Sim3Result(R, t, s, ok, jnp.sum(ok))


class Sim3OptResult(NamedTuple):
    S: jnp.ndarray  # [4,4] refined sim3 (maps cam-2 coords into cam-1)
    inliers: jnp.ndarray  # [N] bool
    n_inliers: jnp.ndarray


@functools.partial(
    jax.jit, static_argnames=("cam", "fix_scale", "iters1", "iters2")
)
def optimize_sim3(
    cam: CameraModel,
    S12,  # [4,4] initial sim3 (RANSAC output): X_in1 = S12 * X2
    X1,  # [N,3] matched map points in cam-1 frame
    X2,  # [N,3] matched map points in cam-2 frame
    uv1,  # [N,2] observed keypoint pixels in image 1
    uv2,  # [N,2] observed keypoint pixels in image 2
    info1,  # [N] 1/sigma^2 of the image-1 observation (octave-scaled)
    info2,  # [N] 1/sigma^2 of the image-2 observation
    valid,  # [N] bool
    th2: float = 10.0,
    fix_scale: bool = False,
    iters1: int = 5,
    iters2: int = 10,
) -> Sim3OptResult:
    """Iterative Gauss-Newton refinement of a Sim3 with symmetric
    reprojection edges (Optimizer::OptimizeSim3, Optimizer.cc:958-1142):
    forward edges observe proj(S12 * X2) in image 1, inverse edges observe
    proj(S12^-1 * X1) in image 2; Huber delta = sqrt(th2) (:997); two stages
    with an edge-pair prune between them (chi2 > th2 in either direction
    drops the pair, :1077-1100).

    Shape: the g2o vertex/edge graph becomes a 7-parameter manifold GN
    with all 2N residuals evaluated as one batch; the Jacobian [4N,7] comes
    from forward-mode autodiff at the tangent-space origin."""
    delta = jnp.sqrt(th2)

    def residuals(xi, S):
        Sx = lie.mm(lie.sim3_exp(xi), S)
        r_fwd = cam_mod.project(cam, lie.sim3_apply(Sx, X2))[0] - uv1
        r_inv = cam_mod.project(cam, lie.sim3_apply(lie.sim3_inv(Sx), X1))[0] - uv2
        return r_fwd, r_inv

    def chi2_pair(S):
        r_fwd, r_inv = residuals(jnp.zeros((7,)), S)
        c_fwd = jnp.sum(r_fwd**2, -1) * info1
        c_inv = jnp.sum(r_inv**2, -1) * info2
        return c_fwd, c_inv

    def gn_step(S, active):
        def flat(xi):
            r_fwd, r_inv = residuals(xi, S)
            return jnp.concatenate([r_fwd.ravel(), r_inv.ravel()])

        r = flat(jnp.zeros((7,)))
        J = jax.jacfwd(flat)(jnp.zeros((7,)))
        # per-edge robust weights: info * huber'(chi)/chi
        c_fwd, c_inv = chi2_pair(S)
        w_fwd = info1 * jnp.minimum(1.0, delta / jnp.sqrt(jnp.maximum(c_fwd, 1e-12)))
        w_inv = info2 * jnp.minimum(1.0, delta / jnp.sqrt(jnp.maximum(c_inv, 1e-12)))
        w = jnp.concatenate(
            [
                jnp.repeat(w_fwd * active, 2),
                jnp.repeat(w_inv * active, 2),
            ]
        )
        H = lie.mm(J.T, J * w[:, None])
        b = lie.mm(J.T, r * w)
        if fix_scale:
            # zero out the scale direction (6-DoF mode, Optimizer.cc:770 analog)
            H = H.at[6, :].set(0.0).at[:, 6].set(0.0).at[6, 6].set(1.0)
            b = b.at[6].set(0.0)
        H = H + 1e-6 * jnp.eye(7)
        dx = -jnp.linalg.solve(H, b)
        return lie.mm(lie.sim3_exp(dx), S)

    active0 = valid.astype(jnp.float32)
    S = jax.lax.fori_loop(
        0, iters1, lambda _, S: gn_step(S, active0), S12
    )
    c_fwd, c_inv = chi2_pair(S)
    keep = valid & (c_fwd < th2) & (c_inv < th2)
    active1 = keep.astype(jnp.float32)
    S = jax.lax.fori_loop(
        0, iters2, lambda _, S: gn_step(S, active1), S
    )
    c_fwd, c_inv = chi2_pair(S)
    inl = keep & (c_fwd < th2) & (c_inv < th2)
    # renormalize the rotation block drift from repeated exp-compositions
    Rb, tb, sb = lie.sim3_Rts(S)
    U, _, Vt = jnp.linalg.svd(Rb)
    S = lie.sim3_from_Rts(lie.mm(U, Vt), tb, jnp.where(fix_scale, 1.0, sb))
    return Sim3OptResult(S, inl, jnp.sum(inl))
