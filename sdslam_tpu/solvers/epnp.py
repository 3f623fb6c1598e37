"""EPnP: pose from n 3D-2D correspondences via control points.

Restores the reference's PnPsolver capability (/root/reference/src/
PnPsolver.{h,cc} — compiled but dead there; BASELINE.json's north star names
"EPnP relocalization", so it is a first-class solver here): 4 control points
(centroid + PCA axes), barycentric coordinates, null-space betas (cases
N=1, 2) and Horn alignment for [R|t], inside a vmapped RANSAC.

Design: each hypothesis is a 12x12 eigendecomposition + small fixed
algebra — a perfect vmap batch (the reference iterates hypotheses on the
host, PnPsolver.cc:~160)."""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from sdslam_tpu.geometry import lie
from sdslam_tpu.geometry.camera import CameraModel
from sdslam_tpu.solvers.sim3_solver import umeyama_sim3


class PnPResult(NamedTuple):
    success: jnp.ndarray
    R: jnp.ndarray  # [3,3]
    t: jnp.ndarray  # [3]
    inliers: jnp.ndarray  # [N]
    n_inliers: jnp.ndarray


def _control_points(Xw, w):
    """Centroid + principal-axis control points (choose_control_points)."""
    wsum = jnp.maximum(jnp.sum(w), 1e-6)
    c0 = jnp.sum(Xw * w[:, None], 0) / wsum
    Xc = (Xw - c0) * w[:, None]
    cov = lie.mm(Xc.T, Xc) / wsum
    lam, V = jnp.linalg.eigh(cov)
    lam = jnp.maximum(lam, 1e-9)
    C = jnp.stack(
        [c0, c0 + jnp.sqrt(lam[2]) * V[:, 2], c0 + jnp.sqrt(lam[1]) * V[:, 1],
         c0 + jnp.sqrt(lam[0]) * V[:, 0]]
    )
    return C  # [4,3]


def _barycentric(Xw, C):
    B = jnp.stack([C[1] - C[0], C[2] - C[0], C[3] - C[0]], axis=1)  # [3,3]
    a123 = jnp.linalg.solve(
        B + 1e-9 * jnp.eye(3), (Xw - C[0]).T
    ).T  # [N,3]
    a0 = 1.0 - jnp.sum(a123, -1, keepdims=True)
    return jnp.concatenate([a0, a123], -1)  # [N,4]


def _solve_cam_controls(cam, alphas, uv, w):
    """Null space of the 2n x 12 system -> candidate camera-frame control
    points for beta cases 1 and 2; returns [2,4,3] candidates."""
    fu, fv, cx, cy = cam.fx, cam.fy, cam.cx, cam.cy
    N = uv.shape[0]
    # rows: sum_j a_j [fu, 0, cx-u] and [0, fv, cy-v] per control point
    r1 = jnp.concatenate(
        [alphas[:, j, None] * jnp.stack(
            [jnp.full((N,), fu), jnp.zeros((N,)), cx - uv[:, 0]], -1
        ) for j in range(4)], -1,
    )  # [N,12]
    r2 = jnp.concatenate(
        [alphas[:, j, None] * jnp.stack(
            [jnp.zeros((N,)), jnp.full((N,), fv), cy - uv[:, 1]], -1
        ) for j in range(4)], -1,
    )
    Mrows = jnp.concatenate([r1 * w[:, None], r2 * w[:, None]], 0)  # [2N,12]
    MtM = lie.mm(Mrows.T, Mrows)
    _, V = jnp.linalg.eigh(MtM)
    v1 = V[:, 0].reshape(4, 3)
    v2 = V[:, 1].reshape(4, 3)

    def pair_dists(C):
        d = C[:, None, :] - C[None, :, :]
        iu = jnp.triu_indices(4, 1)
        return jnp.linalg.norm(d[iu], axis=-1)  # [6]

    return v1, v2, pair_dists


def _pose_from_controls(cam, Xw, uv, w, alphas, Cc, Cw):
    Xc = lie.mm(alphas, Cc)  # [N,3]
    # enforce positive depth (sign ambiguity of the null vector)
    sign = jnp.sign(jnp.sum(jnp.where(w > 0, Xc[:, 2], 0.0)))
    Xc = Xc * jnp.where(sign == 0, 1.0, sign)
    R, t, _ = umeyama_sim3(Xw, Xc, w > 0, fix_scale=True)
    Xc_hat = lie.mm(Xw, R.T) + t
    u = cam.fx * Xc_hat[:, 0] / jnp.maximum(Xc_hat[:, 2], 1e-6) + cam.cx
    v = cam.fy * Xc_hat[:, 1] / jnp.maximum(Xc_hat[:, 2], 1e-6) + cam.cy
    err2 = (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2
    mean_err = jnp.sum(jnp.where(w > 0, err2, 0.0)) / jnp.maximum(jnp.sum(w > 0), 1)
    return R, t, mean_err


def epnp(cam: CameraModel, Xw, uv, mask):
    """Single EPnP solve over masked correspondences. Returns (R, t, err)."""
    w = mask.astype(jnp.float32)
    C = _control_points(Xw, w)
    alphas = _barycentric(Xw, C)
    v1, v2, pair_dists = _solve_cam_controls(cam, alphas, uv, w)
    dw = pair_dists(C)

    # beta case 1: Cc = b * v1
    d1 = pair_dists(v1)
    b1 = jnp.sum(dw * d1) / jnp.maximum(jnp.sum(d1 * d1), 1e-9)
    R_a, t_a, e_a = _pose_from_controls(cam, Xw, uv, w, alphas, b1 * v1, C)

    # beta case 2: Cc = b1 v1 + b2 v2; solve [d1^2, 2 d12, d2^2] betas = dw^2
    dv1 = v1[:, None, :] - v1[None, :, :]
    dv2 = v2[:, None, :] - v2[None, :, :]
    iu = jnp.triu_indices(4, 1)
    e11 = jnp.sum(dv1[iu] * dv1[iu], -1)
    e12 = jnp.sum(dv1[iu] * dv2[iu], -1)
    e22 = jnp.sum(dv2[iu] * dv2[iu], -1)
    L = jnp.stack([e11, 2 * e12, e22], -1)  # [6,3]
    rho = dw * dw
    beta, *_ = jnp.linalg.lstsq(L, rho)
    b11, b12, b22 = beta[0], beta[1], beta[2]
    bb1 = jnp.sqrt(jnp.maximum(jnp.abs(b11), 1e-12))
    bb2 = jnp.sign(b12) * jnp.sqrt(jnp.maximum(jnp.abs(b22), 1e-12))
    R_b, t_b, e_b = _pose_from_controls(
        cam, Xw, uv, w, alphas, bb1 * v1 + bb2 * v2, C
    )

    better_a = e_a <= e_b
    R = jnp.where(better_a, R_a, R_b)
    t = jnp.where(better_a, t_a, t_b)
    return R, t, jnp.minimum(e_a, e_b)


@functools.partial(jax.jit, static_argnames=("cam", "n_hypotheses", "min_set"))
def ransac_epnp(
    cam: CameraModel,
    Xw,  # [N,3] world points
    uv,  # [N,2] observations (undistorted)
    valid,  # [N]
    key,
    inlier_th_px: float = 5.99,
    n_hypotheses: int = 64,
    min_set: int = 6,
    min_inliers: int = 10,
) -> PnPResult:
    N = Xw.shape[0]
    probs = valid.astype(jnp.float32)
    probs = probs / jnp.maximum(probs.sum(), 1e-6)
    sets = jax.random.choice(key, N, shape=(n_hypotheses, min_set), p=probs)

    def hyp(idx):
        m = jnp.zeros((N,), bool).at[idx].set(True) & valid
        R, t, _ = epnp(cam, Xw, uv, m)
        Xc = lie.mm(Xw, R.T) + t
        u = cam.fx * Xc[:, 0] / jnp.maximum(Xc[:, 2], 1e-6) + cam.cx
        v = cam.fy * Xc[:, 1] / jnp.maximum(Xc[:, 2], 1e-6) + cam.cy
        e2 = (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2
        inl = valid & (e2 < inlier_th_px**2) & (Xc[:, 2] > 0)
        return jnp.sum(inl), R, t

    counts, Rs, ts = jax.vmap(hyp)(sets)
    best = jnp.argmax(counts)
    # refine on the best inlier set
    R, t = Rs[best], ts[best]
    Xc = lie.mm(Xw, R.T) + t
    u = cam.fx * Xc[:, 0] / jnp.maximum(Xc[:, 2], 1e-6) + cam.cx
    v = cam.fy * Xc[:, 1] / jnp.maximum(Xc[:, 2], 1e-6) + cam.cy
    inl = valid & ((u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2 < inlier_th_px**2) & (
        Xc[:, 2] > 0
    )
    R, t, _ = epnp(cam, Xw, uv, inl)
    Xc = lie.mm(Xw, R.T) + t
    u = cam.fx * Xc[:, 0] / jnp.maximum(Xc[:, 2], 1e-6) + cam.cx
    v = cam.fy * Xc[:, 1] / jnp.maximum(Xc[:, 2], 1e-6) + cam.cy
    inl = valid & ((u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2 < inlier_th_px**2) & (
        Xc[:, 2] > 0
    )
    return PnPResult(jnp.sum(inl) >= min_inliers, R, t, inl, jnp.sum(inl))
