"""Monocular two-view initialization: batched H/F RANSAC + reconstruction.

Replaces Initializer (/root/reference/src/Initializer.{h,cc}): 200 RANSAC
iterations over shared 8-point samples scoring both a homography and a
fundamental matrix (the reference runs them in two transient threads,
Initialize:98-103 — here both are single vmapped batches), model selection
RH = SH/(SH+SF) > 0.40, then reconstruction: F -> essential decomposition
into 4 motions, H -> Faugeras decomposition into 8 motions, with cheirality
+ parallax + reprojection voting (CheckRT, Initializer.cc:752).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from sdslam_tpu.geometry import lie
from sdslam_tpu.geometry.camera import CameraModel

CHI2_H = 5.991
CHI2_F = 3.841
SCORE_TH = 5.991  # both scores use this cap (Initializer.cc:482,581)


class InitResult(NamedTuple):
    success: jnp.ndarray  # bool
    R21: jnp.ndarray  # [3,3]
    t21: jnp.ndarray  # [3] (unit-ish scale)
    X1: jnp.ndarray  # [N,3] triangulated points in frame-1 camera coords
    inliers: jnp.ndarray  # [N] bool (triangulated + checks passed)
    used_homography: jnp.ndarray  # bool
    n_good: jnp.ndarray


def _normalize(uv, valid):
    """Hartley normalization (Initializer::Normalize, Initializer.cc:707)."""
    w = valid.astype(jnp.float32)
    n = jnp.maximum(w.sum(), 1.0)
    mean = jnp.sum(uv * w[:, None], 0) / n
    d = jnp.sum(jnp.abs(uv - mean) * w[:, None], 0) / n
    s = 1.0 / jnp.maximum(d, 1e-6)
    T = jnp.asarray(
        [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
    ) * 1.0
    T = T.at[0, 0].set(s[0]).at[1, 1].set(s[1])
    T = T.at[0, 2].set(-mean[0] * s[0]).at[1, 2].set(-mean[1] * s[1])
    un = (uv - mean) * s
    return un, T


def _fit_F(p1, p2):
    """8-point fundamental matrix from [8,2] correspondences (normalized)."""
    x1, y1 = p1[:, 0], p1[:, 1]
    x2, y2 = p2[:, 0], p2[:, 1]
    A = jnp.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, jnp.ones_like(x1)],
        axis=-1,
    )
    _, _, Vt = jnp.linalg.svd(A)
    F = Vt[-1].reshape(3, 3)
    U, D, Vt2 = jnp.linalg.svd(F)
    D = D.at[2].set(0.0)  # rank-2 enforcement
    return lie.mm(lie.mm(U, jnp.diag(D)), Vt2)


def _fit_H(p1, p2):
    """DLT homography from [8,2] correspondences (normalized)."""
    x1, y1 = p1[:, 0], p1[:, 1]
    x2, y2 = p2[:, 0], p2[:, 1]
    z = jnp.zeros_like(x1)
    o = jnp.ones_like(x1)
    r1 = jnp.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], -1)
    r2 = jnp.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], -1)
    A = jnp.concatenate([r1, r2], 0)
    _, _, Vt = jnp.linalg.svd(A)
    return Vt[-1].reshape(3, 3)


def _fit_F_weighted(p1, p2, w):
    """F from all weighted correspondences via the 9x9 normal matrix."""
    x1, y1 = p1[:, 0], p1[:, 1]
    x2, y2 = p2[:, 0], p2[:, 1]
    A = jnp.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, jnp.ones_like(x1)],
        axis=-1,
    )
    Mn = jnp.einsum("ni,n,nj->ij", A, w, A, precision=jax.lax.Precision.HIGHEST)
    _, V = jnp.linalg.eigh(Mn)
    F = V[:, 0].reshape(3, 3)
    U, D, Vt2 = jnp.linalg.svd(F)
    return lie.mm(lie.mm(U, jnp.diag(D.at[2].set(0.0))), Vt2)


def _fit_H_weighted(p1, p2, w):
    x1, y1 = p1[:, 0], p1[:, 1]
    x2, y2 = p2[:, 0], p2[:, 1]
    z = jnp.zeros_like(x1)
    o = jnp.ones_like(x1)
    r1 = jnp.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], -1)
    r2 = jnp.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], -1)
    A = jnp.concatenate([r1, r2], 0)
    w2 = jnp.concatenate([w, w], 0)
    Mn = jnp.einsum("ni,n,nj->ij", A, w2, A, precision=jax.lax.Precision.HIGHEST)
    _, V = jnp.linalg.eigh(Mn)
    return V[:, 0].reshape(3, 3)


def _score_F(F, uv1, uv2, valid, sigma2):
    """Symmetric epipolar-distance score (CheckFundamental, :529-620)."""
    ones = jnp.ones((uv1.shape[0], 1))
    p1 = jnp.concatenate([uv1, ones], -1)
    p2 = jnp.concatenate([uv2, ones], -1)
    l2 = lie.mm(p1, F.T)  # line in image 2
    l1 = lie.mm(p2, F)
    num2 = jnp.sum(l2 * p2, -1) ** 2
    num1 = jnp.sum(l1 * p1, -1) ** 2
    d2 = num2 / jnp.maximum(l2[:, 0] ** 2 + l2[:, 1] ** 2, 1e-9) / sigma2
    d1 = num1 / jnp.maximum(l1[:, 0] ** 2 + l1[:, 1] ** 2, 1e-9) / sigma2
    ok = valid & (d1 < CHI2_F) & (d2 < CHI2_F)
    score = jnp.sum(
        jnp.where(valid & (d1 < CHI2_F), SCORE_TH - d1, 0.0)
        + jnp.where(valid & (d2 < CHI2_F), SCORE_TH - d2, 0.0)
    )
    return score, ok


def _score_H(H, uv1, uv2, valid, sigma2):
    """Symmetric transfer-error score (CheckHomography, :448-527)."""
    Hinv = jnp.linalg.inv(H)

    def transfer(M, a):
        ones = jnp.ones((a.shape[0], 1))
        p = lie.mm(jnp.concatenate([a, ones], -1), M.T)
        return p[:, :2] / jnp.maximum(jnp.abs(p[:, 2:]), 1e-9) * jnp.sign(p[:, 2:])

    e12 = jnp.sum((transfer(H, uv1) - uv2) ** 2, -1) / sigma2
    e21 = jnp.sum((transfer(Hinv, uv2) - uv1) ** 2, -1) / sigma2
    ok = valid & (e12 < CHI2_H) & (e21 < CHI2_H)
    score = jnp.sum(
        jnp.where(valid & (e12 < CHI2_H), SCORE_TH - e12, 0.0)
        + jnp.where(valid & (e21 < CHI2_H), SCORE_TH - e21, 0.0)
    )
    return score, ok


def triangulate(P1, P2, uv1, uv2):
    """Batched DLT triangulation (Initializer::Triangulate, :692)."""
    rows = jnp.stack(
        [
            uv1[:, 0, None] * P1[2] - P1[0],
            uv1[:, 1, None] * P1[2] - P1[1],
            uv2[:, 0, None] * P2[2] - P2[0],
            uv2[:, 1, None] * P2[2] - P2[1],
        ],
        axis=1,
    )  # [N,4,4]
    _, _, Vt = jnp.linalg.svd(rows)
    Xh = Vt[:, -1]
    return Xh[:, :3] / jnp.where(jnp.abs(Xh[:, 3:]) < 1e-9, 1e-9, Xh[:, 3:])


def triangulate_linear(P1, P2, uv1, uv2):
    """Inhomogeneous DLT: fix w=1 and solve the 4x3 system by 3x3 normal
    equations — algebraically the same constraint set as `triangulate` but
    a batched small solve instead of a batched SVD (used in the
    per-keyframe triangulation hot path)."""
    rows = jnp.stack(
        [
            uv1[:, 0, None] * P1[2] - P1[0],
            uv1[:, 1, None] * P1[2] - P1[1],
            uv2[:, 0, None] * P2[2] - P2[0],
            uv2[:, 1, None] * P2[2] - P2[1],
        ],
        axis=1,
    )  # [N,4,4]
    A = rows[:, :, :3]
    b = -rows[:, :, 3]
    AtA = jnp.einsum("nij,nik->njk", A, A, precision=jax.lax.Precision.HIGHEST)
    Atb = jnp.einsum("nij,ni->nj", A, b, precision=jax.lax.Precision.HIGHEST)
    AtA = AtA + 1e-9 * jnp.eye(3)
    # closed-form symmetric 3x3 solve (adjugate): elementwise work that
    # fuses, where jnp.linalg.solve would be a batched solver custom call
    a00, a01, a02 = AtA[:, 0, 0], AtA[:, 0, 1], AtA[:, 0, 2]
    a11, a12, a22 = AtA[:, 1, 1], AtA[:, 1, 2], AtA[:, 2, 2]
    c00 = a11 * a22 - a12 * a12
    c01 = a02 * a12 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c11 = a00 * a22 - a02 * a02
    c12 = a01 * a02 - a00 * a12
    c22 = a00 * a11 - a01 * a01
    det = a00 * c00 + a01 * c01 + a02 * c02
    di = 1.0 / jnp.where(jnp.abs(det) > 1e-18, det, 1e-18)
    b0, b1, b2 = Atb[:, 0], Atb[:, 1], Atb[:, 2]
    x0 = (c00 * b0 + c01 * b1 + c02 * b2) * di
    x1 = (c01 * b0 + c11 * b1 + c12 * b2) * di
    x2 = (c02 * b0 + c12 * b1 + c22 * b2) * di
    return jnp.stack([x0, x1, x2], axis=-1)


def _check_RT(cam: CameraModel, R, t, uv1, uv2, valid, sigma2):
    """Cheirality + parallax + reprojection vote for one motion hypothesis
    (Initializer::CheckRT, :752)."""
    K = cam.K
    P1 = lie.mm(K, jnp.concatenate([jnp.eye(3), jnp.zeros((3, 1))], 1))
    P2 = lie.mm(K, jnp.concatenate([R, t[:, None]], 1))
    X1 = triangulate(P1, P2, uv1, uv2)
    z1 = X1[:, 2]
    X2 = lie.mm(X1, R.T) + t
    z2 = X2[:, 2]
    # parallax between viewing rays
    O2 = lie.mm(-R.T, t)
    r1 = X1 / jnp.maximum(jnp.linalg.norm(X1, axis=-1, keepdims=True), 1e-9)
    r2 = (X1 - O2) / jnp.maximum(
        jnp.linalg.norm(X1 - O2, axis=-1, keepdims=True), 1e-9
    )
    cos_par = jnp.sum(r1 * r2, -1)
    # reprojection errors
    u1 = cam.fx * X1[:, 0] / jnp.maximum(z1, 1e-9) + cam.cx
    v1 = cam.fy * X1[:, 1] / jnp.maximum(z1, 1e-9) + cam.cy
    u2 = cam.fx * X2[:, 0] / jnp.maximum(z2, 1e-9) + cam.cy * 0 + cam.cx
    v2 = cam.fy * X2[:, 1] / jnp.maximum(z2, 1e-9) + cam.cy
    e1 = (u1 - uv1[:, 0]) ** 2 + (v1 - uv1[:, 1]) ** 2
    e2 = (u2 - uv2[:, 0]) ** 2 + (v2 - uv2[:, 1]) ** 2
    good = (
        valid
        & (z1 > 0)
        & (z2 > 0)
        & (cos_par < 0.99998)
        & (e1 < 4.0 * sigma2)
        & (e2 < 4.0 * sigma2)
    )
    # median-ish parallax of good points: use the 50th best cos (smaller = more parallax)
    par_deg = jnp.degrees(jnp.arccos(jnp.clip(cos_par, -1, 1)))
    par_ok = jnp.where(good, par_deg, 0.0)
    return jnp.sum(good), good, X1, jnp.max(par_ok)


def _motions_from_F(cam, F):
    """E = K^T F K -> 4 candidate motions (ReconstructF, :448)."""
    K = cam.K
    E = lie.mm(lie.mm(K.T, F), K)
    U, _, Vt = jnp.linalg.svd(E)
    W = jnp.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    R1 = lie.mm(lie.mm(U, W), Vt)
    R2 = lie.mm(lie.mm(U, W.T), Vt)
    R1 = R1 * jnp.sign(jnp.linalg.det(R1))
    R2 = R2 * jnp.sign(jnp.linalg.det(R2))
    t = U[:, 2]
    t = t / jnp.maximum(jnp.linalg.norm(t), 1e-9)
    Rs = jnp.stack([R1, R1, R2, R2])
    ts = jnp.stack([t, -t, t, -t])
    return Rs, ts


def _motions_from_H(cam, H):
    """Faugeras SVD decomposition of a homography into 8 motions
    (ReconstructH, :537)."""
    K = cam.K
    Kinv = jnp.linalg.inv(K)
    A = lie.mm(lie.mm(Kinv, H), K)
    U, D, Vt = jnp.linalg.svd(A)
    s = jnp.linalg.det(U) * jnp.linalg.det(Vt)
    d1, d2, d3 = D[0], D[1], D[2]
    # x1/x3 combinations
    aux1 = jnp.sqrt(jnp.maximum((d1 * d1 - d2 * d2) / jnp.maximum(d1 * d1 - d3 * d3, 1e-12), 0.0))
    aux3 = jnp.sqrt(jnp.maximum((d2 * d2 - d3 * d3) / jnp.maximum(d1 * d1 - d3 * d3, 1e-12), 0.0))
    x1s = jnp.asarray([1.0, 1.0, -1.0, -1.0]) * aux1
    x3s = jnp.asarray([1.0, -1.0, 1.0, -1.0]) * aux3

    # case d' > 0
    aux_st = jnp.sqrt(
        jnp.maximum(
            (d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0
        )
    ) / jnp.maximum((d1 + d3) * d2, 1e-12)
    st = jnp.asarray([1.0, -1.0, -1.0, 1.0]) * aux_st
    ct = (d2 * d2 + d1 * d3) / jnp.maximum((d1 + d3) * d2, 1e-12)

    def make_pos(i):
        Rp = jnp.asarray(
            [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
        )
        Rp = Rp.at[0, 0].set(ct).at[2, 2].set(ct)
        Rp = Rp.at[0, 2].set(-st[i]).at[2, 0].set(st[i])
        R = lie.mm(lie.mm(s * U, Rp), Vt)
        tp = jnp.asarray([x1s[i], 0.0, -x3s[i]]) * (d1 - d3)
        t = lie.mm(U, tp)
        return R, t / jnp.maximum(jnp.linalg.norm(t), 1e-9)

    # case d' < 0
    aux_sp = jnp.sqrt(
        jnp.maximum((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)
    ) / jnp.maximum((d1 - d3) * d2, 1e-12)
    sp = jnp.asarray([1.0, -1.0, -1.0, 1.0]) * aux_sp
    cp = (d1 * d3 - d2 * d2) / jnp.maximum((d1 - d3) * d2, 1e-12)

    def make_neg(i):
        Rp = jnp.zeros((3, 3))
        Rp = Rp.at[0, 0].set(cp).at[2, 2].set(-cp).at[1, 1].set(-1.0)
        Rp = Rp.at[0, 2].set(sp[i]).at[2, 0].set(sp[i])
        R = lie.mm(lie.mm(s * U, Rp), Vt)
        tp = jnp.asarray([x1s[i], 0.0, x3s[i]]) * (d1 + d3)
        t = lie.mm(U, tp)
        return R, t / jnp.maximum(jnp.linalg.norm(t), 1e-9)

    Rs, ts = [], []
    for i in range(4):
        R, t = make_pos(i)
        Rs.append(R)
        ts.append(t)
    for i in range(4):
        R, t = make_neg(i)
        Rs.append(R)
        ts.append(t)
    return jnp.stack(Rs), jnp.stack(ts)


@functools.partial(jax.jit, static_argnames=("cam", "n_iters"))
def initialize_two_view(
    cam: CameraModel,
    uv1,  # [N,2] undistorted keypoint coords in frame 1
    uv2,  # [N,2] matched coords in frame 2
    valid,  # [N] bool
    key,
    sigma: float = 1.0,
    n_iters: int = 200,
    min_triangulated: int = 50,
) -> InitResult:
    N = uv1.shape[0]
    sigma2 = sigma * sigma
    n1, T1 = _normalize(uv1, valid)
    n2, T2 = _normalize(uv2, valid)

    probs = valid.astype(jnp.float32)
    probs = probs / jnp.maximum(probs.sum(), 1e-6)
    samples = jax.random.choice(key, N, shape=(n_iters, 8), p=probs)

    def hypo(idx):
        p1 = n1[idx]
        p2 = n2[idx]
        Fn = _fit_F(p1, p2)
        F = lie.mm(lie.mm(T2.T, Fn), T1)
        sF, _ = _score_F(F, uv1, uv2, valid, sigma2)
        Hn = _fit_H(p1, p2)
        H = lie.mm(lie.mm(jnp.linalg.inv(T2), Hn), T1)
        sH, _ = _score_H(H, uv1, uv2, valid, sigma2)
        return sF, F, sH, H

    sFs, Fs, sHs, Hs = jax.vmap(hypo)(samples)
    bF = jnp.argmax(sFs)
    bH = jnp.argmax(sHs)
    SF, F = sFs[bF], Fs[bF]
    SH, H = sHs[bH], Hs[bH]

    # re-fit each model on its inlier set (the reference recomputes the
    # model from all inliers after RANSAC), twice for stability
    for _ in range(2):
        _, inlF = _score_F(F, uv1, uv2, valid, sigma2)
        Fn = _fit_F_weighted(n1, n2, inlF.astype(jnp.float32))
        F = lie.mm(lie.mm(T2.T, Fn), T1)
        SF, _ = _score_F(F, uv1, uv2, valid, sigma2)
        _, inlH = _score_H(H, uv1, uv2, valid, sigma2)
        Hn = _fit_H_weighted(n1, n2, inlH.astype(jnp.float32))
        H = lie.mm(lie.mm(jnp.linalg.inv(T2), Hn), T1)
        SH, _ = _score_H(H, uv1, uv2, valid, sigma2)

    use_H = SH / jnp.maximum(SH + SF, 1e-9) > 0.40

    # candidate motions from both models; the unused half is masked out
    Rf, tf = _motions_from_F(cam, F)  # [4,...]
    Rh, th = _motions_from_H(cam, H)  # [8,...]
    Rs = jnp.concatenate([Rf, Rh])  # [12,3,3]
    ts = jnp.concatenate([tf, th])
    model_mask = jnp.concatenate(
        [jnp.full((4,), ~use_H), jnp.full((8,), use_H)]
    )

    _, inl_model = jax.lax.cond(
        use_H,
        lambda: _score_H(H, uv1, uv2, valid, sigma2),
        lambda: _score_F(F, uv1, uv2, valid, sigma2),
    )

    def check(i):
        n_good, good, X1, par = _check_RT(
            cam, Rs[i], ts[i], uv1, uv2, inl_model, sigma2
        )
        return jnp.where(model_mask[i], n_good, -1), good, X1, par

    counts, goods, X1s, pars = jax.vmap(check)(jnp.arange(12))
    best = jnp.argmax(counts)
    n_best = counts[best]
    # winner must dominate (no ambiguous second, Initializer.cc:~505) and
    # have enough points
    sorted_counts = jnp.sort(counts)
    second = sorted_counts[-2]
    ok = (
        (n_best >= min_triangulated)
        & (second.astype(jnp.float32) < 0.75 * n_best.astype(jnp.float32))
        & (n_best >= 0.8 * jnp.sum(inl_model))
    )
    return InitResult(
        success=ok,
        R21=Rs[best],
        t21=ts[best],
        X1=X1s[best],
        inliers=goods[best],
        used_homography=use_H,
        n_good=n_best,
    )
