"""Lie-group math for SO(3) / SE(3) / Sim(3) (float32, batched).

Replaces the reference's Eigen/g2o Lie machinery (se3quat.h, sim3.h,
ImageAlign.cc:473-499 `Exp`, ConstantVelocity.cc:161-238 `Exp/Log`) with a
single functional jnp module.  All functions broadcast over leading batch
dimensions and are stable in float32 via Taylor fallbacks near theta=0.

Conventions:
  * Quaternions are [w, x, y, z], normalized, w >= 0 canonicalization only
    where stated.
  * Poses are 4x4 homogeneous matrices T = [[R, t], [0, 1]]; SLAM poses are
    Tcw (world -> camera), matching the reference (Frame.h pose fields).
  * se3 tangent is [rho(3), phi(3)] (translation part first), exp uses the
    standard V(phi) left-Jacobian:  T = [[exp(phi^), V rho], [0, 1]].
  * sim3 tangent is [rho(3), phi(3), sigma(1)]; S = [[s R, W rho], [0, 1]],
    s = exp(sigma).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_EPS = 1e-8

# Pose, rotation and normal-equation products run at full float32: a GPU
# runs a float32 product in TF32 (~3 decimal digits) unless told otherwise.
_einsum = functools.partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)


def mm(a, b):
    """`a @ b` at full float32 precision (matmul broadcasting rules)."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def _small(theta2):
    return theta2 < 1e-8


# ---------------------------------------------------------------------------
# quaternions
# ---------------------------------------------------------------------------

def quat_identity(dtype=jnp.float32):
    return jnp.array([1.0, 0.0, 0.0, 0.0], dtype=dtype)


def quat_normalize(q):
    return q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), _EPS)


def quat_mul(a, b):
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def quat_conj(q):
    return q * jnp.array([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_rotate(q, v):
    """Rotate vectors v [...,3] by quaternions q [...,4]."""
    qv = q[..., 1:]
    w = q[..., :1]
    t = 2.0 * jnp.cross(qv, v)
    return v + w * t + jnp.cross(qv, t)


def quat_to_mat(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = jnp.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def mat_to_quat(R):
    """Rotation matrix [...,3,3] -> quaternion [w,x,y,z], branch-free.

    Uses the 4-candidate trace method with jnp.where selection (no
    data-dependent control flow).
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    tr = m00 + m11 + m22
    # Four candidate computations; pick the numerically best by largest pivot.
    qw0 = jnp.sqrt(jnp.maximum(1.0 + tr, 0.0)) * 0.5
    s0 = 0.25 / jnp.maximum(qw0, _EPS)
    cand0 = jnp.stack([qw0, (m21 - m12) * s0, (m02 - m20) * s0, (m10 - m01) * s0], -1)

    qx1 = jnp.sqrt(jnp.maximum(1.0 + m00 - m11 - m22, 0.0)) * 0.5
    s1 = 0.25 / jnp.maximum(qx1, _EPS)
    cand1 = jnp.stack([(m21 - m12) * s1, qx1, (m01 + m10) * s1, (m02 + m20) * s1], -1)

    qy2 = jnp.sqrt(jnp.maximum(1.0 - m00 + m11 - m22, 0.0)) * 0.5
    s2 = 0.25 / jnp.maximum(qy2, _EPS)
    cand2 = jnp.stack([(m02 - m20) * s2, (m01 + m10) * s2, qy2, (m12 + m21) * s2], -1)

    qz3 = jnp.sqrt(jnp.maximum(1.0 - m00 - m11 + m22, 0.0)) * 0.5
    s3 = 0.25 / jnp.maximum(qz3, _EPS)
    cand3 = jnp.stack([(m10 - m01) * s3, (m02 + m20) * s3, (m12 + m21) * s3, qz3], -1)

    pivots = jnp.stack([tr, m00 - m11 - m22, -m00 + m11 - m22, -m00 - m11 + m22], -1)
    idx = jnp.argmax(pivots, axis=-1)
    cands = jnp.stack([cand0, cand1, cand2, cand3], axis=-2)  # [...,4,4]
    q = jnp.take_along_axis(cands, idx[..., None, None].repeat(4, -1), axis=-2)[..., 0, :]
    # canonicalize w >= 0
    q = jnp.where(q[..., :1] < 0, -q, q)
    return quat_normalize(q)


# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------

def hat(phi):
    """[...,3] -> skew-symmetric [...,3,3]."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = jnp.zeros_like(x)
    m = jnp.stack([zero, -z, y, z, zero, -x, -y, x, zero], axis=-1)
    return m.reshape(phi.shape[:-1] + (3, 3))


def vee(M):
    return jnp.stack([M[..., 2, 1], M[..., 0, 2], M[..., 1, 0]], axis=-1)


def so3_exp(phi):
    """Rodrigues with Taylor fallback: [...,3] -> [...,3,3]."""
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, 0.0))
    K = hat(phi)
    K2 = mm(K, K)
    # sin(t)/t and (1-cos t)/t^2 with series fallback
    a = jnp.where(_small(theta2), 1.0 - theta2 / 6.0, jnp.sin(theta) / jnp.maximum(theta, _EPS))
    b = jnp.where(_small(theta2), 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / jnp.maximum(theta2, _EPS))
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * K2


def so3_log(R):
    """[...,3,3] -> [...,3]; handles theta near 0 and near pi."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = jnp.clip((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arccos(cos_t)
    w = jnp.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]],
        axis=-1,
    )
    sin_t = jnp.sin(theta)
    # generic: phi = theta/(2 sin) * w ; near 0: 0.5*w
    scale = jnp.where(theta < 1e-4, 0.5 + theta * theta / 12.0, theta / jnp.maximum(2.0 * sin_t, _EPS))
    phi_generic = scale[..., None] * w
    # near pi: use diagonal to recover axis
    near_pi = theta > (jnp.pi - 1e-3)
    diag = jnp.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], axis=-1)
    axis2 = jnp.maximum((diag - cos_t[..., None]) / jnp.maximum(1.0 - cos_t[..., None], _EPS), 0.0)
    axis = jnp.sqrt(axis2)
    # fix signs from off-diagonal sums: sign(axis_i) from w (may be tiny) or
    # off-diagonal products
    s01 = R[..., 0, 1] + R[..., 1, 0]
    s02 = R[..., 0, 2] + R[..., 2, 0]
    s12 = R[..., 1, 2] + R[..., 2, 1]
    amax = jnp.argmax(axis2, axis=-1)
    sx = jnp.where(amax == 0, 1.0, jnp.where(amax == 1, jnp.sign(s01 + _EPS), jnp.sign(s02 + _EPS)))
    sy = jnp.where(amax == 1, 1.0, jnp.where(amax == 0, jnp.sign(s01 + _EPS), jnp.sign(s12 + _EPS)))
    sz = jnp.where(amax == 2, 1.0, jnp.where(amax == 0, jnp.sign(s02 + _EPS), jnp.sign(s12 + _EPS)))
    phi_pi = theta[..., None] * axis * jnp.stack([sx, sy, sz], axis=-1)
    return jnp.where(near_pi[..., None], phi_pi, phi_generic)


def so3_left_jacobian(phi):
    """V(phi) such that se3_exp translation = V @ rho."""
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, 0.0))
    K = hat(phi)
    K2 = mm(K, K)
    b = jnp.where(_small(theta2), 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / jnp.maximum(theta2, _EPS))
    c = jnp.where(
        _small(theta2),
        1.0 / 6.0 - theta2 / 120.0,
        (theta - jnp.sin(theta)) / jnp.maximum(theta2 * theta, _EPS),
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), K.shape)
    return eye + b[..., None, None] * K + c[..., None, None] * K2


def so3_left_jacobian_inv(phi):
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, 0.0))
    K = hat(phi)
    K2 = mm(K, K)
    half_theta = 0.5 * theta
    # coefficient: 1/theta^2 * (1 - theta sin / (2(1-cos)))
    cot = half_theta * jnp.cos(half_theta) / jnp.maximum(jnp.sin(half_theta), _EPS)
    c = jnp.where(
        _small(theta2),
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - cot) / jnp.maximum(theta2, _EPS),
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), K.shape)
    return eye - 0.5 * K + c[..., None, None] * K2


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------

def se3_identity(dtype=jnp.float32):
    return jnp.eye(4, dtype=dtype)


def se3_from_Rt(R, t):
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    T = jnp.zeros(batch + (4, 4), dtype=R.dtype)
    T = T.at[..., :3, :3].set(jnp.broadcast_to(R, batch + (3, 3)))
    T = T.at[..., :3, 3].set(jnp.broadcast_to(t, batch + (3,)))
    T = T.at[..., 3, 3].set(1.0)
    return T


def se3_R(T):
    return T[..., :3, :3]


def se3_t(T):
    return T[..., :3, 3]


def se3_exp(xi):
    """[...,6] (rho, phi) -> [...,4,4]."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    R = so3_exp(phi)
    V = so3_left_jacobian(phi)
    t = _einsum("...ij,...j->...i", V, rho)
    return se3_from_Rt(R, t)


def se3_log(T):
    phi = so3_log(se3_R(T))
    Vinv = so3_left_jacobian_inv(phi)
    rho = _einsum("...ij,...j->...i", Vinv, se3_t(T))
    return jnp.concatenate([rho, phi], axis=-1)


def se3_inv(T):
    R = se3_R(T)
    t = se3_t(T)
    Rt = jnp.swapaxes(R, -1, -2)
    return se3_from_Rt(Rt, -_einsum("...ij,...j->...i", Rt, t))


def se3_apply(T, X):
    """Transform points X [...,3] by T [...,4,4]."""
    return _einsum("...ij,...j->...i", se3_R(T), X) + se3_t(T)


def se3_normalize(T):
    """Re-orthonormalize the rotation block (drift control in f32)."""
    R = se3_R(T)
    q = mat_to_quat(R)
    return se3_from_Rt(quat_to_mat(q), se3_t(T))


# ---------------------------------------------------------------------------
# Sim(3)
# ---------------------------------------------------------------------------

def sim3_from_Rts(R, t, s):
    """Similarity [...,4,4] storing sR in the rotation block."""
    return se3_from_Rt(R * s[..., None, None], t)


def sim3_Rts(S):
    """Decompose stacked sim3 matrix -> (R, t, s)."""
    A = S[..., :3, :3]
    s = jnp.cbrt(jnp.maximum(jnp.linalg.det(A), _EPS))
    R = A / s[..., None, None]
    return R, S[..., :3, 3], s


def sim3_inv(S):
    R, t, s = sim3_Rts(S)
    Rt = jnp.swapaxes(R, -1, -2)
    sinv = 1.0 / s
    return sim3_from_Rts(Rt, -sinv[..., None] * _einsum("...ij,...j->...i", Rt, t), sinv)


def sim3_apply(S, X):
    return _einsum("...ij,...j->...i", S[..., :3, :3], X) + S[..., :3, 3]


def _sim3_W(phi, sigma):
    """The sim3 'V' matrix coupling (rho, phi, sigma) -> translation."""
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, 0.0))
    s = jnp.exp(sigma)
    K = hat(phi)
    K2 = mm(K, K)
    eps_sig = jnp.abs(sigma) < 1e-5
    eps_th = theta < 1e-5

    A_sig = jnp.where(eps_sig, 0.0, (s - 1.0) / jnp.where(eps_sig, 1.0, sigma))
    C = jnp.where(eps_sig, 1.0, A_sig)

    sig2th2 = sigma * sigma + theta2
    # coefficients for the general case (Strasdat's thesis)
    a_gen = (s * jnp.sin(theta) * sigma + (1.0 - s * jnp.cos(theta)) * theta) / jnp.maximum(
        theta * sig2th2, _EPS
    )
    b_gen = (
        C
        - ((s * jnp.cos(theta) - 1.0) * sigma + s * jnp.sin(theta) * theta)
        / jnp.maximum(sig2th2, _EPS)
    ) / jnp.maximum(theta2, _EPS)
    # theta -> 0 limits
    a_th0 = jnp.where(
        eps_sig, 0.5, ((sigma - 1.0) * s + 1.0) / jnp.maximum(sigma * sigma, _EPS)
    )
    b_th0 = jnp.where(
        eps_sig,
        1.0 / 6.0,
        (s * 0.5 * sigma * sigma + s - 1.0 - sigma * s) / jnp.maximum(sigma * sigma * sigma, _EPS),
    )
    A = jnp.where(eps_th, a_th0, a_gen)
    B = jnp.where(eps_th, b_th0, b_gen)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), K.shape)
    return C[..., None, None] * eye + A[..., None, None] * K + B[..., None, None] * K2


def sim3_exp(xi):
    """[...,7] (rho, phi, sigma) -> [...,4,4] with sR block."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    R = so3_exp(phi)
    s = jnp.exp(sigma)
    W = _sim3_W(phi, sigma)
    t = _einsum("...ij,...j->...i", W, rho)
    return sim3_from_Rts(R, t, s)


def sim3_log(S):
    R, t, s = sim3_Rts(S)
    phi = so3_log(R)
    sigma = jnp.log(s)
    W = _sim3_W(phi, sigma)
    rho = jnp.linalg.solve(W, t[..., None])[..., 0]
    return jnp.concatenate([rho, phi, sigma[..., None]], axis=-1)


def se3_to_sim3(T):
    return T  # scale 1 embeds directly


def sim3_to_se3(S):
    R, t, _ = sim3_Rts(S)
    return se3_from_Rt(R, t)
