"""Sparse inverse-compositional Lucas-Kanade image alignment on SE(3).

The semi-direct core: the equivalent of ImageAlign
(/root/reference/src/ImageAlign.{h,cc}): take <=N_pts map-backed keypoints of
a reference frame, cache 4x4 photometric patches + 6-DoF Jacobians at the
reference (PrecomputePatches, ImageAlign.cc:355-421), then Gauss-Newton over
pyramid levels coarse->fine, updating T_cur_ref <- T_cur_ref * Exp(-delta)
with chi2 rollback (Optimize/ComputeResiduals, ImageAlign.cc:234-353).

Design: the per-point/per-pixel loops become one batched [N, 16]
residual/Jacobian computation per iteration; the iteration loop is a
lax.while_loop; levels are a static unrolled loop.  Default settings follow
the reference ctor (ImageAlign.cc:36-39): patch half-size 2 (4x4), levels
4->2, 30 iterations; error thresholds 0.01 (frame-KF fast) / 0.03 (KF-KF).

Intensities are treated in [0,255] but residuals are normalized by 255 so
the `error` return matches the reference's thresholds.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp

from sdslam_tpu.geometry import lie
from sdslam_tpu.ops import interp
from sdslam_tpu.ops import sample as _s

PATCH_HALF = 2
PATCH_AREA = (2 * PATCH_HALF) ** 2  # 4x4 = 16

class AlignResult(NamedTuple):
    T_cur_ref: jnp.ndarray  # [4,4]
    error: jnp.ndarray  # scalar: mean squared normalized residual at finest level
    n_meas: jnp.ndarray  # number of valid pixels in final iteration


def _patch_offsets():
    d = jnp.arange(-PATCH_HALF, PATCH_HALF, dtype=jnp.float32)
    dy, dx = jnp.meshgrid(d, d, indexing="ij")
    return jnp.stack([dx.ravel(), dy.ravel()], axis=-1)  # [16,2] (x,y)


def _proj_jac_se3(Xc, fx, fy):
    """d(u,v)/d(xi) for residual e(xi) = I_cur(proj(T*Exp(xi)*X)) - I_ref.

    xi = (rho, phi) right-perturbation. Standard SVO 'jacobian_xyz2uv'
    structure: rows scaled by focal length of the level.
    """
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    zi = 1.0 / jnp.maximum(z, 1e-6)
    zi2 = zi * zi
    xy = x * y
    row_u = jnp.stack(
        [zi, jnp.zeros_like(x), -x * zi2, -xy * zi2, 1.0 + x * x * zi2, -y * zi],
        axis=-1,
    ) * fx
    row_v = jnp.stack(
        [jnp.zeros_like(x), zi, -y * zi2, -(1.0 + y * y * zi2), xy * zi2, x * zi],
        axis=-1,
    ) * fy
    return jnp.stack([row_u, row_v], axis=-2)  # [...,2,6]


def _precompute_level(ref_img, uv_ref_l, X_ref, valid, fx_l, fy_l):
    """Cache reference patches + Jacobians at one level.

    Returns (ref_patch [N,16], J [N,16,6], valid_px [N,16]).
    """
    offs = _patch_offsets()  # [16,2]
    uv = uv_ref_l[:, None, :] + offs[None, :, :]  # [N,16,2]
    val, gx, gy, ok = interp.bilinear_sample_with_grad(ref_img, uv)
    Jproj = _proj_jac_se3(X_ref, fx_l, fy_l)  # [N,2,6]
    # image gradient (per pixel) chained with projection Jacobian (per point)
    J = gx[..., None] * Jproj[:, None, 0, :] + gy[..., None] * Jproj[:, None, 1, :]
    ok = ok & valid[:, None]
    return val, J / 255.0, ok


def _damped_cho(H, lm_lambda=1e-5):
    """Cholesky factor of the level's fixed, trace-damped GN matrix."""
    Hr = H + lm_lambda * jnp.eye(6, dtype=H.dtype) * jnp.maximum(
        jnp.trace(H) / 6.0, 1e-8
    )
    return jax.scipy.linalg.cho_factor(Hr, lower=True)


def _gn_matrix(J, ok):
    return jnp.einsum("npi,npj->ij", jnp.where(ok[..., None], J, 0.0), J,
                      precision=jax.lax.Precision.HIGHEST)


def _align_level(cur_img, T_init, X_ref, ref_patch, J, ok, fx_l, fy_l, cx_l,
                 cy_l, iters):
    """GN iterations at one level (inverse compositional: J fixed, so the
    damped GN matrix is factored once per level)."""
    L = _damped_cho(_gn_matrix(J, ok))

    def gn_terms(T):
        """(b [6], chi2, n) at iterate T."""
        Xc = lie.se3_apply(T, X_ref)  # [N,3]
        z_ok = Xc[:, 2] > 0.01
        u = fx_l * Xc[:, 0] / jnp.maximum(Xc[:, 2], 1e-6) + cx_l
        v = fy_l * Xc[:, 1] / jnp.maximum(Xc[:, 2], 1e-6) + cy_l
        # patch offsets are integers: the patch-structured sampler shares
        # one fractional weight across all 16 taps
        cur, cur_ok = _s.sample_bilinear_patch(
            cur_img, jnp.stack([u, v], -1), PATCH_HALF
        )
        m = ok & cur_ok & z_ok[:, None]
        r = jnp.where(m, (cur - ref_patch) / 255.0, 0.0)
        n = jnp.maximum(jnp.sum(m), 1)
        chi2 = jnp.sum(r * r) / n
        b = jnp.einsum("npi,np->i", jnp.where(m[..., None], J, 0.0), r,
                       precision=jax.lax.Precision.HIGHEST)
        return b, chi2, n

    def body(carry):
        T, best_T, best_chi2, it, _ = carry
        b, chi2, n = gn_terms(T)
        improved = chi2 < best_chi2
        best_T = jnp.where(improved, T, best_T)
        best_chi2 = jnp.minimum(chi2, best_chi2)
        # IC-LK: delta = H^-1 sum(J^T r), warp update T <- T * Exp(-delta)
        delta = jax.scipy.linalg.cho_solve(L, b)
        T_next = lie.mm(T, lie.se3_exp(-delta))
        # stop on convergence or on chi2 increase (reference rollback
        # semantics, ImageAlign.cc:251-266: revert and break)
        stop = (jnp.max(jnp.abs(delta)) < 1e-7) | ((it > 0) & (~improved))
        return T_next, best_T, best_chi2, it + 1, stop

    def cond(carry):
        _, _, _, it, stop = carry
        return (it < iters) & (~stop)

    # canonical carry dtypes (weak types break while_loop under shard_map)
    T0 = jnp.asarray(T_init, jnp.float32)
    init = (
        T0, T0, jnp.asarray(jnp.inf, jnp.float32),
        jnp.asarray(0, jnp.int32), jnp.asarray(False),
    )
    T, best_T, best_chi2, _, _ = jax.lax.while_loop(cond, body, init)
    # the last iterate was never chi2-evaluated inside the loop
    _, chi2_T, n_T = gn_terms(T)
    T_out = jnp.where(chi2_T <= best_chi2, T, best_T)
    chi2_out = jnp.minimum(chi2_T, best_chi2)
    return T_out, chi2_out, n_T


@functools.partial(
    jax.jit,
    static_argnames=(
        "fx", "fy", "cx", "cy", "scale_factor", "max_level", "min_level",
        "iters", "start_level",
    ),
)
def align(
    ref_pyramid: Tuple[jnp.ndarray, ...],
    cur_pyramid: Tuple[jnp.ndarray, ...],
    uv_ref,  # [N,2] keypoint coords at level-0 scale (raw/distorted, as stored)
    X_ref,  # [N,3] 3D points in the REFERENCE camera frame
    valid,  # [N] bool (map-backed keypoints only)
    T_cur_ref_init,  # [4,4]
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    scale_factor: float = 2.0,
    max_level: int = 4,
    min_level: int = 2,
    iters: int = 30,
    start_level: int = 0,
) -> AlignResult:
    """Coarse-to-fine sparse LK alignment. Returns T such that
    X_cur = T @ X_ref.

    start_level: pyramid tuples may begin at a coarser level than 0 (keyframe
    storage keeps only levels >= 2); entry i corresponds to level
    (i + start_level)."""
    T = T_cur_ref_init
    chi2 = jnp.asarray(0.0, jnp.float32)
    n = jnp.asarray(0, jnp.int32)
    max_level = min(max_level, len(ref_pyramid) - 1 + start_level)
    min_level = max(min_level, start_level)
    for lvl in range(max_level, min_level - 1, -1):
        s = 1.0 / (scale_factor**lvl)
        ref_img = ref_pyramid[lvl - start_level]
        cur_img = cur_pyramid[lvl - start_level]
        uv_l = uv_ref * s
        patch, J, ok = _precompute_level(ref_img, uv_l, X_ref, valid, fx * s, fy * s)
        T, chi2, n = _align_level(
            cur_img, T, X_ref, patch, J, ok, fx * s, fy * s, cx * s, cy * s,
            iters,
        )
    return AlignResult(T, chi2, n)
