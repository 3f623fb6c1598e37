"""ORB orientation + binary descriptors, batched over keypoints.

Replaces ORBextractor's IC_Angle and computeOrbDescriptor
(/root/reference/src/ORBextractor.cc:78-143).  Design differences from the
reference (intentional):

  * The BRIEF point-pair pattern is NOT the OpenCV learned `bit_pattern_31_`
    table (we do not copy reference data).  We generate a deterministic
    pseudo-random Gaussian pattern (original BRIEF recipe: sigma = patch/5,
    norm-clipped) with a fixed seed.  The framework is self-consistent:
    descriptors are only ever matched against descriptors produced here.
  * Descriptor sampling uses true rotation of the pattern with
    nearest-pixel gather on the blurred level image — one big batched gather
    instead of per-keypoint pointer walks.
  * Descriptors are packed as [N, 8] uint32 (256 bits); ops/hamming.py
    turns them into dense Hamming distances.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

HALF_PATCH = 15  # orientation patch radius (31x31), as in the reference
PATTERN_BITS = 256
PATTERN_RADIUS = 13  # pattern points norm-clipped to this radius
DESC_WORDS = 8  # 256 bits / 32


@functools.lru_cache()
def _circular_mask() -> np.ndarray:
    d = np.arange(-HALF_PATCH, HALF_PATCH + 1)
    yy, xx = np.meshgrid(d, d, indexing="ij")
    return (yy * yy + xx * xx <= HALF_PATCH * HALF_PATCH).astype(np.float32)


@functools.lru_cache()
def brief_pattern(seed: int = 1234) -> np.ndarray:
    """[256, 2, 2] int32 point pairs (x, y), Gaussian sigma=patch/5, radius<=13."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, (2 * PATTERN_RADIUS + 1) / 5.0, size=(PATTERN_BITS, 2, 2))
    norm = np.linalg.norm(pts, axis=-1, keepdims=True)
    scale = np.minimum(1.0, PATTERN_RADIUS / np.maximum(norm, 1e-6))
    pts = np.round(pts * scale).astype(np.int32)
    # avoid degenerate identical pairs
    same = (pts[:, 0] == pts[:, 1]).all(axis=-1)
    pts[same, 1, 0] += 1
    return pts


N_ANGLE_BINS = 30  # 12 deg, the ORB paper's steered-BRIEF discretization
PATCH_R = 14  # descriptor sampling patch radius (pattern radius 13 rotated)
PATCH_W = 2 * PATCH_R + 1  # 29


def moment_maps(img):
    """Whole-image circular-patch intensity moments (m10, m01), [2,H,W].

    m10(p) = sum_{|d|<=R, circular} dx * I(p+d); computing the dense maps
    with column/row prefix sums is O(R) shifted adds per pixel instead of a
    per-keypoint [N,31,31] scattered gather. Border
    pixels wrap (jnp.roll) — irrelevant because keypoints keep a 19px border.
    """
    R = HALF_PATCH
    # m10: for each dx column, sum I over dy in [-h(dx), h(dx)] then weight dx
    csy = jnp.cumsum(img, axis=0)
    zero = jnp.zeros((1, img.shape[1]), img.dtype)
    csy = jnp.concatenate([zero, csy], axis=0)  # csy[i] = sum rows < i
    m10 = jnp.zeros_like(img)
    for dx in range(-R, R + 1):
        if dx == 0:
            continue
        h = int(np.floor(np.sqrt(R * R - dx * dx)))
        # colsum(y,x) = sum_{dy=-h..h} I[y+dy, x] = csy[y+h+1] - csy[y-h]
        col = jnp.roll(csy[1:], -h, axis=0) - jnp.roll(csy[:-1], h, axis=0)
        m10 = m10 + float(dx) * jnp.roll(col, -dx, axis=1)
    csx = jnp.cumsum(img, axis=1)
    zero = jnp.zeros((img.shape[0], 1), img.dtype)
    csx = jnp.concatenate([zero, csx], axis=1)
    m01 = jnp.zeros_like(img)
    for dy in range(-R, R + 1):
        if dy == 0:
            continue
        w = int(np.floor(np.sqrt(R * R - dy * dy)))
        row = jnp.roll(csx[:, 1:], -w, axis=1) - jnp.roll(csx[:, :-1], w, axis=1)
        m01 = m01 + float(dy) * jnp.roll(row, -dy, axis=0)
    return m10, m01


def orientations(img, uv, valid):
    """Intensity-centroid angles (radians) for keypoints uv [N,2] on img [H,W].

    Equivalent of IC_Angle (ORBextractor.cc:78-102) with a circular mask,
    computed as dense moment maps + a matmul point-read (ops/sample.py).
    """
    from sdslam_tpu.ops import sample as smp

    m10, m01 = moment_maps(img)
    k10 = smp.sample_nearest(m10, uv)
    k01 = smp.sample_nearest(m01, uv)
    ang = jnp.arctan2(k01, k10)
    return jnp.where(valid, ang, 0.0)


@functools.lru_cache()
def _binned_diff_matrices(seed: int = 1234) -> np.ndarray:
    """[N_ANGLE_BINS, PATCH_W*PATCH_W, 256] f32: for angle bin b, column s is
    onehot(rotate(p1_s, theta_b)) - onehot(rotate(p0_s, theta_b)) in patch
    space, so  bit_s = (patch_flat @ D_b)[s] > 0  reproduces steered BRIEF
    with the ORB paper's 2*pi/30 angle discretization."""
    pat = brief_pattern(seed).astype(np.float64)  # [256,2,2] (x,y)
    D = np.zeros((N_ANGLE_BINS, PATCH_W * PATCH_W, PATTERN_BITS), np.float32)
    for b in range(N_ANGLE_BINS):
        th = 2.0 * np.pi * b / N_ANGLE_BINS
        ca, sa = np.cos(th), np.sin(th)
        rx = np.round(ca * pat[:, :, 0] - sa * pat[:, :, 1]).astype(np.int64)
        ry = np.round(sa * pat[:, :, 0] + ca * pat[:, :, 1]).astype(np.int64)
        q = (ry + PATCH_R) * PATCH_W + (rx + PATCH_R)  # [256,2]
        for s in range(PATTERN_BITS):
            D[b, q[s, 1], s] += 1.0
            D[b, q[s, 0], s] -= 1.0
    return D


def extract_patches(img, uv, half: int,
                    precision=jax.lax.Precision.HIGHEST):
    """[N, 2h+1, 2h+1] integer-centered patches via row one-hot matmul +
    column one-hot contraction (no scattered gather). Full float32 by
    default: in TF32 the copied intensities would lose their low bits."""
    H, W = img.shape
    N = uv.shape[0]
    w = 2 * half + 1
    x0 = jnp.round(uv[:, 0]).astype(jnp.int32)
    y0 = jnp.round(uv[:, 1]).astype(jnp.int32)
    d = jnp.arange(-half, half + 1)
    ry = jnp.clip(y0[:, None] + d[None, :], 0, H - 1)  # [N,w]
    rxc = jnp.clip(x0[:, None] + d[None, :], 0, W - 1)
    oy = (ry[..., None] == jnp.arange(H)[None, None, :]).astype(jnp.float32)
    rows = jnp.matmul(oy.reshape(N * w, H), img,
                      precision=precision).reshape(N, w, W)
    ox = (rxc[..., None] == jnp.arange(W)[None, None, :]).astype(jnp.float32)
    # patch[n, r, j] = rows[n, r, x0+dj]
    patch = jnp.einsum("nrw,njw->nrj", rows, ox, precision=precision)
    return patch


def descriptors(img_blurred, uv, angle, valid):
    """Steered-BRIEF 256-bit descriptors -> [N, 8] uint32.

    img_blurred: level image after Gaussian blur (sigma 2, 7x7).
    uv: keypoint coords at this level. angle: radians.

    The angle is quantized to 30 bins (the ORB paper's discretization); each
    bin has a precomputed sparse +-1 difference matrix, so all 256 pair
    comparisons for a keypoint are ONE [N, 841] x [841, 256] matmul, at full
    float32 so that a pair's difference is exact: the +-1 weights select
    exactly two pixels).
    """
    N = uv.shape[0]
    patch = extract_patches(img_blurred, uv, PATCH_R).reshape(N, -1)
    D = jnp.asarray(_binned_diff_matrices())  # [B,841,256]
    two_pi = 2.0 * jnp.pi
    bin_f = jnp.round(jnp.mod(angle, two_pi) / (two_pi / N_ANGLE_BINS))
    bin_i = jnp.mod(bin_f.astype(jnp.int32), N_ANGLE_BINS)
    onehot_b = (
        bin_i[:, None] == jnp.arange(N_ANGLE_BINS)[None, :]
    ).astype(jnp.float32)
    # diffs[n,s] = patch[n] @ D[bin(n)]: 30 shared matmuls + bin selection
    hi = jax.lax.Precision.HIGHEST
    per_bin = jnp.einsum("nq,bqs->nbs", patch, D, precision=hi)  # [N,B,256]
    diffs = jnp.einsum("nb,nbs->ns", onehot_b, per_bin, precision=hi)
    bits = (diffs > 0).astype(jnp.uint32)  # [N,256]
    words = bits.reshape(N, DESC_WORDS, 32)
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))[None, None, :]
    desc = jnp.sum(words * weights, axis=-1, dtype=jnp.uint32)
    return jnp.where(valid[:, None], desc, jnp.uint32(0))
