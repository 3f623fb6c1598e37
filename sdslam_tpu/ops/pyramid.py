"""Image pyramid ops (replaces ORBextractor::ComputePyramid,
/root/reference/src/ORBextractor.cc:680-700).

The reference default config uses scale_factor=2.0 with 5 levels
(Examples/Example.yaml:40-46) — a deliberately coarse pyramid because the
direct ImageAlign path runs on levels 2-4. Dyadic scaling lets us use an
exact blur+stride-2 downsample, which XLA fuses into one conv per level.
Non-dyadic factors fall back to jax.image.resize.
"""

from __future__ import annotations

import functools
from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np


def gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _sep_conv2d(img, k1d):
    """Separable 2D convolution with edge replication, img [H,W] f32.

    Implemented as sliced multiply-adds (fully fused elementwise work)
    instead of a 1-channel lax.conv."""
    r = (len(k1d) - 1) // 2
    H, W = img.shape
    xp = jnp.pad(img, ((0, 0), (r, r)), mode="edge")
    x = sum(float(k1d[i]) * xp[:, i : i + W] for i in range(2 * r + 1))
    xp = jnp.pad(x, ((r, r), (0, 0)), mode="edge")
    return sum(float(k1d[i]) * xp[i : i + H, :] for i in range(2 * r + 1))


def gaussian_blur(img, sigma: float = 2.0, radius: int = 3):
    """7x7 Gaussian blur (the ORB pre-descriptor blur, ORBextractor.cc:~665)."""
    return _sep_conv2d(img, gaussian_kernel1d(sigma, radius))


def downsample2(img):
    """Anti-aliased exact 2x downsample: 5-tap blur then stride 2.

    Decimation is a plain strided lax.slice."""
    blurred = _sep_conv2d(img, gaussian_kernel1d(1.0, 2))
    H, W = blurred.shape
    Hp, Wp = H + (H & 1), W + (W & 1)
    if (Hp, Wp) != (H, W):
        blurred = jnp.pad(blurred, ((0, Hp - H), (0, Wp - W)), mode="edge")
    return jax.lax.slice(blurred, (0, 0), (Hp, Wp), (2, 2))


def level_scales(n_levels: int, scale_factor: float) -> List[float]:
    return [scale_factor**i for i in range(n_levels)]


def build_pyramid(img, n_levels: int, scale_factor: float = 2.0):
    """img [H,W] float32 -> list of levels [H/s, W/s]."""
    levels = [img]
    for i in range(1, n_levels):
        prev = levels[-1]
        if scale_factor == 2.0:
            levels.append(downsample2(prev))
        else:
            h = int(round(img.shape[0] / scale_factor**i))
            w = int(round(img.shape[1] / scale_factor**i))
            levels.append(
                jax.image.resize(gaussian_blur(prev, 0.8), (h, w), "linear")
            )
    return levels


def level_quotas(n_total: int, n_levels: int, scale_factor: float) -> List[int]:
    """Geometric per-level feature quotas (ORBextractor.cc:424-434 behavior)."""
    inv = 1.0 / scale_factor
    weights = np.array([inv**i for i in range(n_levels)])
    weights /= weights.sum()
    q = np.floor(n_total * weights).astype(int)
    q[0] += n_total - q.sum()
    return [int(v) for v in q]
