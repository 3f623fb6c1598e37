"""Point sampling from images as one-hot MATMULS instead of gathers.

The formulation expands the row index to a one-hot (or two-hot
bilinear-weight) matrix and contracts,

    rows = W_y [B,H] @ img [H,W]          (one matmul)
    out  = sum(rows * W_x [B,W], axis=-1) (one fused reduce)

which is exact for nearest sampling (0/1 weights) and exact-in-f32 for
bilinear at precision=HIGHEST. Cost is B*H*W MACs — e.g. 1024 points on
640x480 = 0.3 GMAC. It was chosen for hardware where a scattered gather is
slow; whether a plain gather is faster on the GPU is an open measurement
(PERF.md).

Replaces the gather-based interp used by ImageAlign's PrecomputePatches /
ComputeResiduals equivalents (/root/reference/src/ImageAlign.cc:281-421)
and the per-keypoint reads in ORBextractor (ORBextractor.cc:78-143).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST


def _row_weights_nearest(idx, size):
    """[B] int32 -> [B, size] one-hot f32 (clamped)."""
    idx = jnp.clip(idx, 0, size - 1)
    return (idx[:, None] == jnp.arange(size)[None, :]).astype(jnp.float32)


def _row_weights_linear(x0c, w, size, shift=0):
    """Two-hot linear weights: (1-w) at x0c+shift, w at x0c+1+shift."""
    ar = jnp.arange(size)[None, :]
    i0 = jnp.clip(x0c + shift, 0, size - 1)[:, None]
    i1 = jnp.clip(x0c + 1 + shift, 0, size - 1)[:, None]
    return (ar == i0) * (1.0 - w[:, None]) + (ar == i1) * w[:, None]


def sample_nearest(img, uv, precision=_HI):
    """img [H,W], uv [...,2] float (x,y) -> values [...] at round(uv), clamped."""
    H, W = img.shape
    shp = uv.shape[:-1]
    x = jnp.round(uv[..., 0].reshape(-1)).astype(jnp.int32)
    y = jnp.round(uv[..., 1].reshape(-1)).astype(jnp.int32)
    WY = _row_weights_nearest(y, H)
    rows = jnp.matmul(WY, img, precision=precision)
    WX = _row_weights_nearest(x, W)
    out = jnp.sum(rows * WX, axis=-1)
    return out.reshape(shp)


def sample_bilinear(img, uv, precision=_HI):
    """Bilinear sample; returns (values [...], valid [...]).

    valid marks samples whose 2x2 support is fully inside; OOB values are 0.
    Matches the semantics of the gather-based interp.bilinear_sample.
    """
    H, W = img.shape
    shp = uv.shape[:-1]
    x = uv[..., 0].reshape(-1)
    y = uv[..., 1].reshape(-1)
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    wx = x - x0
    wy = y - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)
    valid = (x0i >= 0) & (x0i < W - 1) & (y0i >= 0) & (y0i < H - 1)
    x0c = jnp.clip(x0i, 0, W - 2)
    y0c = jnp.clip(y0i, 0, H - 2)
    WY = _row_weights_linear(y0c, wy, H)
    rows = jnp.matmul(WY, img, precision=precision)  # [B,W]
    WX = _row_weights_linear(x0c, wx, W)
    out = jnp.sum(rows * WX, axis=-1)
    out = jnp.where(valid, out, 0.0)
    return out.reshape(shp), valid.reshape(shp)


def sample_bilinear_patch(img, uv_center, patch_half=2, precision=_HI):
    """Bilinear-sample a (2*patch_half)^2 patch of INTEGER offsets around
    each center: exploits floor(u + d) = floor(u) + d for integer d, so all
    patch taps share one fractional weight and the row matmul shrinks from
    [16N, H] @ [H, W] to 2*patch_half shifted two-hot [N, H] @ [H, W]
    matmuls (4x less matmul work for the aligner's 4x4 patches).

    Returns (values [N, P*P], valid [N, P*P]) in dy-outer/dx-inner order,
    exactly matching sample_bilinear on uv_center + integer offsets.
    """
    H, W = img.shape
    P = 2 * patch_half
    x = uv_center[:, 0]
    y = uv_center[:, 1]
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    wx = x - x0
    wy = y - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)
    x0c = jnp.clip(x0i, 0, W - 2)
    y0c = jnp.clip(y0i, 0, H - 2)

    rows = [
        jnp.matmul(
            _row_weights_linear(y0c, wy, H, shift=pr - patch_half),
            img, precision=precision,
        )
        for pr in range(P)
    ]  # P x [N, W], y-interpolated at row offset pr-patch_half
    cols = [
        _row_weights_linear(x0c, wx, W, shift=pc - patch_half)
        for pc in range(P)
    ]
    vals = []
    valid = []
    for pr in range(P):
        yok = (y0i + (pr - patch_half) >= 0) & (y0i + (pr - patch_half) < H - 1)
        for pc in range(P):
            vals.append(jnp.sum(rows[pr] * cols[pc], axis=-1))
            xok = (x0i + (pc - patch_half) >= 0) & (
                x0i + (pc - patch_half) < W - 1
            )
            valid.append(xok & yok)
    out = jnp.stack(vals, axis=1)
    ok = jnp.stack(valid, axis=1)
    return jnp.where(ok, out, 0.0), ok


def sample_bilinear_with_grad(img, uv, precision=_HI):
    """Bilinear value + central-difference gradient, one extra matmul.

    gx at uv = 0.5*(f(x+1,y) - f(x-1,y)): same row weights, column weights
    shifted by +-1. gy symmetric with shifted row weights. Returns
    (val, gx, gy, valid) matching interp.bilinear_sample_with_grad.
    """
    H, W = img.shape
    shp = uv.shape[:-1]
    x = uv[..., 0].reshape(-1)
    y = uv[..., 1].reshape(-1)
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    wx = x - x0
    wy = y - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)
    # the 5-sample cross needs a 1px margin beyond the bilinear support
    valid = (x0i >= 1) & (x0i < W - 2) & (y0i >= 1) & (y0i < H - 2)
    x0c = jnp.clip(x0i, 0, W - 2)
    y0c = jnp.clip(y0i, 0, H - 2)

    WY = _row_weights_linear(y0c, wy, H)
    WYg = 0.5 * (
        _row_weights_linear(y0c, wy, H, shift=1)
        - _row_weights_linear(y0c, wy, H, shift=-1)
    )
    rows = jnp.matmul(WY, img, precision=precision)
    rows_g = jnp.matmul(WYg, img, precision=precision)
    WX = _row_weights_linear(x0c, wx, W)
    WXg = 0.5 * (
        _row_weights_linear(x0c, wx, W, shift=1)
        - _row_weights_linear(x0c, wx, W, shift=-1)
    )
    val = jnp.sum(rows * WX, axis=-1)
    gx = jnp.sum(rows * WXg, axis=-1)
    gy = jnp.sum(rows_g * WX, axis=-1)
    z = jnp.zeros_like(val)
    val = jnp.where(valid, val, z)
    gx = jnp.where(valid, gx, z)
    gy = jnp.where(valid, gy, z)
    return (
        val.reshape(shp),
        gx.reshape(shp),
        gy.reshape(shp),
        valid.reshape(shp),
    )
