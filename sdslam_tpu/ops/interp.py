"""Bilinear sampling + image gradients (batched, mask-returning).

Thin compatibility layer over ops.sample: sampling is implemented as one-hot
weight matmuls. See ops/sample.py for the idiom.
"""

from __future__ import annotations

from sdslam_tpu.ops import sample as _s


def bilinear_sample(img, uv):
    """Sample img [H,W] at float coords uv [...,2] (x,y).

    Returns (values [...], valid [...]) where valid marks samples whose 2x2
    support is fully inside the image; out-of-bounds values are 0.
    """
    return _s.sample_bilinear(img, uv)


def bilinear_sample_with_grad(img, uv):
    """Sample value and central-difference gradient at uv.

    Returns (val, gx, gy, valid); gradient support needs a 1px margin more.
    """
    return _s.sample_bilinear_with_grad(img, uv)
