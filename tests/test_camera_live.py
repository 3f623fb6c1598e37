"""Live V4L2 camera front-end: conversion + ABI unit tests; real-device
capture runs only when /dev/video0 exists (it does not on headless hosts)."""

import os

import numpy as np
import pytest

from sdslam_tpu.io import camera as C


def test_yuyv_to_gray_extracts_y_plane():
    w, h = 8, 4
    y = np.arange(w * h, dtype=np.uint8).reshape(h, w)
    buf = np.zeros((h, w, 2), np.uint8)
    buf[:, :, 0] = y  # Y plane
    buf[:, :, 1] = 128  # chroma
    out = C.yuyv_to_gray(buf.tobytes(), w, h)
    np.testing.assert_array_equal(out, y)


def test_mjpg_to_gray_roundtrip():
    from io import BytesIO

    from PIL import Image

    img = (np.random.default_rng(0).uniform(0, 255, (32, 48))).astype(np.uint8)
    b = BytesIO()
    Image.fromarray(img).convert("L").save(b, "JPEG", quality=95)
    out = C.mjpg_to_gray(b.getvalue())
    assert out.shape == (32, 48)
    assert np.abs(out.astype(float) - img).mean() < 4.0  # JPEG loss only


def test_ioctl_numbers_match_kernel_abi():
    """Spot-check the hand-built _IOC encodings against the known kernel
    values (videodev2.h, x86_64)."""
    assert C.VIDIOC_QUERYCAP == 0x80685600
    assert C.VIDIOC_S_FMT == 0xC0D05605
    assert C.VIDIOC_REQBUFS == 0xC0145608
    assert C.VIDIOC_QBUF == 0xC058560F
    assert C.VIDIOC_DQBUF == 0xC0585611
    assert C.VIDIOC_STREAMON == 0x40045612


def test_fourcc():
    assert C.PIX_YUYV == 0x56595559
    assert C.PIX_MJPG == 0x47504A4D


@pytest.mark.skipif(
    not os.path.exists("/dev/video0"), reason="no capture device"
)
def test_live_capture_device():  # pragma: no cover - hardware-gated
    with C.V4L2Camera("/dev/video0", 640, 480) as cam:
        ts, img = cam.read()
        assert img.ndim == 2 and img.dtype == np.uint8
