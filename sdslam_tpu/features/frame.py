"""Frame construction: ORB pyramid extraction + per-keypoint channels.

Array replacement for the reference's Frame + ORBextractor pair
(/root/reference/src/Frame.{h,cc}, src/ORBextractor.{h,cc}).  A Frame is a
pytree of fixed-shape arrays: keypoints padded to a static capacity with a
validity mask, descriptors packed as uint32 words, and the stored image
pyramid needed by the direct ImageAlign path (Frame.h:183).

The reference's 64x48 feature grid (Frame.h:37-38, AssignFeaturesToGrid) is
deliberately absent: windowed searches are done as dense masked [N,M]
distance computations, which replace a grid lookup at these sizes (N, M <= 1024).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from sdslam_tpu.geometry import camera as cam_mod
from sdslam_tpu.geometry.camera import CameraModel
from sdslam_tpu.ops import fast as fast_ops
from sdslam_tpu.ops import orb as orb_ops
from sdslam_tpu.ops import pyramid as pyr_ops
from sdslam_tpu.utils.config import ORBConfig


class FrameFeatures(NamedTuple):
    uv: jnp.ndarray  # [N,2] float32, raw pixel coords at level-0 scale
    uv_und: jnp.ndarray  # [N,2] float32, undistorted coords
    octave: jnp.ndarray  # [N] int32 pyramid level
    angle: jnp.ndarray  # [N] float32 radians
    score: jnp.ndarray  # [N] float32 FAST score
    desc: jnp.ndarray  # [N,8] uint32 packed 256-bit descriptors
    valid: jnp.ndarray  # [N] bool

    @property
    def capacity(self) -> int:
        return self.uv.shape[0]


class Frame(NamedTuple):
    features: FrameFeatures
    pyramid: Tuple[jnp.ndarray, ...]  # stored for direct alignment
    depth: jnp.ndarray  # [N] per-keypoint depth (>0) or -1 (mono / no reading)
    uright: jnp.ndarray  # [N] virtual right coord u - bf/d, or -1
    Tcw: jnp.ndarray  # [4,4]


def _extract_static(pyramid, quotas, scale_factor, threshold, cell, border):
    """Core extraction over a built pyramid. All params static."""
    uvs, octs, angs, scores, valids, descs = [], [], [], [], [], []
    for lvl, img in enumerate(pyramid):
        q = quotas[lvl]
        if q <= 0:
            continue
        uv_l, sc, val = fast_ops.detect_keypoints(
            img, q, threshold=threshold, cell=cell, border=border
        )
        ang = orb_ops.orientations(img, uv_l, val)
        blurred = pyr_ops.gaussian_blur(img)
        d = orb_ops.descriptors(blurred, uv_l, ang, val)
        s = scale_factor**lvl
        uvs.append(uv_l * s)
        octs.append(jnp.full((q,), lvl, jnp.int32))
        angs.append(ang)
        scores.append(sc)
        valids.append(val)
        descs.append(d)
    return (
        jnp.concatenate(uvs),
        jnp.concatenate(octs),
        jnp.concatenate(angs),
        jnp.concatenate(scores),
        jnp.concatenate(valids),
        jnp.concatenate(descs),
    )


class ORBExtractor:
    """Jitted ORB front-end bound to a camera + config (static shapes).

    Equivalent capability to ORBextractor::operator()
    (/root/reference/src/ORBextractor.cc:620-678): returns both the padded
    keypoint set and the pyramid.
    """

    def __init__(self, cam: CameraModel, cfg: ORBConfig):
        self.cam = cam
        self.cfg = cfg
        # the REQUESTED feature budget (ORBextractor.nFeatures, distributed
        # geometrically across levels like ORBextractor.cc:424-434) drives
        # extraction; arrays are padded up to the static max_keypoints
        # capacity so downstream shapes are config-independent
        n_req = min(cfg.n_features, cfg.max_keypoints)
        self.quotas = tuple(
            pyr_ops.level_quotas(n_req, cfg.n_levels, cfg.scale_factor)
        )
        self._pad = cfg.max_keypoints - sum(self.quotas)

        def _core(img):
            pyramid = pyr_ops.build_pyramid(img, cfg.n_levels, cfg.scale_factor)
            uv, octv, ang, score, valid, desc = _extract_static(
                pyramid,
                self.quotas,
                cfg.scale_factor,
                float(cfg.fast_threshold),
                16,
                19,
            )
            if self._pad > 0:
                p = self._pad
                uv = jnp.pad(uv, ((0, p), (0, 0)))
                octv = jnp.pad(octv, (0, p))
                ang = jnp.pad(ang, (0, p))
                score = jnp.pad(score, (0, p))
                valid = jnp.pad(valid, (0, p))
                desc = jnp.pad(desc, ((0, p), (0, 0)))
            uv_und = cam_mod.undistort_pixels(cam, uv)
            feats = FrameFeatures(uv, uv_und, octv, ang, score, desc, valid)
            return feats, tuple(pyramid)

        def _core_full(img, depth_img, depth_factor):
            """Unjitted extraction core: composes into larger fused programs
            (the whole per-frame loop is ONE device program in the tracker).
            depth_img=None -> mono (-1 depth/uright channels)."""
            img = img.astype(jnp.float32)
            feats, pyramid = _core(img)
            n = feats.uv.shape[0]
            if depth_img is None:
                d = jnp.full((n,), -1.0, jnp.float32)
                uright = jnp.full((n,), -1.0, jnp.float32)
                return feats, pyramid, d, uright
            # uint8 images / uint16 depth upload 2.7x fewer bytes than f32;
            # all casting happens on-device
            dimg = depth_img.astype(jnp.float32)
            if depth_factor != 1.0:
                dimg = dimg / depth_factor
            from sdslam_tpu.ops import sample as smp

            # depth may arrive DECIMATED 2x (pack_frame half-res transport:
            # the depth plane is half the camera payload, and per-keypoint
            # nearest sampling only moves <=1 full-res pixel). Static shape
            # check -> no traced branching.
            if depth_img.shape[0] <= (img.shape[0] + 1) // 2:
                d = smp.sample_nearest(dimg, feats.uv * 0.5)
            else:
                d = smp.sample_nearest(dimg, feats.uv)
            d = jnp.where(feats.valid & (d > 0), d, -1.0)
            uright = cam_mod.virtual_right(cam, feats.uv_und[:, 0], d)
            return feats, pyramid, d, uright

        # one jitted program per frame: extraction AND the RGB-D keypoint
        # channels (eager per-op dispatch after extraction would pay one
        # launch per op — everything frame-related fuses here)
        @jax.jit
        def _run(img):
            return _core_full(img, None, 1.0)

        @functools.partial(jax.jit, static_argnames=("depth_factor",))
        def _run_depth(img, depth_img, depth_factor):
            return _core_full(img, depth_img, depth_factor)

        self.core = _core_full
        self._run = _run
        self._run_depth = _run_depth

    def __call__(self, img) -> Tuple[FrameFeatures, Tuple[jnp.ndarray, ...]]:
        feats, pyramid, _, _ = self._run(jnp.asarray(img))
        return feats, pyramid


def make_frame(
    extractor: ORBExtractor,
    img,
    depth_img: Optional[jnp.ndarray] = None,
    depth_factor: float = 1.0,
) -> Frame:
    """Build a Frame; with depth_img (RGB-D) fills per-keypoint depth and the
    virtual right coordinate (Frame::ComputeStereoFromRGBD, Frame.cc:399-417).
    One jitted call end-to-end.
    """
    img = jnp.asarray(img)
    if depth_img is not None:
        feats, pyramid, d, uright = extractor._run_depth(
            img, jnp.asarray(depth_img), float(depth_factor)
        )
    else:
        feats, pyramid, d, uright = extractor._run(img)
    return Frame(
        features=feats,
        pyramid=pyramid,
        depth=d,
        uright=uright,
        Tcw=jnp.eye(4, dtype=jnp.float32),
    )
