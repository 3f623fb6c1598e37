"""Synthetic photometric RGB-D scene renderer (test bed + benchmark workload).

The reference validates only against TUM/EuRoC datasets it cannot ship
(/root/reference/README.md:47-58); this module provides a fully controlled
substitute: a planar "room" with a smooth procedural texture, rendered
analytically for any camera pose, with exact depth and exact trajectory
ground truth.  Photometric consistency across views is exact, which makes it
a valid workload for the direct image-alignment path (ImageAlign) and yields
ATE ~ 0 expectations for integration tests (SURVEY.md §4).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from sdslam_tpu.geometry import lie
from sdslam_tpu.geometry.camera import CameraModel

# full float32 ray/plane products: a GPU would otherwise run them in TF32
# and the rendered depth would carry millimetre-level rounding
_einsum = functools.partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)


class PlaneScene(NamedTuple):
    """Textured scene: infinite room planes n·x = d plus bounded interior
    rectangles (clutter at varied depth/orientation — without it a
    fronto-parallel room is degenerate: x-translation vs y-rotation is a
    flat valley for BOTH photometric alignment and sparse reprojection)."""

    normals: jnp.ndarray  # [P,3] room planes
    offsets: jnp.ndarray  # [P]
    rect_origin: jnp.ndarray  # [B,3] bounded-rectangle centers
    rect_u: jnp.ndarray  # [B,3] in-plane axis (unit * half-extent)
    rect_v: jnp.ndarray  # [B,3]
    # texture basis, shared across surfaces: I = bias_s + sum_k amp*sin(f·x+ph)
    freqs: jnp.ndarray  # [K,3]
    phases: jnp.ndarray  # [K]
    amps: jnp.ndarray  # [K]
    biases: jnp.ndarray  # [P+B]


def make_room_scene(
    seed: int = 0, n_waves: int = 48, size: float = 2.5, closed: bool = False
) -> PlaneScene:
    """Room around the origin; camera conventions: x right, y down, z forward.

    Default size 2.5 m puts surfaces at 0.8-2.5 m: close enough that camera
    z-translation is photometrically observable (a 4 m fronto-parallel wall
    is depth-degenerate — 3 cm of z moves edge pixels < 0.6 px — and makes
    any odometry drift in z, ours or the reference's)."""
    rng = np.random.default_rng(seed)
    normals = np.array(
        [
            [0.0, 0.0, -1.0],  # back wall at z = size
            [1.0, 0.0, 0.0],  # left wall at x = -size/2
            [-1.0, 0.0, 0.0],  # right wall at x = +size/2
            [0.0, -1.0, 0.0],  # floor at y = +size/3 (y down)
            [0.0, 1.0, 0.0],  # ceiling at y = -size/3
        ],
        dtype=np.float32,
    )
    offsets = np.array([-size, -size / 2, -size / 2, -size / 3, -size / 3], np.float32)
    # Natural-image-like 1/f spectrum: log-uniform frequencies up to
    # ~110 rad/m (below the ~250 rad/m pixel Nyquist at 2.5 m / fx=320) with
    # amplitude ~ 1/f.  A narrow high-frequency band would make the texture
    # quasi-periodic and give Lucas-Kanade a lattice of photometric local
    # minima one texture period apart — broadband 1/f keeps the basin wide
    # (monotonically decaying autocorrelation) while high frequencies still
    # provide FAST-detectable corners.
    n_waves = max(n_waves, 128)
    dirs = rng.normal(size=(n_waves, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    mags = np.exp(rng.uniform(np.log(1.5), np.log(150.0), size=(n_waves, 1)))
    freqs = (dirs * mags).astype(np.float32)
    phases = rng.uniform(0, 2 * np.pi, size=n_waves).astype(np.float32)
    # mild high-frequency tilt (~f^0.3 over log-spaced frequencies): enough
    # corner energy for FAST (~320 kps/frame) while the broadband low end
    # keeps the LK basin wide (verified: 6 cm init convergence)
    amps = (mags[:, 0] ** 0.3).astype(np.float32)
    amps *= np.sqrt(2.0) / np.sqrt((amps**2).sum())

    # interior clutter: randomly oriented bounded rectangles scattered in the
    # front half of the room at depths 0.8..size-0.4
    n_rect = 8
    origins, us, vs = [], [], []
    for _ in range(n_rect):
        c = np.array(
            [
                rng.uniform(-size / 3, size / 3),
                rng.uniform(-size / 4, size / 4),
                rng.uniform(0.8, size - 0.4),
            ],
            np.float32,
        )
        a = rng.normal(size=3)
        a /= np.linalg.norm(a)
        b = np.cross(a, rng.normal(size=3))
        b /= np.linalg.norm(b)
        eu = rng.uniform(0.15, 0.45)
        ev = rng.uniform(0.15, 0.45)
        origins.append(c)
        us.append((a * eu).astype(np.float32))
        vs.append((b * ev).astype(np.float32))
    biases = rng.uniform(0.35, 0.65, size=len(normals) + n_rect).astype(np.float32)
    if closed:
        # front wall at z = -size: makes the room watertight so a camera
        # yawing through 360 deg (circuit trajectories for organic
        # loop-closure tests) always sees finite depth. Appended AFTER all
        # other rng draws so closed=False scenes are bit-identical to r3.
        normals = np.concatenate([normals, [[0.0, 0.0, 1.0]]]).astype(np.float32)
        offsets = np.concatenate([offsets, [-size]]).astype(np.float32)
        biases = np.concatenate(
            [biases[: len(normals) - 1],
             rng.uniform(0.35, 0.65, size=1).astype(np.float32),
             biases[len(normals) - 1:]]
        )
    return PlaneScene(
        jnp.asarray(normals),
        jnp.asarray(offsets),
        jnp.asarray(np.stack(origins)),
        jnp.asarray(np.stack(us)),
        jnp.asarray(np.stack(vs)),
        jnp.asarray(freqs),
        jnp.asarray(phases),
        jnp.asarray(amps),
        jnp.asarray(biases),
    )


def scene_intensity(scene: PlaneScene, X, plane_idx):
    """Procedural texture value in [0,1]-ish at world points X [...,3]."""
    phase = _einsum("...i,ki->...k", X, scene.freqs) + scene.phases
    tex = _einsum("...k,k->...", jnp.sin(phase), scene.amps)
    # soft contrast sharpening: strengthens gradients/corners while keeping
    # the intensity field analytic (no aliasing from hard edges)
    return scene.biases[plane_idx] + 0.45 * jnp.tanh(1.0 * tex)


@functools.partial(jax.jit, static_argnames=("cam",))
def render(scene: PlaneScene, cam: CameraModel, Tcw):
    """Render grayscale image [H,W] float32 in [0,255] and depth [H,W] (m)."""
    H, W = cam.height, cam.width
    Twc = lie.se3_inv(Tcw)
    Rwc, twc = lie.se3_R(Twc), lie.se3_t(Twc)

    u = jnp.arange(W, dtype=jnp.float32)[None, :].repeat(H, 0)
    v = jnp.arange(H, dtype=jnp.float32)[:, None].repeat(W, 1)
    # unnormalized camera-ray with z=1 so the ray parameter equals depth
    dc = jnp.stack([(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy, jnp.ones_like(u)], -1)
    dw = _einsum("ij,hwj->hwi", Rwc, dc)  # [H,W,3]

    n_dot_o = _einsum("pi,i->p", scene.normals, twc)  # [P]
    n_dot_d = _einsum("pi,hwi->hwp", scene.normals, dw)  # [H,W,P]
    t = (scene.offsets[None, None, :] - n_dot_o[None, None, :]) / jnp.where(
        jnp.abs(n_dot_d) < 1e-6, 1e-6, n_dot_d
    )
    t = jnp.where(t > 1e-3, t, jnp.inf)

    # bounded interior rectangles
    ru, rv = scene.rect_u, scene.rect_v  # [B,3]
    rn = jnp.cross(ru, rv)
    rn = rn / jnp.linalg.norm(rn, axis=-1, keepdims=True)
    num = _einsum("bi,bi->b", rn, scene.rect_origin - twc[None, :])  # [B]
    den = _einsum("bi,hwi->hwb", rn, dw)
    tr_ = num[None, None, :] / jnp.where(jnp.abs(den) < 1e-6, 1e-6, den)
    hit = twc[None, None, None, :] + tr_[..., None] * dw[:, :, None, :]  # [H,W,B,3]
    rel = hit - scene.rect_origin[None, None, :, :]
    au = _einsum("hwbi,bi->hwb", rel, ru) / jnp.maximum(
        jnp.sum(ru * ru, -1)[None, None, :], 1e-9
    )
    av = _einsum("hwbi,bi->hwb", rel, rv) / jnp.maximum(
        jnp.sum(rv * rv, -1)[None, None, :], 1e-9
    )
    inside = (jnp.abs(au) <= 1.0) & (jnp.abs(av) <= 1.0) & (tr_ > 1e-3)
    tr_ = jnp.where(inside, tr_, jnp.inf)

    t_all = jnp.concatenate([t, tr_], axis=-1)  # [H,W,P+B]
    plane_idx = jnp.argmin(t_all, axis=-1)  # [H,W]
    depth = jnp.min(t_all, axis=-1)
    Xw = twc[None, None, :] + depth[..., None] * dw
    img = scene_intensity(scene, Xw, plane_idx) * 255.0
    img = jnp.clip(img, 0.0, 255.0)
    depth = jnp.where(jnp.isfinite(depth), depth, 0.0)
    return img, depth


def orbit_trajectory(n_frames: int, radius: float = 0.4, yaw_amp: float = 0.12, seed: int = 1):
    """Smooth looping trajectory of Tcw poses [N,4,4] looking down +z.

    Small rotations + translation loop; starts at identity. Per-frame flow
    scales with radius (lateral) and yaw_amp (rotational).
    """
    ts = np.linspace(0, 2 * np.pi, n_frames, endpoint=False)
    poses = []
    for t in ts:
        # camera center in world coordinates
        c = np.array(
            [radius * np.sin(t), 0.25 * radius * np.sin(2 * t), 0.3 * radius * (1 - np.cos(t))],
            np.float32,
        )
        yaw = yaw_amp * np.sin(t)
        pitch = 0.5 * yaw_amp * np.sin(2 * t)
        phi = np.array([pitch, yaw, 0.0], np.float32)
        Rwc = np.asarray(lie.so3_exp(jnp.asarray(phi)))
        Rcw = Rwc.T
        tcw = -Rcw @ c
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = Rcw
        T[:3, 3] = tcw
        poses.append(T)
    return jnp.asarray(np.stack(poses))


def circuit_trajectory(n_frames: int, radius: float = 0.8):
    """Closed circuit: the camera walks a full circle of the given radius,
    heading along the tangent, so yaw sweeps 360 deg and each path segment
    sees a DIFFERENT part of the room — features are locally scoped and the
    revisit at the end can only be reconciled by loop closure (organic
    drift-accumulation workload; use with make_room_scene(closed=True)).

    Starts at the origin looking +z; circle center at (radius, 0, 0)."""
    poses = []
    for i in range(n_frames):
        th = 2 * np.pi * i / n_frames
        c = np.array(
            [radius * (1 - np.cos(th)), 0.0, radius * np.sin(th)], np.float32
        )
        Rwc = np.asarray(lie.so3_exp(jnp.asarray([0.0, th, 0.0], jnp.float32)))
        Rcw = Rwc.T
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = Rcw
        T[:3, 3] = -Rcw @ c
        poses.append(T)
    return jnp.asarray(np.stack(poses))


def forward_trajectory(n_frames: int, step: float = 0.02, yaw_rate: float = 0.0):
    """Straight-ish dolly forward, constant velocity (EKF-friendly)."""
    poses = []
    for i in range(n_frames):
        c = np.array([0.0, 0.0, step * i], np.float32)
        phi = np.array([0.0, yaw_rate * i, 0.0], np.float32)
        Rwc = np.asarray(lie.so3_exp(jnp.asarray(phi)))
        Rcw = Rwc.T
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = Rcw
        T[:3, 3] = -Rcw @ c
        poses.append(T)
    return jnp.asarray(np.stack(poses))


def make_dist_ba_problem(rng, K, P, Mo, cam, noise_px: float = 0.01):
    """Production-shaped synthetic BA problem as flat arrays (numpy), for
    the distributed-BA scaling harness (scripts/dist_scaling.py) and the
    driver's multi-chip dry run: K keyframes, P points, E = P*Mo stereo
    observations with per-camera keypoint tables.

    Returns (T0 [K,4,4] perturbed initial poses, X0 [P,3] perturbed points,
    obs_kf [P,Mo] (-1 = dropped), obs_kp [P,Mo], kf_uv [K,N,2],
    kf_ur [K,N], kf_oct [K,N], T_gt, X_gt)."""
    pts = rng.uniform([-3, -2, 1], [3, 2, 8], (P, 3)).astype(np.float32)
    kf_T = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    kf_T[:, :3, 3] = rng.uniform(-0.8, 0.8, (K, 3)).astype(np.float32)
    obs_cam = rng.integers(0, K, (P, Mo)).astype(np.int32)
    Tpm = kf_T[obs_cam]
    Xc = np.einsum("pmij,pj->pmi", Tpm[..., :3, :3], pts) + Tpm[..., :3, 3]
    u = cam.fx * Xc[..., 0] / Xc[..., 2] + cam.cx
    v = cam.fy * Xc[..., 1] / Xc[..., 2] + cam.cy
    ur = u - cam.bf / Xc[..., 2]

    # per-camera keypoint slot assignment (vectorized cumcount by camera)
    N = Mo * (P // K + 2)
    flat_c = obs_cam.ravel()
    order = np.argsort(flat_c, kind="stable")
    sc = flat_c[order]
    first = np.r_[True, sc[1:] != sc[:-1]]
    grp = np.cumsum(first) - 1
    starts = np.flatnonzero(first)
    rank = np.arange(sc.size) - starts[grp]
    kp = np.empty(sc.size, np.int64)
    kp[order] = rank
    keep = kp < N
    obs_kp = np.where(keep, kp, 0).reshape(P, Mo).astype(np.int32)
    obs_kf = np.where(keep.reshape(P, Mo), obs_cam, -1).astype(np.int32)

    kf_uv = np.zeros((K, N, 2), np.float32)
    kf_ur = np.full((K, N), -1.0, np.float32)
    kf_oct = np.zeros((K, N), np.int32)
    uv_flat = np.stack([u.ravel(), v.ravel()], -1).astype(np.float32)
    uv_flat += rng.normal(0, noise_px, uv_flat.shape).astype(np.float32)
    sel = np.flatnonzero(keep)
    kf_uv[flat_c[sel], kp[sel]] = uv_flat[sel]
    kf_ur[flat_c[sel], kp[sel]] = ur.ravel()[sel]

    T0 = kf_T.copy()
    T0[1:, :3, 3] += rng.normal(0, 0.01, (K - 1, 3)).astype(np.float32)
    X0 = pts + rng.normal(0, 0.02, (P, 3)).astype(np.float32)
    return T0, X0, obs_kf, obs_kp, kf_uv, kf_ur, kf_oct, kf_T, pts


class SyntheticSequence:
    """Dataset-like iterable of (timestamp, image, depth) with GT poses."""

    def __init__(
        self,
        cam: CameraModel,
        n_frames: int = 60,
        trajectory: str = "orbit",
        seed: int = 0,
        fps: float = 30.0,
        scene_kwargs: dict = None,
        **traj_kwargs,
    ):
        self.cam = cam
        self.scene = make_room_scene(seed=seed, **(scene_kwargs or {}))
        if trajectory == "orbit":
            self.poses = orbit_trajectory(n_frames, **traj_kwargs)
        elif trajectory == "circuit":
            self.poses = circuit_trajectory(n_frames, **traj_kwargs)
        elif trajectory == "forward":
            self.poses = forward_trajectory(n_frames, **traj_kwargs)
        elif trajectory == "custom":
            # caller-supplied Tcw poses [N,4,4] (loop / fast-motion tests)
            self.poses = jnp.asarray(traj_kwargs["poses"])
            n_frames = self.poses.shape[0]
        else:
            raise ValueError(trajectory)
        self.timestamps = np.arange(n_frames) / fps

    def __len__(self):
        return len(self.timestamps)

    def frame(self, i: int):
        img, depth = render(self.scene, self.cam, self.poses[i])
        return self.timestamps[i], img, depth

    def __iter__(self):
        for i in range(len(self)):
            yield self.frame(i)
