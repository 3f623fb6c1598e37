"""The pose-solve Pallas kernel (Triton route) against the XLA path it
replaces on the card, and the per-level alignment loop (plain XLA: its
Triton kernel compiled too slowly to keep) against a known motion. Here the
kernel runs in interpret mode; chip_smoke.py compiles it for the card and
repeats the comparison at the tracker's width."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sdslam_tpu.geometry import lie
from sdslam_tpu.geometry.camera import CameraModel
from sdslam_tpu.ops.pallas import checks
from sdslam_tpu.ops.pallas import pose_kernel as pk
from sdslam_tpu.solvers import image_align as ia
from sdslam_tpu.solvers import pose_opt

POSE_CAM = (400.0, 400.0, 160.0, 120.0, 40.0)


def _pose_inputs(seed, N=256, stereo_frac=0.5):
    rng = np.random.default_rng(seed)
    (fx, fy, cx, cy, bf), X, uv, ur, isig, valid, T_true = checks.pose_problem(
        rng, N=N, n_outlier=max(1, N // 12), stereo_frac=stereo_frac,
        cam=POSE_CAM)
    cam = CameraModel(fx=fx, fy=fy, cx=cx, cy=cy, width=320, height=240,
                      bf=bf)
    arrays = tuple(jnp.asarray(a) for a in (X, uv, isig, valid, ur))
    return cam, arrays, T_true


def _pose_both(cam, arrays, T0, T_prior, rot_info, trans_info, rounds=4,
               iters=10):
    X, uv, isig, valid, ur = arrays
    rx = pose_opt._optimize_pose_xla(
        cam, T0, X, uv, isig, valid, ur, rounds, iters, T_prior,
        jnp.float32(rot_info), jnp.float32(trans_info))
    Tp_inv = (lie.se3_inv(T_prior) if T_prior is not None
              else jnp.eye(4, dtype=jnp.float32))
    edges, scal = pk.pack(X, uv, ur, isig, valid, T0, Tp_inv, trans_info,
                          rot_info)
    out, inl = pk.pose_solve(cam, edges, scal, rounds, iters,
                             T_prior is not None, interpret=True)
    T = np.eye(4, dtype=np.float32)
    T[:3] = np.asarray(out[:12]).reshape(3, 4)
    T = np.asarray(lie.se3_normalize(jnp.asarray(T)))
    return rx, T, np.asarray(inl)[: X.shape[0]] > 0, out


def test_pose_kernel_matches_xla():
    """The whole-solve pose kernel must reproduce the XLA optimize_pose:
    same rounds/iters/Huber/reclassification/prior math."""
    cam, arrays, T_true = _pose_inputs(11)
    T0 = jnp.asarray(np.asarray(lie.se3_exp(jnp.asarray(
        [0.04, -0.02, 0.07, 0.015, -0.012, 0.008], jnp.float32))))
    rx, T, inl, out = _pose_both(cam, arrays, T0, T0, 100.0, 4.0)
    for Tc in (np.asarray(rx.Tcw), T):
        err = np.asarray(lie.se3_log(jnp.asarray(Tc @ np.linalg.inv(T_true))))
        # the deliberately-offset prior (trans_info=4) pulls the optimum a
        # little off truth by design; parity below is the real assertion
        assert np.linalg.norm(err[:3]) < 4e-3, err
    np.testing.assert_allclose(T, np.asarray(rx.Tcw), atol=5e-5)
    assert int(out[12]) == int(rx.n_inliers)
    np.testing.assert_array_equal(inl, np.asarray(rx.inliers))
    np.testing.assert_allclose(float(out[13]), float(rx.chi2), rtol=1e-3)


def test_pose_kernel_mono_no_prior():
    """Mono-only edges, no prior term (has_prior=False kernel branch)."""
    cam, arrays, _ = _pose_inputs(5, stereo_frac=0.0)
    T0 = jnp.asarray(np.asarray(lie.se3_exp(jnp.asarray(
        [0.045, -0.025, 0.075, 0.018, -0.013, 0.009], jnp.float32))))
    rx, T, inl, out = _pose_both(cam, arrays, T0, None, 0.0, 0.0)
    np.testing.assert_allclose(T, np.asarray(rx.Tcw), atol=5e-5)
    assert int(out[12]) == int(rx.n_inliers)


@pytest.mark.parametrize("N", [100, 257, 512])
def test_pose_kernel_padding(N):
    """Edge counts that are not powers of two are padded with invalid
    edges, which must change nothing; the tracker's short schedule."""
    cam, arrays, _ = _pose_inputs(N, N=N)
    edges, _ = pk.pack(*(arrays[i] for i in (0, 1, 4, 2, 3)), jnp.eye(4),
                       jnp.eye(4), 0.0, 0.0)
    n_pad = edges.shape[1]
    assert n_pad >= N and n_pad & (n_pad - 1) == 0
    assert not np.asarray(edges[7, N:]).any()  # padding edges invalid
    T0 = jnp.asarray(np.asarray(lie.se3_exp(jnp.asarray(
        [0.03, -0.02, 0.05, 0.01, -0.01, 0.005], jnp.float32))))
    rx, T, inl, out = _pose_both(cam, arrays, T0, T0, 50.0, 2.0, rounds=2,
                                 iters=5)
    np.testing.assert_allclose(T, np.asarray(rx.Tcw), atol=5e-5)
    np.testing.assert_array_equal(inl, np.asarray(rx.inliers))


def _plane_scene(rng, H, W, fx, fy, cx, cy, N, T_true):
    """Textured plane at z=2 seen from identity and from T_true, with N
    keypoints: returns (img_ref, img_cur, uv [N,2], X_ref [N,3])."""
    freqs = rng.uniform(0.5, 12.0, (24, 2))
    phases = rng.uniform(0, 2 * np.pi, 24)
    amps = 1.0 / np.sqrt(freqs[:, 0] ** 2 + freqs[:, 1] ** 2)

    def render(Tcw):
        u, v = np.meshgrid(np.arange(W, dtype=np.float64),
                           np.arange(H, dtype=np.float64))
        Twc = np.linalg.inv(Tcw)
        d = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u)], -1)
        dw = d @ Twc[:3, :3].T
        o = Twc[:3, 3]
        Xw = o + ((2.0 - o[2]) / dw[..., 2])[..., None] * dw
        ph = Xw[..., :2] @ freqs.T + phases
        return (128.0 + 60.0 * (np.sin(ph) @ amps) / np.abs(amps).sum()
                ).astype(np.float32)

    uv = rng.uniform([8, 8], [W - 9, H - 9], (N, 2)).astype(np.float32)
    z = np.full((N,), 2.0, np.float32)
    X = np.stack([(uv[:, 0] - cx) / fx * z, (uv[:, 1] - cy) / fy * z, z], -1)
    return render(np.eye(4)), render(T_true), uv, X


def _align_inputs(seed, N):
    rng = np.random.default_rng(seed)
    H, W, f, cx, cy = 120, 160, 120.0, 79.5, 59.5
    T_true = np.asarray(lie.se3_exp(jnp.asarray(
        [0.01, -0.008, 0.012, 0.004, -0.003, 0.002], jnp.float32)))
    img_ref, img_cur, uv, X = _plane_scene(rng, H, W, f, f, cx, cy, N,
                                           T_true)
    patch, J, ok = ia._precompute_level(
        jnp.asarray(img_ref), jnp.asarray(uv), jnp.asarray(X),
        jnp.ones((N,), bool), f, f)
    args = (jnp.asarray(img_cur), jnp.eye(4, dtype=jnp.float32),
            jnp.asarray(X), patch, J, ok)
    return args, (f, f, cx, cy), T_true


def _motion_error(T, T_true):
    err = np.asarray(lie.se3_log(jnp.asarray(
        np.asarray(T) @ np.linalg.inv(T_true))))
    return float(np.linalg.norm(err[:3])), float(np.linalg.norm(err[3:]))


@pytest.mark.parametrize("N", [37, 300, 1000])
def test_align_level_recovers_true_motion(N):
    """One level's GN loop (ImageAlign.cc:234-279) recovers the known
    motion of a textured plane from identity, at the tracker's point count
    (300) and at counts well below and above it."""
    args, intr, T_true = _align_inputs(N, N)
    T, chi2, n = jax.jit(lambda *a: ia._align_level(*a, *intr, 30))(*args)
    t_err, r_err = _motion_error(T, T_true)
    t0, _ = _motion_error(np.eye(4), T_true)
    assert t_err < 2e-3 and r_err < 2e-3 and t_err < 0.2 * t0
    assert float(chi2) < 1e-4
    assert 0 < int(n) <= 16 * N


def test_align_level_under_vmap():
    """The relocalization and loop-detection scans vmap the aligner: the
    batched loop must give each alignment its own result."""
    a1, intr, _ = _align_inputs(21, 64)
    a2, _, _ = _align_inputs(22, 64)
    batched = tuple(jnp.stack([u, v]) for u, v in zip(a1, a2))
    Tb, chib, nb = jax.vmap(
        lambda *a: ia._align_level(*a, *intr, 6))(*batched)
    for k, a in enumerate((a1, a2)):
        T, chi, n = ia._align_level(*a, *intr, 6)
        np.testing.assert_allclose(np.asarray(Tb[k]), np.asarray(T),
                                   atol=1e-6)
        assert int(nb[k]) == int(n)


def test_cpu_dispatch_runs_xla_path():
    """Off the card, optimize_pose lowers the XLA branch: results are
    bit-identical to calling it directly."""
    cam, (X, uv, isig, valid, ur), _ = _pose_inputs(3, N=128)
    T0 = jnp.eye(4, dtype=jnp.float32)
    r = pose_opt.optimize_pose(cam, T0, X, uv, isig, valid, ur_obs=ur,
                               rounds=2, iters_per_round=3)
    rx = pose_opt._optimize_pose_xla(cam, T0, X, uv, isig, valid, ur, 2, 3,
                                     None, 0.0, 0.0)
    np.testing.assert_array_equal(np.asarray(r.Tcw), np.asarray(rx.Tcw))
