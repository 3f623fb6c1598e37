"""Matching tests: Hamming core units + two-view geometric match integration."""

import numpy as np
import jax.numpy as jnp
import pytest

from sdslam_tpu.features import matching
from sdslam_tpu.features.frame import ORBExtractor, make_frame
from sdslam_tpu.geometry import camera as cam_mod
from sdslam_tpu.geometry import lie
from sdslam_tpu.geometry.camera import CameraModel
from sdslam_tpu.io import synthetic
from sdslam_tpu.ops import hamming as ham
from sdslam_tpu.utils.config import ORBConfig

CAM = CameraModel(fx=320.0, fy=320.0, cx=159.5, cy=119.5, width=320, height=240, bf=32.0)


def rand_desc(rng, n):
    return jnp.asarray(rng.integers(0, 2**32, size=(n, 8), dtype=np.uint64).astype(np.uint32))


def test_hamming_matrix_against_numpy(rng):
    a = rand_desc(rng, 33)
    b = rand_desc(rng, 47)
    d = np.asarray(ham.hamming_matrix(a, b))
    an = np.asarray(a).view(np.uint8)
    bn = np.asarray(b).view(np.uint8)
    ref = np.zeros((33, 47), np.int32)
    for i in range(33):
        x = np.bitwise_xor(an[i][None, :], bn)
        ref[i] = np.unpackbits(x, axis=1).sum(axis=1)
    np.testing.assert_array_equal(d, ref)
    # identical descriptors -> 0
    assert np.asarray(ham.hamming_vec(a, a)).max() == 0


@pytest.mark.parametrize("qa,qb", [(1, 1), (300, 200), (257, 1031)])
def test_hamming_matrix_shapes_against_numpy(qa, qb):
    """The one dense Hamming form at odd and matcher-like shapes, bit-exact
    against a numpy popcount oracle (extreme words included)."""
    rng = np.random.default_rng(qa * 7919 + qb)
    a = np.array(rand_desc(rng, qa))
    b = np.array(rand_desc(rng, qb))
    a[0] = 0
    b[-1] = np.uint32(0xFFFFFFFF)
    d = np.asarray(ham.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    x = np.bitwise_xor(a[:, None, :], b[None, :, :])
    ref = np.unpackbits(x.view(np.uint8), axis=-1).sum(axis=-1)
    assert d.dtype == np.int32 and d.shape == (qa, qb)
    np.testing.assert_array_equal(d, ref)


def test_best2_and_resolve(rng):
    dist = jnp.asarray(
        np.array([[5, 9, 30], [7, 50, 60], [90, 2, 70]], np.int32)
    )
    d1, j1, d2 = ham.best2(dist)
    np.testing.assert_array_equal(np.asarray(d1), [5, 7, 2])
    np.testing.assert_array_equal(np.asarray(j1), [0, 0, 1])
    np.testing.assert_array_equal(np.asarray(d2), [9, 50, 70])
    # queries 0 and 1 both want target 0; query 0 wins (dist 5 < 7)
    tq, td = ham.resolve_to_targets(j1, d1, jnp.ones(3, bool), 3)
    np.testing.assert_array_equal(np.asarray(tq), [0, 2, -1])
    np.testing.assert_array_equal(np.asarray(td)[:2], [5, 2])


def test_rotation_consistency():
    # 80 matches at ~0 rotation, 8 outliers spread across other bins
    dtheta = np.zeros(88, np.float32)
    dtheta[80:] = np.linspace(0.5, 5.8, 8)
    valid = np.ones(88, bool)
    keep = np.asarray(ham.rotation_consistency(jnp.asarray(dtheta), jnp.asarray(valid)))
    assert keep[:80].all()
    assert not keep[80:].any()


def _two_frames(rng, i0=0, i1=1):
    seq = synthetic.SyntheticSequence(CAM, n_frames=30, trajectory="orbit")
    ext = ORBExtractor(CAM, ORBConfig(max_keypoints=512, n_levels=4))
    frames = []
    for i in (i0, i1):
        _, img, depth = seq.frame(i)
        frames.append(make_frame(ext, img, depth_img=depth))
    return seq, frames[0], frames[1]


def test_search_by_projection_two_view(rng):
    """Match frame0's unprojected keypoints into frame1 using GT poses; matched
    pairs must be geometrically consistent (true correspondence)."""
    seq, fr0, fr1 = _two_frames(rng)
    T0, T1 = seq.poses[0], seq.poses[1]

    f0, f1 = fr0.features, fr1.features
    q_valid = f0.valid & (fr0.depth > 0)
    Xc0 = cam_mod.backproject(CAM, f0.uv_und, fr0.depth)
    Xw = lie.se3_apply(lie.se3_inv(T0), Xc0)

    res = matching.search_by_projection(
        CAM, T1, Xw, f0.desc, q_valid, f0.octave,
        f1.uv_und, f1.desc, f1.valid, f1.octave,
        radius_px=8.0, th_desc=ham.TH_HIGH,
    )
    kp_to_q = np.asarray(res.kp_to_query)
    n_matches = (kp_to_q >= 0).sum()
    assert n_matches > 60

    # verify matches against ground truth: project matched world point into
    # frame1, compare with the keypoint it was matched to
    m = kp_to_q >= 0
    Xm = np.asarray(Xw)[kp_to_q[m]]
    Xc1 = np.asarray(lie.se3_apply(T1, jnp.asarray(Xm)))
    uv1 = np.stack(
        [CAM.fx * Xc1[:, 0] / Xc1[:, 2] + CAM.cx, CAM.fy * Xc1[:, 1] / Xc1[:, 2] + CAM.cy], 1
    )
    kp_uv = np.asarray(f1.uv_und)[m]
    err = np.linalg.norm(uv1 - kp_uv, axis=1)
    assert np.median(err) < 1.5
    # no ratio test in this raw search (reference behavior): some ambiguous
    # matches within the 8px-per-octave window are expected and filtered
    # later by pose-opt chi2 classification
    assert (err < 4.0).mean() > 0.6


def test_search_by_projection_octave_window(rng):
    """The octave gate is centered on the SOURCE observation's octave
    (ORBmatcher.cc:946-1075): a coarse (octave-2) query must (a) accept a
    displaced octave-2 keypoint thanks to the octave-scaled radius, and
    (b) reject it when the query octave is wrongly forced to 0 — the r2
    regression where _track_core hardcoded q_oct=0 (VERDICT r2 item 5)."""
    Q = 4
    # one query point projecting to (160, 120)
    Xw = jnp.asarray(np.array([[0.0, 0.0, 2.0]] * Q, np.float32))
    d = jnp.asarray(
        rng.integers(0, 2**32, size=(Q, 8), dtype=np.uint64).astype(np.uint32)
    )
    q_valid = jnp.asarray(np.array([True] + [False] * (Q - 1)))
    # target keypoint: same descriptor, octave 2, displaced 20 px — inside
    # the octave-scaled window (8 * 2^2 = 32 px), outside the raw 8 px one
    kp_uv = jnp.asarray(np.array([[180.0, 120.0]] * Q, np.float32))
    kp_oct = jnp.asarray(np.full(Q, 2, np.int32))
    kp_valid = jnp.asarray(np.array([True] + [False] * (Q - 1)))
    T = jnp.eye(4)

    res_coarse = matching.search_by_projection(
        CAM, T, Xw, d, q_valid, jnp.full((Q,), 2, jnp.int32),
        kp_uv, d, kp_valid, kp_oct, radius_px=8.0, th_desc=ham.TH_HIGH,
    )
    assert int(res_coarse.kp_to_query[0]) == 0  # matched

    res_zero = matching.search_by_projection(
        CAM, T, Xw, d, q_valid, jnp.zeros((Q,), jnp.int32),
        kp_uv, d, kp_valid, kp_oct, radius_px=8.0, th_desc=ham.TH_HIGH,
    )
    # q_oct=0: radius unscaled (8 px < 20 px) AND octave gate [-1,1]
    # around 0 excludes octave 2 — the coarse feature can never re-match
    assert int(res_zero.kp_to_query[0]) == -1


def test_search_local_points_gates(rng):
    """Points behind the camera or outside the scale band must not match."""
    seq, fr0, fr1 = _two_frames(rng)
    f1 = fr1.features
    P = 64
    pos = np.tile(np.array([0.0, 0.0, -5.0], np.float32), (P, 1))  # behind
    res = matching.search_local_points(
        CAM, seq.poses[1], jnp.asarray(pos),
        rand_desc(rng, P), jnp.ones(P, bool),
        jnp.asarray(np.tile([0, 0, 1.0], (P, 1)).astype(np.float32)),
        jnp.full((P,), 0.1), jnp.full((P,), 10.0),
        f1.uv_und, f1.desc, f1.valid, f1.octave,
        th_radius=1.0, scale_factor=2.0, n_levels=4,
    )
    assert int(res.count()) == 0


def test_brute_force_self_match(rng):
    seq, fr0, fr1 = _two_frames(rng)
    f0 = fr0.features
    res = matching.search_brute_force(f0.desc, f0.valid, f0.desc, f0.valid, th_desc=0)
    kp_to_q = np.asarray(res.kp_to_query)
    v = np.asarray(f0.valid)
    idx = np.arange(len(kp_to_q))
    # each valid descriptor matches itself
    assert (kp_to_q[v] == idx[v]).mean() > 0.95


def test_search_by_sim3_mutual_recovery(rng):
    """Sim3-guided mutual matching (SearchBySim3 analog): two cameras see
    the same landmarks related by a known Sim3; the guided search must
    recover the identity correspondence and stay empty for a wrong Sim3."""
    N = 64
    X2 = rng.uniform([-0.7, -0.5, 1.5], [0.7, 0.5, 3.0], size=(N, 3)).astype(
        np.float32
    )
    phi = np.array([0.1, -0.15, 0.05], np.float32)
    R = np.asarray(lie.so3_exp(jnp.asarray(phi)))
    s, t = 1.2, np.array([0.2, -0.1, 0.25], np.float32)
    X1 = (s * X2 @ R.T + t).astype(np.float32)
    S12 = lie.sim3_from_Rts(jnp.asarray(R), jnp.asarray(t), jnp.asarray(s))
    uv1, z1 = cam_mod.project(CAM, jnp.asarray(X1))
    uv2, z2 = cam_mod.project(CAM, jnp.asarray(X2))
    in1 = np.asarray(cam_mod.in_image(CAM, uv1, 6.0)) & (np.asarray(z1) > 0)
    in2 = np.asarray(cam_mod.in_image(CAM, uv2, 6.0)) & (np.asarray(z2) > 0)
    desc = rand_desc(rng, N)  # same landmark -> same descriptor in both KFs
    octv = jnp.zeros((N,), jnp.int32)
    res = matching.search_by_sim3(
        CAM, S12,
        uv1, desc, jnp.asarray(in1), octv, jnp.asarray(X1),
        uv2, desc, jnp.asarray(in2), octv, jnp.asarray(X2),
    )
    pair = np.asarray(res.kp_to_query)
    both = in1 & in2
    # every matched co-visible landmark matches to itself
    matched = both & (pair >= 0)
    np.testing.assert_array_equal(pair[matched], np.arange(N)[matched])
    assert matched.sum() > 0.9 * both.sum()
    # a badly wrong Sim3 yields (almost) no mutual agreements in-window
    S_bad = lie.sim3_from_Rts(
        jnp.eye(3), jnp.asarray(np.array([2.5, 2.5, 0.0], np.float32)), jnp.asarray(1.0)
    )
    res_bad = matching.search_by_sim3(
        CAM, S_bad,
        uv1, desc, jnp.asarray(in1), octv, jnp.asarray(X1),
        uv2, desc, jnp.asarray(in2), octv, jnp.asarray(X2),
    )
    assert int(res_bad.count()) < int(res.count()) // 4
