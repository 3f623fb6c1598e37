"""Bundle adjustment tests on synthetic multi-view graphs."""

import numpy as np
import jax.numpy as jnp

from sdslam_tpu.geometry import camera as cam_mod
from sdslam_tpu.geometry import lie
from sdslam_tpu.geometry.camera import CameraModel
from sdslam_tpu.mapping import map_state as M
from sdslam_tpu.solvers import ba

CAM = CameraModel(fx=320.0, fy=320.0, cx=159.5, cy=119.5, width=320, height=240, bf=32.0)


def make_ba_problem(rng, n_kf=6, n_pt=300, noise_px=0.3, pose_noise=0.02, pt_noise=0.02, stereo=False):
    """Synthetic map with noisy poses/points but exact observations."""
    K, P, N = 8, 512, 256
    ms = M.init_map(K, P, N, ((10, 10),))
    X_gt = rng.uniform([-1.2, -0.8, 1.5], [1.2, 0.8, 3.5], size=(n_pt, 3)).astype(np.float32)
    T_gt = []
    for i in range(n_kf):
        xi = np.concatenate([rng.normal(size=3) * 0.25, rng.normal(size=3) * 0.05]).astype(np.float32)
        T_gt.append(np.asarray(lie.se3_exp(jnp.asarray(xi))))
    T_gt = np.stack(T_gt)

    kf_uv = np.zeros((K, N, 2), np.float32)
    kf_ur = np.full((K, N), -1.0, np.float32)
    kf_mp = np.full((K, N), -1, np.int32)
    kp_valid = np.zeros((K, N), bool)
    for k in range(n_kf):
        Xc = np.asarray(lie.se3_apply(jnp.asarray(T_gt[k]), jnp.asarray(X_gt)))
        uv, z = cam_mod.project(CAM, jnp.asarray(Xc))
        uv = np.array(uv) + rng.normal(size=(n_pt, 2)).astype(np.float32) * noise_px
        vis = (np.asarray(z) > 0.2) & (uv[:, 0] > 5) & (uv[:, 0] < 315) & (uv[:, 1] > 5) & (uv[:, 1] < 235)
        idx = np.flatnonzero(vis)[:N]
        kf_uv[k, : len(idx)] = uv[idx]
        kf_mp[k, : len(idx)] = idx
        kp_valid[k, : len(idx)] = True
        if stereo:
            kf_ur[k, : len(idx)] = uv[idx, 0] - CAM.bf / np.asarray(z)[idx]

    # noisy initial estimates (KF0 exact = gauge), embedded in the full pool
    T_init = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    T_init[:n_kf] = T_gt
    for k in range(1, n_kf):
        xi = np.concatenate(
            [rng.normal(size=3) * pose_noise, rng.normal(size=3) * pose_noise * 0.5]
        ).astype(np.float32)
        T_init[k] = np.asarray(lie.se3_exp(jnp.asarray(xi))) @ T_gt[k]
    X_init = X_gt + rng.normal(size=X_gt.shape).astype(np.float32) * pt_noise

    ms = ms._replace(
        kf_valid=jnp.asarray(np.arange(K) < n_kf),
        kf_Tcw=jnp.asarray(T_init),
        kf_uv_und=jnp.asarray(kf_uv),
        kf_uright=jnp.asarray(kf_ur),
        kf_mp=jnp.asarray(kf_mp),
        kf_kp_valid=jnp.asarray(kp_valid),
        pt_valid=jnp.asarray(np.arange(P) < n_pt),
        pt_pos=jnp.asarray(np.concatenate([X_init, np.zeros((P - n_pt, 3), np.float32)])),
    )
    return ms, T_gt, X_gt, n_kf, n_pt


def pose_errs(T_est, T_gt):
    d = np.asarray(lie.se3_log(jnp.asarray(T_est) @ lie.se3_inv(jnp.asarray(T_gt))))
    return np.abs(d[..., :3]).max(), np.abs(d[..., 3:]).max()


def test_global_ba_converges(rng):
    # stereo edges pin the scale gauge (mono BA with one fixed camera has a
    # free world-scale direction, as in the reference)
    ms, T_gt, X_gt, n_kf, n_pt = make_ba_problem(rng, noise_px=0.0, stereo=True)
    cam_active = ms.kf_valid.at[0].set(False)
    res = ba.bundle_adjust(CAM, ms, cam_active, ms.pt_valid)
    for k in range(1, n_kf):
        et, er = pose_errs(np.asarray(res.kf_Tcw[k]), T_gt[k])
        assert et < 3e-3 and er < 2e-3, (k, et, er)
    perr = np.linalg.norm(np.asarray(res.pt_pos[:n_pt]) - X_gt, axis=1)
    assert np.median(perr) < 3e-3
    assert float(res.chi2) < 0.05  # mean px^2 residual floor (f32 + damping)


def test_global_ba_with_noise_and_stereo(rng):
    ms, T_gt, X_gt, n_kf, n_pt = make_ba_problem(rng, noise_px=0.3, stereo=True)
    cam_active = ms.kf_valid.at[0].set(False)
    res = ba.bundle_adjust(CAM, ms, cam_active, ms.pt_valid)
    for k in range(1, n_kf):
        et, er = pose_errs(np.asarray(res.kf_Tcw[k]), T_gt[k])
        assert et < 8e-3 and er < 5e-3, (k, et, er)


def test_ba_fixed_cameras_stay_fixed(rng):
    ms, T_gt, X_gt, n_kf, n_pt = make_ba_problem(rng)
    cam_active = jnp.zeros((ms.K,), bool).at[2].set(True).at[3].set(True)
    res = ba.bundle_adjust(CAM, ms, cam_active, ms.pt_valid)
    for k in (0, 1, 4, 5):
        np.testing.assert_allclose(
            np.asarray(res.kf_Tcw[k]), np.asarray(ms.kf_Tcw[k]), atol=1e-6
        )


def test_ba_outlier_observations_get_erased(rng):
    ms, T_gt, X_gt, n_kf, n_pt = make_ba_problem(rng, noise_px=0.2)
    # corrupt 20 observations of KF1 grossly
    kf_uv = np.array(ms.kf_uv_und)
    kf_uv[1, :20] += 40.0
    ms = ms._replace(kf_uv_und=jnp.asarray(kf_uv))
    ms2 = ba.apply_ba_result(
        ms, ba.bundle_adjust(CAM, ms, ms.kf_valid.at[0].set(False), ms.pt_valid)
    )
    erased = np.asarray(ms2.kf_mp[1, :20])
    assert (erased == -1).mean() > 0.8  # most corrupted edges removed
    kept = np.asarray(ms2.kf_mp[1, 20:])
    assert (kept >= 0).mean() > 0.8  # clean edges survive


def test_local_ba_improves_contaminated_keyframe(rng):
    """The odometry failure mode: last KF + its new points biased; local BA
    must pull them back using the older fixed KFs."""
    ms, T_gt, X_gt, n_kf, n_pt = make_ba_problem(
        rng, noise_px=0.0, pose_noise=0.0, pt_noise=0.0
    )
    # bias KF5 pose and the points it exclusively re-anchors
    delta = jnp.asarray(np.array([0.03, -0.02, 0.04, 0.005, 0.01, -0.005], np.float32))
    T_biased = np.array(ms.kf_Tcw)
    T_biased[5] = np.asarray(lie.se3_exp(delta)) @ T_biased[5]
    ms = ms._replace(kf_Tcw=jnp.asarray(T_biased))
    et0, er0 = pose_errs(T_biased[5], T_gt[5])
    ms2 = ba.local_ba(CAM, ms, center_kf=5, covis_min=15)
    et1, er1 = pose_errs(np.asarray(ms2.kf_Tcw[5]), T_gt[5])
    assert et1 < et0 * 0.1  # pose recovered
    assert et1 < 2e-3


def test_local_ba_prefuse_inc_matches_fallback(rng):
    """r4 advisor: the fused KF pass hands local_ba an incidence computed
    BEFORE fuse_neighbors mutated bindings; standalone callers recompute it
    (inc=None). The active-set staleness must stay bounded: both paths must
    converge to equivalent poses on a post-fuse map."""
    from sdslam_tpu.mapping import local_mapping as LM

    ms, T_gt, X_gt, n_kf, n_pt = make_ba_problem(
        rng, noise_px=0.2, pose_noise=0.01, pt_noise=0.01
    )
    # pre-fuse derived structures, exactly as _kf_core computes them
    inc = M.incidence_matrix(ms)
    covis = M.covisibility(ms, inc=inc)
    ms_fused = LM.fuse_neighbors(
        CAM, ms, jnp.asarray(5), covis=covis,
        obs_cnt=M.point_obs_count_from_inc(ms, inc),
    )
    ms_inc = ba.local_ba(
        CAM, ms_fused, center_kf=5, covis_min=15, covis=covis, inc=inc
    )
    ms_fb = ba.local_ba(CAM, ms_fused, center_kf=5, covis_min=15)
    T_inc = np.asarray(ms_inc.kf_Tcw)
    T_fb = np.asarray(ms_fb.kf_Tcw)
    for k in range(n_kf):
        et, er = pose_errs(T_inc[k], T_fb[k])
        assert et < 1e-3 and er < 1e-3, (k, et, er)
    # and both actually improved toward ground truth
    et_inc, _ = pose_errs(T_inc[5], T_gt[5])
    assert et_inc < 5e-3


def _dense_normal_equations(ms, n_kf, n_pt):
    """float64 reference: the full [6K+3P] Gauss-Newton system from
    finite-difference Jacobians (left camera perturbation exp(d) T,
    additive point step) of the residual (u, v, u_r)."""
    from scipy.linalg import expm

    T = np.asarray(ms.kf_Tcw, np.float64)[:n_kf]
    X = np.asarray(ms.pt_pos, np.float64)[:n_pt]
    uv = np.asarray(ms.kf_uv_und, np.float64)
    ur = np.asarray(ms.kf_uright, np.float64)
    mp = np.asarray(ms.kf_mp)

    def res(Tk, Xp, k, n):
        Xc = Tk[:3, :3] @ Xp + Tk[:3, 3]
        u = CAM.fx * Xc[0] / Xc[2] + CAM.cx
        v = CAM.fy * Xc[1] / Xc[2] + CAM.cy
        # a negative u_r marks a mono observation: no third residual
        r2 = u - CAM.bf / Xc[2] - ur[k, n] if ur[k, n] >= 0 else 0.0
        return np.array([u - uv[k, n, 0], v - uv[k, n, 1], r2])

    def twist(d):
        A = np.zeros((4, 4))
        A[:3, :3] = [[0, -d[5], d[4]], [d[5], 0, -d[3]], [-d[4], d[3], 0]]
        A[:3, 3] = d[:3]
        return expm(A)

    dim = 6 * n_kf + 3 * n_pt
    H = np.zeros((dim, dim))
    b = np.zeros(dim)
    eps = 1e-6
    for k in range(n_kf):
        for n in np.flatnonzero(mp[k] >= 0):
            p = mp[k, n]
            r0 = res(T[k], X[p], k, n)
            J = np.zeros((3, dim))
            for i in range(6):
                d = np.zeros(6)
                d[i] = eps
                J[:, 6 * k + i] = (res(twist(d) @ T[k], X[p], k, n)
                                   - res(twist(-d) @ T[k], X[p], k, n)) / (2 * eps)
            for i in range(3):
                d = np.zeros(3)
                d[i] = eps
                J[:, 6 * n_kf + 3 * p + i] = (res(T[k], X[p] + d, k, n)
                                              - res(T[k], X[p] - d, k, n)) / (2 * eps)
            H += J.T @ J
            b -= J.T @ r0
    return H, b


def test_schur_terms_match_dense_normal_equations():
    """_schur_terms (the one BA assembly path) against the dense normal
    equations of test_ba's problem: the reduced camera system S and its
    right-hand side equal Hcc - Hcp Hpp^-1 Hpc and bc - Hcp Hpp^-1 bp."""
    rng = np.random.default_rng(17)
    ms, _, _, n_kf, n_pt = make_ba_problem(rng, n_pt=60, noise_px=0.5,
                                           stereo=True)
    obs_kf, obs_kp = M.build_obs_lists(ms, 16)
    es = ba._prep_edges(obs_kf, obs_kp, ms.kf_uv_und, ms.kf_uright,
                        ms.kf_octave, 2.0, ms.K)
    lam = 1e-6
    S0, bs, *_ = ba._schur_terms(
        CAM, ms.kf_Tcw, ms.pt_pos, es, obs_kf >= 0, ms.kf_valid,
        ms.pt_valid, False, lam,
    )
    H, b = _dense_normal_equations(ms, n_kf, n_pt)
    C = 6 * n_kf
    Hpp = H[C:, C:].copy()
    for p in range(n_pt):  # the same per-point damping as _schur_terms
        blk = slice(3 * p, 3 * p + 3)
        tr = np.trace(Hpp[blk, blk])
        Hpp[blk, blk] += (lam * max(tr / 3.0, 1e-8) + 1e-9) * np.eye(3)
    Hcp = H[:C, C:]
    S_ref = H[:C, :C] - Hcp @ np.linalg.solve(Hpp, Hcp.T)
    b_ref = b[:C] - Hcp @ np.linalg.solve(Hpp, b[C:])
    S = np.asarray(S0, np.float64)[:C, :C]
    scale = np.abs(S_ref).max()
    np.testing.assert_allclose(S, S_ref, atol=2e-4 * scale)
    np.testing.assert_allclose(np.asarray(bs, np.float64)[:n_kf].ravel(),
                               b_ref, atol=2e-4 * np.abs(b_ref).max())
