"""Bundle adjustment with Schur-complement elimination of landmarks.

Replaces the reference's g2o BlockSolver_6_3 + LM pipeline (Optimizer.cc:
LocalBundleAdjustment :417-714, BundleAdjustment/GlobalBundleAdjustemnt
:46-219) and the vendored g2o engine itself (src/extra/g2o) with one batched
formulation:

  * The observation graph comes straight from the map's kf_mp table
    (build_obs_lists): edges are [P, M] (point, observing-KF) pairs with a
    static per-point cap M.
  * Per-iteration: batched residuals/Jacobians for every edge at once ->
    per-point 3x3 Hpp + per-camera 6x6 Hcc via segment scatter -> dense
    Schur-reduced camera system S [6K, 6K] assembled by scatter-adding
    M x M per-point coupling blocks -> one dense Cholesky solve ->
    batched landmark back-substitution.
  * Fixed cameras (the reference's frontier KFs / KF0) stay in the system
    with a huge diagonal prior instead of being removed — static shapes,
    no graph rebuilds.
  * Robust Huber weights, per-octave information, mono 2D + stereo 3D
    (u, v, u_r) residuals; outlier observations erased between passes
    exactly like the reference's two-stage 5+10 iteration schedule.

The dense reduced camera system is deliberate: for K <= a few hundred KFs a
[6K, 6K] Cholesky is one dense solver call instead of sparse
pointer-chasing, and it is the unit that distributes across a device mesh
(psum of per-shard S contributions; see parallel/).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from sdslam_tpu.geometry import lie
from sdslam_tpu.geometry.camera import CameraModel
from sdslam_tpu.mapping import map_state as M

# Huber deltas are sqrt(5.991) / sqrt(7.815): the 95% chi2 quantiles for 2/3
# DoF the reference uses (Optimizer.cc:87-88)
CHI2_MONO = 5.991
CHI2_STEREO = 7.815
HUBER_MONO = 2.4477
HUBER_STEREO = 2.7955
FIXED_PRIOR = 1e12  # diagonal prior pinning fixed cameras


class BAResult(NamedTuple):
    kf_Tcw: jnp.ndarray  # [K,4,4] updated poses
    pt_pos: jnp.ndarray  # [P,3] updated points
    obs_inlier: jnp.ndarray  # [P,M] bool surviving observations
    chi2: jnp.ndarray  # scalar mean inlier chi2


class _EdgeStatic(NamedTuple):
    """Per-edge observation data that never changes across LM iterations —
    gathered ONCE per bundle_adjust instead of once per LM iteration.

    Layout is OBSERVATION-MAJOR [Mo, P]: a point's observations are the
    leading axis, so per-point reductions are sums over axis 0. Flat edge
    index e = m * P + p."""

    uv_obs: jnp.ndarray  # [Mo,P,2]
    ur_obs: jnp.ndarray  # [Mo,P]
    inv_sigma2: jnp.ndarray  # [Mo,P]
    stereo: jnp.ndarray  # [Mo,P] bool
    cam_onehot: jnp.ndarray  # [Mo,P,K] f32 one-hot of the observing camera


def _prep_edges(obs_kf, obs_kp, kf_uv_und, kf_uright, kf_octave, scale_factor, K):
    c = jnp.clip(obs_kf, 0, K - 1).T  # [M,P]
    k = jnp.clip(obs_kp, 0, kf_uv_und.shape[1] - 1).T
    # one packed (u, v, u_r, octave) gather: 4 fields per index
    fields = jnp.concatenate(
        [
            kf_uv_und,
            kf_uright[..., None],
            kf_octave.astype(jnp.float32)[..., None],
        ],
        axis=-1,
    )  # [K,N,4]
    g = fields[c, k]
    uv_obs = g[..., :2]
    ur_obs = g[..., 2]
    inv_sigma2 = 1.0 / scale_factor ** (2.0 * g[..., 3])
    stereo = ur_obs >= 0
    onehot = (c[..., None] == jnp.arange(K)[None, None, :]).astype(jnp.float32)
    return _EdgeStatic(uv_obs, ur_obs, inv_sigma2, stereo, onehot)


def _chol3x3(h00, h01, h02, h11, h12, h22):
    """Closed-form Cholesky L (lower) of batched symmetric 3x3, elementwise
    over arbitrarily-shaped arrays. Assumes SPD (guaranteed by damping)."""
    l00 = jnp.sqrt(jnp.maximum(h00, 1e-30))
    l10 = h01 / l00
    l20 = h02 / l00
    l11 = jnp.sqrt(jnp.maximum(h11 - l10 * l10, 1e-30))
    l21 = (h12 - l10 * l20) / l11
    l22 = jnp.sqrt(jnp.maximum(h22 - l20 * l20 - l21 * l21, 1e-30))
    return l00, l10, l20, l11, l21, l22


def _schur_terms(
    cam,
    kf_Tcw,
    pt_pos,
    es: _EdgeStatic,
    obs_ok,
    cam_active,
    pt_active,
    use_huber: bool,
    lm_lambda,
):
    """Edge pass + Schur assembly WITHOUT the camera prior/solve: returns
    (S0 [K6,K6] reduced camera system (Hcc on the diagonal, no damping
    prior), bs [K,6], Hpp_inv [P,3,3], W_pm [18,Mo,P], ybp [P,3] =
    Hpp^-1 bp, cost_cur scalar, Uflat [E,K]).

    Every returned term is either a plain sum over this problem's edges
    (S0, bs, cost) or point-local (Hpp_inv, W_pm, ybp) — exactly the
    contract the DISTRIBUTED backend needs: shard points over a mesh, run
    this per shard, psum (S0, bs, cost), apply the prior globally, solve
    replicated, back-substitute locally (parallel/dist_ba.py).

    Edges live in OBSERVATION-MAJOR [Mo, P] planes. Per-camera reductions
    (Hcc/bc columns, V·ybp) are [C,E] x [E,K] one-hot matmuls; S = Hcc -
    Z Z^T is 3 plain [6K,P] x [P,6K] matmuls."""
    K = kf_Tcw.shape[0]
    Mo, P = es.ur_obs.shape
    E = Mo * P
    hp = functools.partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)
    f32 = jnp.float32

    Uflat = es.cam_onehot.reshape(E, K)
    # camera pose per edge, via one one-hot matmul, contracted to [16,E]
    # directly (the (U @ T).T form materializes an [E,16] intermediate)
    T16 = jax.lax.dot_general(
        kf_Tcw.reshape(K, 16), Uflat, (((0,), (1,)), ((), ())),
        preferred_element_type=f32, precision=jax.lax.Precision.HIGHEST,
    )  # [16, E]
    okT = obs_ok.T  # [Mo,P]
    # one-hot times 0/1: exact at any matmul precision
    cam_act_e = (lie.mm(Uflat, cam_active.astype(f32))).reshape(Mo, P)
    pt_act_e = jnp.broadcast_to(pt_active[None, :], (Mo, P)).astype(f32)

    # explicit flat-[E] scalar formulas, e = m * P + p
    Xw = jnp.broadcast_to(pt_pos.T[:, None, :], (3, Mo, P)).reshape(3, E)
    stereo = es.stereo.reshape(E)
    info = es.inv_sigma2.reshape(E)
    uv_obs = es.uv_obs.reshape(E, 2)
    cam_e = cam_act_e.reshape(E)
    pt_e = pt_act_e.reshape(E)

    def psum(e):
        return e.reshape(Mo, P).sum(axis=0)

    r00, r01, r02, t0 = T16[0], T16[1], T16[2], T16[3]
    r10, r11, r12, t1 = T16[4], T16[5], T16[6], T16[7]
    r20, r21, r22, t2 = T16[8], T16[9], T16[10], T16[11]
    X0, X1, X2 = Xw[0], Xw[1], Xw[2]
    x = r00 * X0 + r01 * X1 + r02 * X2 + t0
    y = r10 * X0 + r11 * X1 + r12 * X2 + t1
    z = r20 * X0 + r21 * X1 + r22 * X2 + t2
    zi = 1.0 / jnp.maximum(z, 1e-6)
    zi2 = zi * zi
    u = cam.fx * x * zi + cam.cx
    v = cam.fy * y * zi + cam.cy
    ur = u - cam.bf * zi

    res0 = u - uv_obs[:, 0]
    res1 = v - uv_obs[:, 1]
    res2 = jnp.where(stereo, ur - es.ur_obs.reshape(E), 0.0)
    ok = (okT.reshape(E) & (z > 0.05)).astype(f32)

    chi2 = (res0 * res0 + res1 * res1 + res2 * res2) * info
    hub = jnp.where(stereo, HUBER_STEREO, HUBER_MONO)
    d2 = hub * hub
    rho = jnp.where(chi2 <= d2, chi2, 2.0 * hub * jnp.sqrt(chi2 + 1e-12) - d2)
    cost_cur = jnp.sum(rho * ok)

    w = info * ok
    if use_huber:
        w = w * jnp.minimum(
            1.0, hub / jnp.maximum(jnp.sqrt(chi2 + 1e-12), 1e-9)
        )

    # JX rows (d residual / d Xc), explicit [E] formulas
    fx, fy, bf = cam.fx, cam.fy, cam.bf
    st = stereo.astype(f32)
    JX = (
        (fx * zi, jnp.zeros_like(zi), -fx * x * zi2),
        (jnp.zeros_like(zi), fy * zi, -fy * y * zi2),
        (st * fx * zi, jnp.zeros_like(zi), st * (-fx * x * zi2 + bf * zi2)),
    )
    # Jc[r] = [JX[r] | Xc x JX[r]] (left-perturbation), masked by
    # cam_active; Jp[r] = JX[r] @ R, masked by pt_active
    Jc = []
    Jp = []
    for (a, b, c_) in JX:
        cx_ = c_ * y - b * z
        cy_ = a * z - c_ * x
        cz_ = b * x - a * y
        Jc.append(tuple(cam_e * q for q in (a, b, c_, cx_, cy_, cz_)))
        Jp.append(
            tuple(
                pt_e * q
                for q in (
                    a * r00 + b * r10 + c_ * r20,
                    a * r01 + b * r11 + c_ * r21,
                    a * r02 + b * r12 + c_ * r22,
                )
            )
        )
    res = (res0, res1, res2)

    def acc_rows(Ja, Jb, na, nb, sym):
        """Per-edge H entries sum_r w*Ja[r,i]*Jb[r,j] -> list of [E]."""
        out = []
        for i in range(na):
            for j in range(i if sym else 0, nb):
                out.append(w * sum(Ja[r][i] * Jb[r][j] for r in range(3)))
        return out

    # per-point 3x3 Hpp (6 sym comps) + bp, reduced over each pt's M obs
    hpp = [psum(e) for e in acc_rows(Jp, Jp, 3, 3, True)]
    bp = jnp.stack(
        [
            -psum(w * sum(Jp[r][i] * res[r] for r in range(3)))
            for i in range(3)
        ],
        axis=1,
    )  # [P,3]

    # per-camera 6x6 Hcc (21 sym comps) + bc (6): one matmul
    g_cols = acc_rows(Jc, Jc, 6, 6, True)
    g_cols += [
        -w * sum(Jc[r][i] * res[r] for r in range(3)) for i in range(6)
    ]
    w_cols = [
        w * sum(Jc[r][i] * Jp[r][j] for r in range(3))
        for i in range(6)
        for j in range(3)
    ]
    W_pm = jnp.stack(w_cols, axis=0).reshape(18, Mo, P)
    G = jnp.stack(g_cols, axis=1)  # [E,27]
    HG = hp("ek,ec->kc", Uflat, G)  # [K,27]

    # damped point blocks: closed-form Cholesky + inverse ([P] rows),
    # Hpp^-1 = Linv^T Linv
    h00, h01, h02, h11, h12, h22 = hpp
    damp = lm_lambda * jnp.maximum((h00 + h11 + h22) / 3.0, 1e-8) + 1e-9
    h00, h11, h22 = h00 + damp, h11 + damp, h22 + damp
    l00, l10, l20, l11, l21, l22 = _chol3x3(h00, h01, h02, h11, h12, h22)
    i00 = 1.0 / l00
    i11 = 1.0 / l11
    i22 = 1.0 / l22
    i10 = -l10 * i00 * i11
    i20 = (l10 * l21 - l20 * l11) * i00 * i11 * i22
    i21 = -l21 * i11 * i22
    s00 = i00 * i00 + i10 * i10 + i20 * i20
    s01 = i10 * i11 + i20 * i21
    s02 = i20 * i22
    s11 = i11 * i11 + i21 * i21
    s12 = i21 * i22
    s22 = i22 * i22
    Hpp_inv = jnp.stack(
        [
            jnp.stack([s00, s01, s02], -1),
            jnp.stack([s01, s11, s12], -1),
            jnp.stack([s02, s12, s22], -1),
        ],
        -2,
    )  # [P,3,3]
    ybp = hp("pij,pj->pi", Hpp_inv, bp)  # [P,3]

    # Z = V Linv^T at the edge level (Linv rows fold into W), then the
    # point-batched one-hot contraction scatters it per camera
    W6 = W_pm.reshape(6, 3, Mo, P)
    b2 = lambda a: a[None, None, :]  # [P] -> [1,1,P]
    Ze = jnp.concatenate(
        [
            W6[:, 0] * b2(i00),
            W6[:, 0] * b2(i10) + W6[:, 1] * b2(i11),
            W6[:, 0] * b2(i20) + W6[:, 1] * b2(i21) + W6[:, 2] * b2(i22),
        ],
        axis=0,
    )  # [18, Mo, P], channel j*6+i
    S_dense = _schur_S_from_ze(Ze, es.cam_onehot, K)

    # V·ybp contracted at the EDGE level ([6,E] @ [E,K] matmul)
    Vyb = hp(
        "ce,ek->kc",
        jnp.sum(W6 * ybp.T[None, :, None, :], axis=1).reshape(6, E),
        Uflat,
    )  # [K,6]

    # symmetric 6x6 from 21 packed columns via ONE gather (a scatter loop
    # here cost ~40 unfused kernels per LM iteration)
    tri_index = {}
    for idx, (i, j) in enumerate((i, j) for i in range(6) for j in range(i, 6)):
        tri_index[(i, j)] = idx
        tri_index[(j, i)] = idx
    gather_map = jnp.asarray(
        [[tri_index[(i, j)] for j in range(6)] for i in range(6)], jnp.int32
    )  # [6,6]
    Hcc = HG[:, gather_map.reshape(-1)].reshape(K, 6, 6)
    bc = HG[:, 21:]  # [K,6]
    bs = bc - Vyb

    # fold Hcc onto the diagonal: S0 is now the complete reduced camera
    # system minus the damping prior (applied by the caller AFTER any
    # cross-shard psum — the prior scales with the GLOBAL diagonal trace)
    KI = jnp.arange(K)
    S_dense = S_dense.reshape(K, 6, K, 6).at[KI, :, KI, :].add(Hcc)
    return (
        S_dense.reshape(K * 6, K * 6), bs, Hpp_inv, W_pm, ybp,
        cost_cur, Uflat,
    )


def _schur_S_from_ze(Ze, cam_onehot, K: int):
    """-Z Z^T from edge-level Ze [18, Mo, P] (channel j*6+i): the
    point-batched one-hot scatter + 3 plain [6K,P] x [P,6K] matmuls."""
    Mo, P = Ze.shape[1], Ze.shape[2]
    Zpm = Ze.transpose(2, 0, 1)  # [P,18,Mo]
    Zb = jax.lax.dot_general(
        Zpm, cam_onehot.transpose(1, 0, 2), (((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )  # [P,18,K]
    Z4 = Zb.transpose(2, 1, 0).reshape(K, 3, 6, P)  # (k, j, i, p)
    Zt = [Z4[:, j].reshape(K * 6, P) for j in range(3)]
    mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
    return -(mm(Zt[0], Zt[0].T) + mm(Zt[1], Zt[1].T) + mm(Zt[2], Zt[2].T))


def _apply_prior_and_solve(S0, bs, cam_active, lm_lambda, K: int):
    """Add the trace-scaled damping prior / fixed-camera prior to the
    (possibly psum'd) reduced system and solve for the camera step.

    (k,i)-major ordering throughout, matching _schur_terms."""
    S4 = S0.reshape(K, 6, K, 6)
    KI = jnp.arange(K)
    diag_blocks = S4[KI, :, KI, :]  # [K,6,6]
    tr_S = jnp.trace(diag_blocks, axis1=-2, axis2=-1)
    diag_scale = jnp.maximum(tr_S / 6.0, 1e-6)
    prior = jnp.where(cam_active, lm_lambda * diag_scale, FIXED_PRIOR)
    S4 = S4.at[KI, :, KI, :].add(
        prior[:, None, None] * jnp.broadcast_to(jnp.eye(6), (K, 6, 6))
    )
    S_flat = S4.reshape(K * 6, K * 6)
    L, low = jax.scipy.linalg.cho_factor(S_flat, lower=True)
    dc = jax.scipy.linalg.cho_solve((L, low), bs.reshape(K * 6)).reshape(K, 6)
    return dc * cam_active[:, None]


def _back_substitute(dc, Uflat, W_pm, Hpp_inv, ybp, pt_active):
    """Landmark step dp = Hpp^-1 (bp - W^T dc) = ybp - Hpp^-1 W^T dc,
    point-local (shardable)."""
    hp = functools.partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)
    _, Mo, P = W_pm.shape
    # [6,E] directly (the (U @ dc).T form materializes an [E,6] copy)
    dc_e = jax.lax.dot_general(
        dc, Uflat, (((0,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    ).reshape(6, Mo, P)
    Wt_dc = hp("ijmp,imp->pj", W_pm.reshape(6, 3, Mo, P), dc_e)  # [P,3]
    return (ybp - hp("pij,pj->pi", Hpp_inv, Wt_dc)) * pt_active[:, None]


def _gn_iteration(
    cam,
    kf_Tcw,
    pt_pos,
    es: _EdgeStatic,
    obs_ok,
    cam_active,
    pt_active,
    scale_factor,
    use_huber: bool,
    lm_lambda,
):
    """One damped GN step (single-device path): _schur_terms + prior +
    dense Cholesky + local back-substitution."""
    K = kf_Tcw.shape[0]
    S0, bs, Hpp_inv, W_pm, ybp, cost_cur, Uflat = _schur_terms(
        cam, kf_Tcw, pt_pos, es, obs_ok, cam_active, pt_active,
        use_huber, lm_lambda,
    )
    dc = _apply_prior_and_solve(S0, bs, cam_active, lm_lambda, K)
    dp = _back_substitute(dc, Uflat, W_pm, Hpp_inv, ybp, pt_active)
    kf_Tcw_new = jnp.where(
        cam_active[:, None, None], lie.mm(lie.se3_exp(dc), kf_Tcw), kf_Tcw
    )
    pt_pos_new = pt_pos + dp
    return kf_Tcw_new, pt_pos_new, cost_cur


def _edge_chi2(cam, kf_Tcw, pt_pos, es: _EdgeStatic, obs_ok):
    """chi2 [P,M] + (ok, stereo) masks, residuals only — flat [E] scalar
    formulation (no Jacobians, no [.,3,6] einsums). Outputs stay [P,M]
    (the caller-facing observation-table convention)."""
    Mo, P, K = es.cam_onehot.shape
    E = Mo * P
    Uflat = es.cam_onehot.reshape(E, K)
    T16 = jax.lax.dot_general(
        kf_Tcw.reshape(K, 16), Uflat, (((0,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )  # [16, E] directly, no relayout
    Xw = jnp.broadcast_to(pt_pos.T[:, None, :], (3, Mo, P)).reshape(3, E)
    x = T16[0] * Xw[0] + T16[1] * Xw[1] + T16[2] * Xw[2] + T16[3]
    y = T16[4] * Xw[0] + T16[5] * Xw[1] + T16[6] * Xw[2] + T16[7]
    z = T16[8] * Xw[0] + T16[9] * Xw[1] + T16[10] * Xw[2] + T16[11]
    zi = 1.0 / jnp.maximum(z, 1e-6)
    u = cam.fx * x * zi + cam.cx
    v = cam.fy * y * zi + cam.cy
    ur = u - cam.bf * zi
    stereo = es.stereo.reshape(E)
    uv_obs = es.uv_obs.reshape(E, 2)
    r0 = u - uv_obs[:, 0]
    r1 = v - uv_obs[:, 1]
    r2 = jnp.where(stereo, ur - es.ur_obs.reshape(E), 0.0)
    chi2 = (r0 * r0 + r1 * r1 + r2 * r2) * es.inv_sigma2.reshape(E)
    ok = obs_ok.T.reshape(E) & (z > 0.05)
    return chi2.reshape(Mo, P).T, ok.reshape(Mo, P).T, es.stereo.T


def _robust_cost(cam, kf_Tcw, pt_pos, es, obs_ok, scale_factor):
    """Total Huber-robustified cost over included edges (for LM accept/reject)."""
    chi2, ok, stereo = _edge_chi2(cam, kf_Tcw, pt_pos, es, obs_ok)
    delta = jnp.where(stereo, HUBER_STEREO, HUBER_MONO)
    d2 = delta * delta
    rho = jnp.where(chi2 <= d2, chi2, 2.0 * delta * jnp.sqrt(chi2 + 1e-12) - d2)
    return jnp.sum(jnp.where(ok, rho, 0.0))


def _chi2(cam, kf_Tcw, pt_pos, es, obs_ok, scale_factor):
    chi2, ok, stereo = _edge_chi2(cam, kf_Tcw, pt_pos, es, obs_ok)
    th = jnp.where(stereo, CHI2_STEREO, CHI2_MONO)
    inlier = obs_ok & ok & (chi2 <= th)
    mean = jnp.sum(jnp.where(inlier, chi2, 0.0)) / jnp.maximum(jnp.sum(inlier), 1)
    return chi2, inlier, mean


@functools.partial(
    jax.jit,
    static_argnames=("cam", "scale_factor", "iters1", "iters2", "max_obs"),
)
def bundle_adjust(
    cam: CameraModel,
    ms: M.MapState,
    cam_active,  # [K] bool: cameras to optimize (others fixed)
    pt_active,  # [P] bool: points to optimize
    scale_factor: float = 2.0,
    iters1: int = 4,
    iters2: int = 6,
    max_obs: int = 16,
    lm_lambda: float = 1e-4,
    obs_kf=None,
    obs_kp=None,
) -> BAResult:
    """Two-stage BA (5 iters -> outlier erase -> 10 iters), the reference's
    LocalBundleAdjustment schedule (Optimizer.cc:608-653)."""
    if obs_kf is None:
        obs_kf, obs_kp = M.build_obs_lists(ms, max_obs)
    obs_ok = obs_kf >= 0
    es = _prep_edges(
        obs_kf, obs_kp, ms.kf_uv_und, ms.kf_uright, ms.kf_octave,
        scale_factor, ms.K,
    )
    # a point is optimizable with >= 2 mono observations, or with a single
    # STEREO observation (u_r ties it to measured depth: a full 3D
    # measurement, so no gauge freedom — the RGB-D case)
    n_obs = jnp.sum(obs_ok, axis=1)
    n_stereo = jnp.sum(obs_ok & es.stereo.T, axis=1)
    pt_act = pt_active & ms.pt_valid & ((n_obs >= 2) | (n_stereo >= 1))
    cam_act = cam_active & ms.kf_valid
    # only edges of optimizable points enter the system: a frozen point with
    # residuals would act as a wrong anchor and bias every camera observing
    # it (the reference's BA graphs likewise contain only optimized points)
    obs_ok = obs_ok & pt_act[:, None]
    kf_Tcw, pt_pos, obs_in, mean = _ba_core(
        cam, ms.kf_Tcw, ms.pt_pos, es, obs_ok, cam_act, pt_act,
        scale_factor, iters1, iters2, lm_lambda,
    )
    return BAResult(kf_Tcw, pt_pos, obs_in, mean)


def _ba_core(
    cam, kf_Tcw, pt_pos, es, obs_ok, cam_act, pt_act,
    scale_factor, iters1: int, iters2: int, lm_lambda: float,
):
    """The LM schedule over an arbitrary (possibly compacted) BA system."""

    def stage(carry, n_iters, use_huber):
        """Levenberg-Marquardt with deferred accept/reject: each iteration
        makes ONE edge pass — the robust cost of the current iterate comes
        free with its residuals, so a worse step is rolled back at the start
        of the next iteration (vs g2o's evaluate-then-commit, which costs a
        second residual pass per LM step)."""
        kf_Tcw, pt_pos, obs_ok = carry

        def body(_, st):
            T, X, Tb, Xb, cb, lam = st
            T_new, X_new, cost_cur = _gn_iteration(
                cam, T, X, es, obs_ok,
                cam_act, pt_act, scale_factor, use_huber, lam,
            )
            accept = cost_cur <= cb
            Tb = jnp.where(accept, T, Tb)
            Xb = jnp.where(accept, X, Xb)
            cb = jnp.minimum(cost_cur, cb)
            lam_next = jnp.where(
                accept,
                jnp.maximum(lam * 0.5, 1e-7),
                jnp.minimum(lam * 8.0, 1e3),
            )
            # on accept, advance with the freshly-computed step; on reject the
            # step was linearized at a bad iterate — restart from the best
            T = jnp.where(accept, T_new, Tb)
            X = jnp.where(accept, X_new, Xb)
            return (T, X, Tb, Xb, cb, lam_next)

        inf = jnp.asarray(jnp.inf, jnp.float32)
        T, X, Tb, Xb, cb, _ = jax.lax.fori_loop(
            0, n_iters, body,
            (kf_Tcw, pt_pos, kf_Tcw, pt_pos, inf,
             jnp.asarray(lm_lambda, jnp.float32)),
        )
        # the last step was never cost-checked: keep it only if it improves
        cost_T = _robust_cost(cam, T, X, es, obs_ok, scale_factor)
        take = cost_T <= cb
        return jnp.where(take, T, Tb), jnp.where(take, X, Xb)

    kf_Tcw, pt_pos = stage((kf_Tcw, pt_pos, obs_ok), iters1, True)
    # outlier pass (Optimizer.cc:612-629)
    chi2, inlier, _ = _chi2(cam, kf_Tcw, pt_pos, es, obs_ok, scale_factor)
    obs_ok2 = obs_ok & inlier
    kf_Tcw, pt_pos = stage((kf_Tcw, pt_pos, obs_ok2), iters2, True)
    chi2, inlier, mean = _chi2(cam, kf_Tcw, pt_pos, es, obs_ok2, scale_factor)
    return kf_Tcw, pt_pos, obs_ok2 & inlier, mean


def apply_ba_result(
    ms: M.MapState, res: BAResult, obs_kf=None, obs_kp=None, max_obs: int = 16
) -> M.MapState:
    """Write BA output back into the map and erase outlier observations
    (the reference erases them under the map mutex, Optimizer.cc:686-695)."""
    if obs_kf is None:
        obs_kf, obs_kp = M.build_obs_lists(ms, max_obs)
    ms = ms._replace(kf_Tcw=res.kf_Tcw, pt_pos=res.pt_pos)
    # erase observations flagged as outliers: clear kf_mp[c, k]
    bad = (obs_kf >= 0) & (~res.obs_inlier)
    c = jnp.where(bad, obs_kf, ms.K)  # OOB sentinel -> dropped
    k = jnp.clip(obs_kp, 0, ms.N - 1)
    kf_mp = ms.kf_mp.at[c.ravel(), k.ravel()].set(-1, mode="drop")
    return ms._replace(kf_mp=kf_mp)


def local_ba(
    cam: CameraModel,
    ms: M.MapState,
    center_kf: int,
    scale_factor: float = 2.0,
    covis_min: int = 15,
    max_obs: int = 10,
    covis=None,
    max_local_kfs: int = 24,
    max_local_pts: int = 2048,
    iters1: int = 3,
    iters2: int = 5,
    inc=None,  # [K,P] incidence (shared across the mapping pass's consumers)
) -> M.MapState:
    """Local BA around a keyframe: optimize it + its covisible neighbors +
    their points; frontier KFs observing those points stay fixed
    (Optimizer::LocalBundleAdjustment, Optimizer.cc:417-714).

    Design: the local problem is COMPACTED into small static shapes —
    [KL] camera slots (locals + newest frontier anchors) and [PL] point
    slots — before the LM iterations. The full-pool formulation spent ~97%
    of its FLOPs on empty slots (a 6-KF/1.5k-point local window inside a
    64-KF/8k-point pool). Overflowing locals/points/edges are dropped from
    this BA pass (bounded-compute policy; they are picked up by later
    passes), unlike the reference, which grows its g2o graph without bound
    (Optimizer.cc:447-460).
    """
    KL = min(max_local_kfs, ms.K)
    PL = min(max_local_pts, ms.P)
    cov = M.covisibility(ms) if covis is None else covis
    local = cov[center_kf] >= covis_min
    local = local.at[center_kf].set(True)
    local = local & ms.kf_valid
    # the oldest keyframe is always fixed, even when covisible — the gauge
    # anchor (the reference fixes KF id 0 inside local BA, Optimizer.cc:486)
    oldest = jnp.argmin(
        jnp.where(ms.kf_valid, ms.kf_frame_id, jnp.iinfo(jnp.int32).max)
    )
    local = local.at[oldest].set(False)
    # active points: observed by any local KF. With a shared incidence
    # matrix both masks are matmuls; the scatter+gather formulation
    # paid two [K*N]-element table passes (~0.65 ms each at 64x1024).
    # `inc` may be a few mutations stale (computed at KF insertion, before
    # neighbor fusion rebinds points) — a merge winner observed only by
    # frontier KFs pre-fuse enters BA one pass late, the same bounded
    # staleness the shared covisibility already accepts.
    obs = M.observation_table(ms)
    if inc is not None:
        pt_local = jnp.dot(
            local.astype(jnp.bfloat16), inc,
            preferred_element_type=jnp.float32,
        ) > 0
        pt_local = pt_local & ms.pt_valid
        # frontier: fixed anchors observing local points (Optimizer.cc:447-460)
        frontier = jnp.dot(
            inc, pt_local.astype(jnp.bfloat16),
            preferred_element_type=jnp.float32,
        ) > 0
        frontier = frontier & ms.kf_valid & (~local)
    else:
        pt_local = jnp.zeros((ms.P,), bool)
        contrib = jnp.where(local[:, None], obs, -1)
        pt_local = pt_local.at[
            jnp.where(contrib >= 0, contrib, ms.P).ravel()
        ].set(True, mode="drop")
        pt_local = pt_local & ms.pt_valid
        hit = (obs >= 0) & pt_local[jnp.clip(obs, 0, ms.P - 1)]
        frontier = jnp.any(hit, axis=1) & ms.kf_valid & (~local)

    # --- camera compaction: locals first, then newest frontier ---
    fid = ms.kf_frame_id.astype(jnp.float32)
    fid = fid / jnp.maximum(jnp.max(fid), 1.0)  # in [0,1] recency tie-break
    score = jnp.where(local, 4.0, 0.0) + jnp.where(frontier, 2.0, 0.0) + fid
    top_score, cam_idx = jax.lax.top_k(score, KL)
    cam_in = top_score >= 2.0
    cam_idx = jnp.clip(cam_idx, 0, ms.K - 1)
    sub_T = ms.kf_Tcw[cam_idx]
    cam_act = local[cam_idx] & cam_in
    # safety: if no fixed anchor made the cut, freeze the oldest selected
    any_fixed = jnp.any(cam_in & (~cam_act))
    sel_fid = jnp.where(cam_in, ms.kf_frame_id[cam_idx], jnp.iinfo(jnp.int32).max)
    oldest_sel = jnp.argmin(sel_fid)
    cam_act = cam_act.at[oldest_sel].set(cam_act[oldest_sel] & any_fixed)

    # --- point compaction (O(P) cumsum instead of a top_k sort) ---
    pt_idx, pt_in, pt_remap = M.compact_indices(pt_local, PL)
    sub_X = ms.pt_pos[pt_idx]

    # --- compact observation lists (rows = compact cameras) ---
    obs_c = jnp.where(cam_in[:, None], obs[cam_idx], -1)  # [KL,N] orig pt ids
    obs_cp = jnp.where(obs_c >= 0, pt_remap[jnp.clip(obs_c, 0, ms.P - 1)], -1)
    obs_row, obs_kp = M.obs_lists_from_table(obs_cp, PL, max_obs)  # [PL,M]
    obs_ok = obs_row >= 0
    row_s = jnp.clip(obs_row, 0, KL - 1)
    kp_s = jnp.clip(obs_kp, 0, ms.N - 1)
    c_orig = cam_idx[row_s]  # [PL,M] original KF ids
    # ONE packed per-edge gather for (u, v, u_r, octave): arbitrary-index
    # gathers cost ~10 ns/INDEX, so the 4 fields ride one index stream
    fields = jnp.concatenate(
        [
            ms.kf_uv_und,
            ms.kf_uright[..., None],
            ms.kf_octave.astype(jnp.float32)[..., None],
        ],
        axis=-1,
    )  # [K,N,4] (dense build — bandwidth, not scatter)
    g = fields[c_orig.T, kp_s.T]  # [M,PL,4] (obs-major edge layout)
    uv_obs = g[..., :2]
    ur_obs = g[..., 2]
    inv_sigma2 = 1.0 / scale_factor ** (2.0 * g[..., 3])
    onehot = (
        (row_s.T[..., None] == jnp.arange(KL)[None, None, :])
        & obs_ok.T[..., None]
    ).astype(jnp.float32)
    es = _EdgeStatic(uv_obs, ur_obs, inv_sigma2, ur_obs >= 0, onehot)

    n_obs = jnp.sum(obs_ok, axis=1)
    n_stereo = jnp.sum(obs_ok & es.stereo.T, axis=1)
    pt_act = pt_in & ((n_obs >= 2) | (n_stereo >= 1))
    obs_ok = obs_ok & pt_act[:, None]

    # LM schedule default 3+5 (reference: 5+10, Optimizer.cc:608-653):
    # every local BA here starts from the previous BA's refined state at
    # keyframe cadence, so fewer iterations converge — ATE on the synthetic
    # benchmark is unchanged between 4+6 and 3+5 (0.133 cm both), and
    # tests/test_schedule_stress.py gates the trimmed schedule against the
    # reference-length one on fast motion (TrackingConfig.ba_schedule)
    T_new, X_new, obs_in, _ = _ba_core(
        cam, sub_T, sub_X, es, obs_ok, cam_act, pt_act,
        scale_factor, iters1, iters2, 1e-4,
    )

    # --- scatter back ---
    kf_Tcw = ms.kf_Tcw.at[jnp.where(cam_act, cam_idx, ms.K)].set(
        T_new, mode="drop"
    )
    pt_pos = ms.pt_pos.at[jnp.where(pt_act, pt_idx, ms.P)].set(
        X_new, mode="drop"
    )
    # erase outlier observations (Optimizer.cc:686-695)
    bad = obs_ok & (~obs_in)
    kf_mp = ms.kf_mp.at[
        jnp.where(bad, c_orig, ms.K).ravel(), kp_s.ravel()
    ].set(-1, mode="drop")
    return ms._replace(kf_Tcw=kf_Tcw, pt_pos=pt_pos, kf_mp=kf_mp)


def global_ba(
    cam: CameraModel,
    ms: M.MapState,
    fixed_kf: int = 0,
    scale_factor: float = 2.0,
    iters: int = 10,
    max_obs: int = 16,
) -> M.MapState:
    """Full-map BA with one gauge-fixing keyframe
    (GlobalBundleAdjustemnt [sic], Optimizer.cc:46-50)."""
    cam_active = ms.kf_valid.at[fixed_kf].set(False)
    obs_kf, obs_kp = M.build_obs_lists(ms, max_obs)
    res = bundle_adjust(
        cam, ms, cam_active, ms.pt_valid,
        scale_factor=scale_factor, iters1=iters // 2, iters2=iters, max_obs=max_obs,
        obs_kf=obs_kf, obs_kp=obs_kp,
    )
    return apply_ba_result(ms, res, obs_kf=obs_kf, obs_kp=obs_kp, max_obs=max_obs)
