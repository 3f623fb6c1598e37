"""The whole pose-only Gauss-Newton solve as one Pallas kernel (Triton route).

solvers/pose_opt.optimize_pose runs rounds x iters GN steps of a 6x6 system
over ~1k reprojection edges, twice per frame. On XLA:GPU every step is a
handful of small kernels plus a solver custom call inside a loop. Here one
block holds every edge in registers ([N] vectors, N a power of two) and
runs all rounds and iterations in-kernel: per step, 27 block reductions
build H and b, a closed-form 6x6 Cholesky solves for the left increment,
and the SE(3) exponential updates a pose kept as 12 scalars. Between rounds
the chi2 test reclassifies inliers; Huber weights apply in the first two
rounds (Optimizer.cc:343-407).

Edge rows (one [8, N] f32 operand): X world (3), observed u, v, u_right
(< 0: mono edge), per-octave information, valid (0/1). Scalars (one [32]
f32 operand): T_init rows 0-2 (12), T_prior^-1 rows 0-2 (12), translation
and rotation prior information. Outputs: [16] f32 (pose rows 0-2, inlier
count, total inlier chi2) and [N] int32 inlier flags.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from sdslam_tpu.geometry.camera import CameraModel

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
HUBER_MONO = 2.4477
HUBER_STEREO = 2.7955
N_SCALARS = 32
N_OUT = 16


def _exp_se3(d):
    """xi = (rho, phi) -> 12 pose entries (rows 0-2), lie.se3_exp's formulas."""
    d0, d1, d2, d3, d4, d5 = d
    th2 = d3 * d3 + d4 * d4 + d5 * d5
    th = jnp.sqrt(jnp.maximum(th2, 0.0))
    small = th2 < 1e-8
    a = jnp.where(small, 1.0 - th2 / 6.0, jnp.sin(th) / jnp.maximum(th, 1e-8))
    b = jnp.where(small, 0.5 - th2 / 24.0,
                  (1.0 - jnp.cos(th)) / jnp.maximum(th2, 1e-8))
    c = jnp.where(small, 1.0 / 6.0 - th2 / 120.0,
                  (th - jnp.sin(th)) / jnp.maximum(th2 * th, 1e-8))
    # K = hat(phi), K2 = K @ K
    k2 = ((-d4 * d4 - d5 * d5, d3 * d4, d3 * d5),
          (d3 * d4, -d3 * d3 - d5 * d5, d4 * d5),
          (d3 * d5, d4 * d5, -d3 * d3 - d4 * d4))
    k = ((0.0, -d5, d4), (d5, 0.0, -d3), (-d4, d3, 0.0))
    eye = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))
    R = [[eye[i][j] + a * k[i][j] + b * k2[i][j] for j in range(3)]
         for i in range(3)]
    V = [[eye[i][j] + b * k[i][j] + c * k2[i][j] for j in range(3)]
         for i in range(3)]
    t = [V[i][0] * d0 + V[i][1] * d1 + V[i][2] * d2 for i in range(3)]
    return [R[0][0], R[0][1], R[0][2], t[0], R[1][0], R[1][1], R[1][2], t[1],
            R[2][0], R[2][1], R[2][2], t[2]]


def _compose(A, B):
    """Rows 0-2 of A @ B for 12-entry poses."""
    out = []
    for i in range(3):
        for j in range(4):
            v = (A[4 * i] * B[j] + A[4 * i + 1] * B[4 + j]
                 + A[4 * i + 2] * B[8 + j])
            out.append(v + A[4 * i + 3] if j == 3 else v)
    return out


def _log_se3(T):
    """12 pose entries -> xi (rho, phi), lie.se3_log's generic and
    small-angle branches (the prior residual is a small rotation)."""
    tr = T[0] + T[5] + T[10]
    cos_t = jnp.clip((tr - 1.0) * 0.5, -1.0, 1.0)
    th = jnp.arccos(cos_t)
    w = (T[9] - T[6], T[2] - T[8], T[4] - T[1])
    scale = jnp.where(th < 1e-4, 0.5 + th * th / 12.0,
                      th / jnp.maximum(2.0 * jnp.sin(th), 1e-8))
    p = [scale * wi for wi in w]
    th2 = p[0] * p[0] + p[1] * p[1] + p[2] * p[2]
    th = jnp.sqrt(jnp.maximum(th2, 0.0))
    half = 0.5 * th
    cot = half * jnp.cos(half) / jnp.maximum(jnp.sin(half), 1e-8)
    c = jnp.where(th2 < 1e-8, 1.0 / 12.0 + th2 / 720.0,
                  (1.0 - cot) / jnp.maximum(th2, 1e-8))
    k = ((0.0, -p[2], p[1]), (p[2], 0.0, -p[0]), (-p[1], p[0], 0.0))
    k2 = ((-p[1] * p[1] - p[2] * p[2], p[0] * p[1], p[0] * p[2]),
          (p[0] * p[1], -p[0] * p[0] - p[2] * p[2], p[1] * p[2]),
          (p[0] * p[2], p[1] * p[2], -p[0] * p[0] - p[1] * p[1]))
    t = (T[3], T[7], T[11])
    rho = []
    for i in range(3):
        row = [(1.0 if i == j else 0.0) - 0.5 * k[i][j] + c * k2[i][j]
               for j in range(3)]
        rho.append(row[0] * t[0] + row[1] * t[1] + row[2] * t[2])
    return rho + p


def _solve6(H, b):
    """Closed-form Cholesky solve of the symmetric 6x6 system H x = b
    (H as a dict {(i, j): scalar}, i >= j)."""
    L = {}
    for j in range(6):
        s = H[(j, j)] - sum(L[(j, k)] * L[(j, k)] for k in range(j))
        L[(j, j)] = jnp.sqrt(jnp.maximum(s, 1e-30))
        for i in range(j + 1, 6):
            s = H[(i, j)] - sum(L[(i, k)] * L[(j, k)] for k in range(j))
            L[(i, j)] = s / L[(j, j)]
    y = []
    for i in range(6):
        y.append((b[i] - sum(L[(i, k)] * y[k] for k in range(i))) / L[(i, i)])
    x = [None] * 6
    for i in reversed(range(6)):
        s = y[i] - sum(L[(k, i)] * x[k] for k in range(i + 1, 6))
        x[i] = s / L[(i, i)]
    return x


def _edges_at(cam, T, e):
    """Residuals, Jacobian rows and masks of every edge at pose T."""
    X0, X1, X2, uo, vo, uro, isig, valid = e
    x = T[0] * X0 + T[1] * X1 + T[2] * X2 + T[3]
    y = T[4] * X0 + T[5] * X1 + T[6] * X2 + T[7]
    z = T[8] * X0 + T[9] * X1 + T[10] * X2 + T[11]
    zi = 1.0 / jnp.maximum(z, 1e-6)
    zi2 = zi * zi
    u = cam.fx * x * zi + cam.cx
    v = cam.fy * y * zi + cam.cy
    stereo = uro >= 0.0
    st = jnp.where(stereo, 1.0, 0.0)
    r = (u - uo, v - vo, jnp.where(stereo, u - cam.bf * zi - uro, 0.0))
    zero = jnp.zeros_like(x)
    jx = ((cam.fx * zi, zero, -cam.fx * x * zi2),
          (zero, cam.fy * zi, -cam.fy * y * zi2),
          (st * cam.fx * zi, zero, st * (-cam.fx * x * zi2 + cam.bf * zi2)))
    # d(Xc)/d(left increment) = [I | -hat(Xc)]
    J = [(a0, a1, a2, a2 * y - a1 * z, a0 * z - a2 * x, a1 * x - a0 * y)
         for a0, a1, a2 in jx]
    behind = z <= 0.05
    return r, J, behind, stereo


def _pose_kernel(e_ref, s_ref, o_ref, inl_ref, *, cam, rounds, iters,
                 has_prior):
    e = [e_ref[k, :] for k in range(8)]
    isig, valid = e[6], e[7] > 0.5
    T0 = [s_ref[k] for k in range(12)]
    Tp_inv = [s_ref[12 + k] for k in range(12)]
    w_prior = [s_ref[24]] * 3 + [s_ref[25]] * 3

    def gn_step(T, inl, use_huber):
        r, J, behind, stereo = _edges_at(cam, T, e)
        m = inl & valid & (~behind)
        w = jnp.where(m, isig, 0.0)
        if use_huber:
            rn = jnp.sqrt((r[0] * r[0] + r[1] * r[1] + r[2] * r[2]) * isig
                          + 1e-12)
            dh = jnp.where(stereo, HUBER_STEREO, HUBER_MONO)
            w = w * jnp.minimum(1.0, dh / jnp.maximum(rn, 1e-9))
        H = {}
        for i in range(6):
            for j in range(i + 1):
                H[(i, j)] = jnp.sum(
                    w * (J[0][i] * J[0][j] + J[1][i] * J[1][j]
                         + J[2][i] * J[2][j]))
        b = [-jnp.sum(w * (J[0][i] * r[0] + J[1][i] * r[1] + J[2][i] * r[2]))
             for i in range(6)]
        if has_prior:
            xi = _log_se3(_compose(T, Tp_inv))
            for i in range(6):
                H[(i, i)] = H[(i, i)] + w_prior[i]
                b[i] = b[i] - w_prior[i] * xi[i]
        tr = sum(H[(i, i)] for i in range(6))
        damp = 1e-6 * jnp.maximum(tr / 6.0, 1e-8)
        for i in range(6):
            H[(i, i)] = H[(i, i)] + damp
        return _compose(_exp_se3(_solve6(H, b)), T)

    def classify(T):
        r, _, behind, stereo = _edges_at(cam, T, e)
        chi2 = (r[0] * r[0] + r[1] * r[1] + r[2] * r[2]) * isig
        th = jnp.where(stereo, CHI2_STEREO, CHI2_MONO)
        return valid & (~behind) & (chi2 <= th), chi2

    T, inl = T0, valid
    for rnd in range(rounds):
        T = list(jax.lax.fori_loop(
            0, iters,
            lambda _, T, inl=inl, rnd=rnd: tuple(gn_step(list(T), inl, rnd < 2)),
            tuple(T),
        ))
        inl, _ = classify(T)
    _, chi2 = classify(T)
    total = jnp.sum(jnp.where(inl, chi2, 0.0))
    n_inl = jnp.sum(jnp.where(inl, 1.0, 0.0))
    idx = jax.lax.broadcasted_iota(jnp.int32, (N_OUT,), 0)
    out = jnp.zeros((N_OUT,), jnp.float32)
    for k, val in enumerate(T + [n_inl, total]):
        out = jnp.where(idx == k, val, out)
    o_ref[...] = out
    inl_ref[...] = jnp.where(inl, 1, 0).astype(jnp.int32)


def pack(X, uv_obs, ur_obs, inv_sigma2, valid, Tcw_init, T_prior_inv,
         prior_trans_info, prior_rot_info):
    """(edges [8, Np], scalars [32]) with Np the next power of two >= N;
    padding edges are invalid."""
    N = X.shape[0]
    n_pad = max(16, 1 << (N - 1).bit_length())
    f32 = jnp.float32
    rows = jnp.concatenate([
        X.T.astype(f32), uv_obs.T.astype(f32), ur_obs[None].astype(f32),
        inv_sigma2[None].astype(f32), valid[None].astype(f32),
    ])
    edges = jnp.pad(rows, ((0, 0), (0, n_pad - N)))
    scal = jnp.concatenate([
        Tcw_init[:3].reshape(12).astype(f32),
        T_prior_inv[:3].reshape(12).astype(f32),
        jnp.stack([jnp.asarray(prior_trans_info, f32),
                   jnp.asarray(prior_rot_info, f32)]),
        jnp.zeros((N_SCALARS - 26,), f32),
    ])
    return edges, scal


@functools.partial(
    jax.jit,
    static_argnames=("cam", "rounds", "iters", "has_prior", "interpret"),
)
def pose_solve(cam: CameraModel, edges, scal, rounds: int, iters: int,
               has_prior: bool, interpret: bool = False):
    """Run the kernel on packed inputs; returns ([16] f32, [Np] int32)."""
    n_pad = edges.shape[1]
    kernel = functools.partial(_pose_kernel, cam=cam, rounds=rounds,
                               iters=iters, has_prior=has_prior)
    return pl.pallas_call(
        kernel,
        out_shape=(jax.ShapeDtypeStruct((N_OUT,), jnp.float32),
                   jax.ShapeDtypeStruct((n_pad,), jnp.int32)),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="pose_solve",
    )(edges, scal)
