"""Sim(3) pose-graph (essential-graph) optimization.

Replaces Optimizer::OptimizeEssentialGraph (Optimizer.cc:717-956): Sim3
vertices for every keyframe (7 DoF monocular / 6 DoF with fixed scale for
RGB-D, `_fix_scale`), edges from loop connections, the spanning tree,
previous loop edges and strong covisibility (>= 100 shared points), the loop
keyframe fixed, ~20 LM iterations, then SE3 recovery [R, t/s] and map-point
correction through each point's reference keyframe.

Formulation: edges live in fixed-capacity arrays [E] with masks; each GN
iteration evaluates every edge residual r = log_sim3(S_meas_ij * S_j *
S_i^-1) in one batch, assembles the dense [7K, 7K] system with one one-hot
einsum, solves by Cholesky, and updates S_i <- exp(d_i) * S_i.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from sdslam_tpu.geometry import lie


class PoseGraphEdges(NamedTuple):
    i: jnp.ndarray  # [E] int32 source keyframe slot
    j: jnp.ndarray  # [E] int32 target keyframe slot
    S_ij: jnp.ndarray  # [E,4,4] measured relative sim3: S_i * S_j^-1
    weight: jnp.ndarray  # [E] float32 (0 disables an edge)


def make_edges_from_covisibility(
    kf_Tcw,
    kf_valid,
    covis,
    parent,
    loop_i=None,
    loop_j=None,
    loop_S=None,
    stored_loops=None,  # [L,2] persistent loop edges (MapState.loop_edges)
    covis_min: int = 100,
    max_edges: int = 2048,
):
    """Build the essential-graph edge set from current poses (measurements
    are the CURRENT relative transforms, as in the reference, which
    constructs edges from poses before correction).

    Edge classes in priority order under the `max_edges` cap (the
    reference has no cap — it materializes every edge, Optimizer.cc:829-904;
    here connectivity-critical classes must never be displaced by bulk
    covisibility):
      3: stored loop edges from previous closures (Optimizer.cc:853-874)
      2: spanning-tree edges (Optimizer.cc:829-850)
      1: strong covisibility (>= covis_min shared, Optimizer.cc:877-904)
    The fresh loop edge of the in-flight correction (loop_i/j/S) is
    prepended outside the cap competition.

    Returns (edges, n_dropped) — n_dropped > 0 means covisibility edges were
    truncated (callers must log it: no silent caps)."""
    K = kf_Tcw.shape[0]
    ii, jj = jnp.meshgrid(jnp.arange(K), jnp.arange(K), indexing="ij")
    upper = ii < jj
    cov_ok = (covis >= covis_min) & upper & kf_valid[:, None] & kf_valid[None, :]
    # spanning-tree edges
    ks = jnp.arange(K)
    par_ok = (parent >= 0) & kf_valid
    tree = jnp.zeros((K, K), bool)
    tree = tree.at[jnp.where(par_ok, jnp.minimum(ks, parent), K),
                   jnp.where(par_ok, jnp.maximum(ks, parent), K)].set(
        True, mode="drop"
    )
    pri = cov_ok.astype(jnp.int32) + 2 * tree.astype(jnp.int32)
    if stored_loops is not None:
        li, lj = stored_loops[:, 0], stored_loops[:, 1]
        ok = (li >= 0) & (lj >= 0) & kf_valid[jnp.clip(li, 0, K - 1)] & (
            kf_valid[jnp.clip(lj, 0, K - 1)]
        )
        a = jnp.where(ok, jnp.minimum(li, lj), K)
        b = jnp.where(ok, jnp.maximum(li, lj), K)
        pri = pri.at[a, b].max(3, mode="drop")
    flat = pri.ravel()
    order = jnp.argsort(-flat)  # highest priority first (stable)
    sel = order[:max_edges]
    ei = (sel // K).astype(jnp.int32)
    ej = (sel % K).astype(jnp.int32)
    w = (flat[sel] > 0).astype(jnp.float32)
    n_dropped = jnp.sum(flat > 0) - jnp.sum(w > 0).astype(jnp.int32)
    S_i = kf_Tcw[ei]
    S_j = kf_Tcw[ej]
    S_ij = lie.mm(S_i, lie.sim3_inv(S_j))
    if loop_i is not None:
        ei = jnp.concatenate([loop_i, ei[: max_edges - loop_i.shape[0]]])
        ej = jnp.concatenate([loop_j, ej[: max_edges - loop_i.shape[0]]])
        S_ij = jnp.concatenate([loop_S, S_ij[: max_edges - loop_i.shape[0]]])
        w = jnp.concatenate(
            [jnp.ones((loop_i.shape[0],), jnp.float32) * 5.0,
             w[: max_edges - loop_i.shape[0]]]
        )
    return PoseGraphEdges(ei, ej, S_ij, w), n_dropped


def sim3_adjoint(S):
    """Adjoint of a Sim(3) element as a 7x7 matrix on the [rho, phi, sigma]
    tangent (batched over leading dims).

    For S = (sR, t): conjugating the algebra element m(xi) by S gives
      phi' = R phi,  sigma' = sigma,
      rho' = sR rho + hat(t) R phi - sigma t
    (derived from S m(xi) S^-1 with m(xi) = [[hat(phi)+sigma I, rho],[0,0]]).
    """
    R, t, s = lie.sim3_Rts(S)
    batch = S.shape[:-2]
    A = jnp.zeros(batch + (7, 7), S.dtype)
    A = A.at[..., 0:3, 0:3].set(s[..., None, None] * R)
    A = A.at[..., 0:3, 3:6].set(lie.mm(lie.hat(t), R))
    A = A.at[..., 0:3, 6].set(-t)
    A = A.at[..., 3:6, 3:6].set(R)
    A = A.at[..., 6, 6].set(1.0)
    return A


def sim3_ad(xi):
    """Algebra adjoint ad_xi (7x7) for the [rho, phi, sigma] tangent:
    bracket [xi1, xi2] has components
      d_rho = (hat(phi1)+sigma1 I) rho2 + hat(rho1) phi2 - rho1 sigma2
      d_phi = hat(phi1) phi2,   d_sigma = 0."""
    rho, phi, sigma = xi[..., 0:3], xi[..., 3:6], xi[..., 6]
    batch = xi.shape[:-1]
    eye3 = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), batch + (3, 3))
    A = jnp.zeros(batch + (7, 7), xi.dtype)
    A = A.at[..., 0:3, 0:3].set(lie.hat(phi) + sigma[..., None, None] * eye3)
    A = A.at[..., 0:3, 3:6].set(lie.hat(rho))
    A = A.at[..., 0:3, 6].set(-rho)
    A = A.at[..., 3:6, 3:6].set(lie.hat(phi))
    return A


def _jl_inv(r):
    """Inverse left Jacobian of sim3 via the BCH series
    Jl^-1(r) = I - ad_r/2 + ad_r^2/12 - ... (accurate for the small
    residuals a converging pose graph produces; the truncation only
    perturbs the GN step direction, not the r=0 fixed point)."""
    ad = sim3_ad(r)
    eye = jnp.broadcast_to(jnp.eye(7, dtype=r.dtype), ad.shape)
    return eye - 0.5 * ad + (1.0 / 12.0) * lie.mm(ad, ad)


def edge_system(S_all, edges: PoseGraphEdges, K: int, fix_scale: bool):
    """Assemble the GN normal equations of an edge set: returns
    (H [K*7, K*7], b [K*7]) WITHOUT damping/prior — the shard-local building
    block shared by the single-device optimizer and the distributed one
    (parallel/dist_pose_graph.py psums these over an edge-sharded mesh)."""
    D = 7

    def jac_analytic(S_all):
        """Closed-form adjoint Jacobians wrt left-perturbation of S_i / S_j.

        r(d_i) = log(A0 Exp(-d_i))  = log(Exp(-Ad_{A0} d_i) A0)
                 ~ r0 - Jl^-1(r0) Ad_{A0} d_i
        r(d_j) = log(S_meas Exp(d_j) S_j S_i^-1)
                 = log(Exp(Ad_{S_meas} d_j) A0) ~ r0 + Jl^-1(r0) Ad_{S_meas} d_j

        Exact to the Jl^-1 series truncation — unlike the previous
        finite-difference path (14 perturbed evaluations/edge, eps=1e-4 in
        f32), this is one 7x7 chain per edge with no precision cliff as K/E
        grow. g2o's EdgeSim3 uses numeric differentiation here
        (/root/reference/src/extra/g2o/core/base_binary_edge.hpp default
        linearizeOplus); the closed form replaces it outright."""
        Si = S_all[edges.i]
        Sj = S_all[edges.j]
        A0 = lie.mm(lie.mm(edges.S_ij, Sj), lie.sim3_inv(Si))
        r0 = lie.sim3_log(A0)
        Jl = _jl_inv(r0)
        Ji = -lie.mm(Jl, sim3_adjoint(A0))
        Jj = lie.mm(Jl, sim3_adjoint(edges.S_ij))
        return r0, Ji, Jj

    hp = functools.partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)
    Ui = (edges.i[:, None] == jnp.arange(K)[None, :]).astype(jnp.float32) * edges.weight[:, None]
    Uj = (edges.j[:, None] == jnp.arange(K)[None, :]).astype(jnp.float32) * edges.weight[:, None]
    r, Ji, Jj = jac_analytic(S_all)
    if fix_scale:
        # 6-DoF mode: zero the scale tangent (RGB-D, Optimizer.cc:770)
        scale_mask = jnp.ones((D,)).at[6].set(0.0)
        Ji = Ji * scale_mask[None, :, None] * scale_mask[None, None, :]
        Jj = Jj * scale_mask[None, :, None] * scale_mask[None, None, :]
        r = r * scale_mask[None, :]
    # assemble H [K,7,K,7] via one-hot einsums (no scatters)
    JiU = hp("ek,erd->kerd", Ui, Ji)  # prescaled by weight
    JjU = hp("ek,erd->kerd", Uj, Jj)
    Jall = JiU + JjU  # [K,E,7,7] sparse-by-construction
    H = hp("kera,lerb->kalb", Jall, Jall)
    b = -hp("kera,er->ka", Jall, r)
    return H.reshape(K * D, K * D), b.reshape(K * D)


def solve_and_update(S_all, H, b, kf_valid, fixed_mask, fix_scale: bool,
                     lm_lambda: float):
    """Damp + solve the assembled system and apply the sim3 update."""
    K = S_all.shape[0]
    D = 7
    Hk = H.reshape(K, D, K, D)
    diag = jnp.maximum(jnp.einsum("kaka->ka", Hk), 1e-8)
    fixed_or_invalid = fixed_mask | (~kf_valid)
    prior = jnp.where(fixed_or_invalid[:, None], 1e12, lm_lambda * diag + 1e-6)
    Hd = H + jnp.diag(prior.reshape(-1))
    cfac = jax.scipy.linalg.cho_factor(Hd, lower=True)
    delta = jax.scipy.linalg.cho_solve(cfac, b).reshape(K, D)
    delta = delta * (~fixed_or_invalid)[:, None]
    if fix_scale:
        delta = delta.at[:, 6].set(0.0)
    return lie.mm(lie.sim3_exp(delta), S_all)


@functools.partial(jax.jit, static_argnames=("iters", "fix_scale"))
def optimize_pose_graph(
    kf_Ssw,  # [K,4,4] current sim3 world->cam (sR | t), se3 embed ok
    kf_valid,
    fixed_mask,  # [K] bool: keyframes held fixed (the loop KF)
    edges: PoseGraphEdges,
    iters: int = 20,
    fix_scale: bool = False,
    lm_lambda: float = 1e-6,
):
    """GN on sim3 vertices; returns corrected [K,4,4] sim3 poses."""
    K = kf_Ssw.shape[0]

    def gn_step(_, S_all):
        H, b = edge_system(S_all, edges, K, fix_scale)
        return solve_and_update(
            S_all, H, b, kf_valid, fixed_mask, fix_scale, lm_lambda
        )

    return jax.lax.fori_loop(0, iters, gn_step, kf_Ssw)
