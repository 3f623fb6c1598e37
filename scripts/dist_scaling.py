"""Distributed-BA scaling harness (VERDICT r3 next-round #4b).

Fixed GLOBAL problem (production-shaped: K keyframes, P points, E=P*M
edges); the distributed Schur GN step runs over CPU meshes of 1/2/4/8
virtual devices and reports:

  * per-iteration wall time at each shard count (the trend line for the
    BASELINE "near-linear scaling" north star — on virtual CPU devices
    the shards share cores, so the line measures formulation overhead,
    not interconnect scaling; with SDSLAM_DIST_PLATFORM=cuda on a
    multi-card host the same harness gives the real curve), and
  * shard-count INVARIANCE: the solution after N iterations must agree
    across mesh sizes (psum order only reorders float additions).

Run: XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
     python scripts/dist_scaling.py [--kf 64] [--pts 32768] [--obs 8]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# virtual CPU devices by default; SDSLAM_DIST_PLATFORM=cuda runs on the
# cards of a multi-card host instead
os.environ["JAX_PLATFORMS"] = os.environ.get("SDSLAM_DIST_PLATFORM", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--kf", type=int, default=64)
    ap.add_argument("--pts", type=int, default=32768)
    ap.add_argument("--obs", type=int, default=8)
    ap.add_argument("--iters", type=int, default=4)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

    from sdslam_tpu.parallel.dist_ba import make_distributed_gn_step
    from sdslam_tpu.geometry.camera import CameraModel
    from sdslam_tpu.io.synthetic import make_dist_ba_problem

    K, P, Mo = args.kf, args.pts, args.obs
    E = P * Mo
    print(f"global problem: K={K} P={P} M={Mo} E={E}")
    rng = np.random.default_rng(0)
    cam = CameraModel(fx=525.0, fy=525.0, cx=319.5, cy=239.5,
                      width=640, height=480, bf=40.0)
    (T0n, X0n, obs_kf, obs_kp, kf_uv, kf_ur, kf_oct, T_gt, pt_gt
     ) = make_dist_ba_problem(rng, K, P, Mo, cam)
    T0, X0 = jnp.asarray(T0n), jnp.asarray(X0n)
    obs_kf = jnp.asarray(obs_kf)
    obs_kp = jnp.asarray(obs_kp)
    obs_ok = obs_kf >= 0
    kf_uv, kf_ur, kf_oct = map(jnp.asarray, (kf_uv, kf_ur, kf_oct))
    cam_act = jnp.ones((K,), bool).at[0].set(False)
    pt_act = jnp.ones((P,), bool)

    results = {}
    times = {}
    for n_dev in (1, 2, 4, 8):
        devs = np.array(jax.devices()[:n_dev]).reshape(n_dev)
        mesh = Mesh(devs, axis_names=("dp",))
        step = make_distributed_gn_step(mesh, cam, K)
        T, X = T0, X0
        args_t = (obs_kf, obs_kp, obs_ok, kf_uv, kf_ur, kf_oct, cam_act,
                  pt_act)
        T, X = step(T, X, *args_t)  # compile + warm
        jax.block_until_ready((T, X))
        T, X = T0, X0
        t0 = time.perf_counter()
        for _ in range(args.iters):
            T, X = step(T, X, *args_t)
        jax.block_until_ready((T, X))
        dt = (time.perf_counter() - t0) / args.iters
        times[n_dev] = dt
        results[n_dev] = (np.asarray(T), np.asarray(X))
        err_T = float(np.abs(results[n_dev][0] - np.asarray(T_gt)).max())
        print(f"shards={n_dev}: {dt*1e3:8.1f} ms/GN-iter   "
              f"max|T - T_gt| = {err_T:.2e}")

    # shard-count invariance (psum reorders float sums -> loose f32 tol)
    ref_T, ref_X = results[1]
    for n_dev in (2, 4, 8):
        dT = np.abs(results[n_dev][0] - ref_T).max()
        dX = np.abs(results[n_dev][1] - ref_X).max()
        ok = dT < 5e-4 and dX < 5e-3
        print(f"invariance vs 1 shard: n={n_dev} max|dT|={dT:.2e} "
              f"max|dX|={dX:.2e} {'OK' if ok else 'FAIL'}")
        if not ok:
            sys.exit(1)
    base = times[1]
    print("scaling line (t1/tN, ideal=N on real hardware): "
          + ", ".join(f"{n}:{base/times[n]:.2f}x" for n in (1, 2, 4, 8)))

    # ---- distributed Sim3 pose graph at production shape (r5) ----------
    # K=192 loop-bearing ring: [7K,7K] = [1344,1344] normal equations,
    # ~380 edges sharded over 'dp'; per-iteration comm = ONE psum of the
    # dense system (7K)^2*4 B = 7.2 MB. Same invariance + trend contract
    # as the BA block above.
    from sdslam_tpu.geometry import lie
    from sdslam_tpu.parallel.dist_pose_graph import distributed_pose_graph
    from sdslam_tpu.solvers import pose_graph as pg_mod

    Kp = 192
    rngp = np.random.default_rng(11)
    T_gtp = []
    for k in range(Kp):
        th = 2 * np.pi * k / Kp
        xi = np.array([np.sin(th), 0.1 * np.sin(2 * th), 1 - np.cos(th),
                       0, th, 0], np.float32)
        T_gtp.append(np.asarray(lie.se3_exp(jnp.asarray(xi * 0.5))))
    T_estp = [T_gtp[0]]
    for k in range(1, Kp):
        rel = T_gtp[k] @ np.linalg.inv(T_gtp[k - 1])
        d = rngp.normal(size=6).astype(np.float32) * 0.25 / Kp
        T_estp.append(
            np.asarray(lie.se3_exp(jnp.asarray(d))) @ rel @ T_estp[-1])
    kf_Sp = jnp.asarray(np.stack(T_estp))
    validp = jnp.ones((Kp,), bool)
    parentp = jnp.asarray(
        np.concatenate([[-1], np.arange(Kp - 1)]).astype(np.int32))
    covisp = np.zeros((Kp, Kp), np.int32)
    for k in range(1, Kp):
        covisp[k - 1, k] = covisp[k, k - 1] = 150
    S_loopp = jnp.asarray(
        (T_gtp[Kp - 1] @ np.linalg.inv(T_gtp[0]))[None])
    edgesp, _dropped = pg_mod.make_edges_from_covisibility(
        kf_Sp, validp, jnp.asarray(covisp), parentp,
        loop_i=jnp.asarray([Kp - 1]), loop_j=jnp.asarray([0]),
        loop_S=S_loopp, covis_min=100, max_edges=1024,
    )
    fixedp = jnp.zeros((Kp,), bool).at[0].set(True)
    n_e = int(jnp.sum(edgesp.weight > 0))
    print(f"\npose graph: K={Kp} ([{7*Kp},{7*Kp}] system), "
          f"{n_e} active edges")
    pg_results = {}
    for n_dev in (1, 2, 4, 8):
        meshp = Mesh(np.array(jax.devices()[:n_dev]), ("dp",))
        S_opt = distributed_pose_graph(
            meshp, kf_Sp, validp, fixedp, edgesp, iters=2)
        jax.block_until_ready(S_opt)  # compile
        t0 = time.perf_counter()
        S_opt = distributed_pose_graph(
            meshp, kf_Sp, validp, fixedp, edgesp, iters=args.iters)
        jax.block_until_ready(S_opt)
        dt = (time.perf_counter() - t0) / args.iters
        pg_results[n_dev] = np.asarray(S_opt)
        print(f"shards={n_dev}: {dt*1e3:8.1f} ms/GN-iter")
    for n_dev in (2, 4, 8):
        dS = np.abs(pg_results[n_dev] - pg_results[1]).max()
        ok = dS < 5e-4
        print(f"invariance vs 1 shard: n={n_dev} max|dS|={dS:.2e} "
              f"{'OK' if ok else 'FAIL'}")
        if not ok:
            sys.exit(1)


if __name__ == "__main__":
    main()
