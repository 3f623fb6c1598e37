"""Worker for the 2-process multi-host distributed test.

Usage: python scripts/multihost_worker.py <process_id> <num_processes> <port>

Each process owns 4 virtual CPU devices; the global mesh spans 8 devices
across both processes (localhost TCP stands in for the network between
hosts). Both processes
build the SAME synthetic BA + pose-graph problems from a fixed seed, run the
distributed solvers over the process-spanning mesh, and process 0 checks the
result against the single-device solvers bit-for-tolerance. PASS on stdout
is the test contract (tests/test_multihost.py).
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

os.environ["JAX_PLATFORMS"] = "cpu"

from sdslam_tpu.parallel.multihost import (  # noqa: E402
    fetch_replicated, global_mesh, global_put, init_multihost,
)


def main():
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    init_multihost(
        coordinator_address=f"localhost:{port}",
        num_processes=nproc,
        process_id=pid,
        local_device_count=4,
    )
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P

    assert jax.process_count() == nproc, jax.process_count()
    assert len(jax.devices()) == 4 * nproc, len(jax.devices())
    mesh = global_mesh("dp")

    from test_ba import CAM, make_ba_problem, pose_errs  # noqa: E402

    from sdslam_tpu.geometry import lie
    from sdslam_tpu.parallel import dist_ba, dist_pose_graph
    from sdslam_tpu.solvers import ba, pose_graph

    # --- distributed BA across 2 processes ---
    rng = np.random.default_rng(3)
    ms, T_gt, X_gt, n_kf, n_pt = make_ba_problem(rng, noise_px=0.2, stereo=True)
    cam_active = ms.kf_valid.at[0].set(False)
    ms_d = dist_ba.distributed_bundle_adjust(
        mesh, CAM, ms, cam_active, ms.pt_valid, iters=10
    )
    kf_Tcw_dist = fetch_replicated(ms_d.kf_Tcw)

    # single-device oracle (plain jit on this process's first device)
    res = ba.bundle_adjust(CAM, ms, cam_active, ms.pt_valid)
    max_d = 0.0
    for k in range(1, n_kf):
        et, er = pose_errs(kf_Tcw_dist[k], T_gt[k])
        assert et < 0.01 and er < 0.01, (k, et, er)
        d = np.asarray(
            lie.se3_log(jnp.asarray(kf_Tcw_dist[k]) @ lie.se3_inv(res.kf_Tcw[k]))
        )
        max_d = max(max_d, float(np.abs(d).max()))
    assert max_d < 0.02, max_d  # same optimum basin as single-device

    # --- distributed Sim3 pose graph across 2 processes ---
    from test_sim3_posegraph import _ring_problem  # noqa: E402

    rng2 = np.random.default_rng(7)
    T_gt2, T_est, kf_S, valid, parent, covis, n_kf2 = _ring_problem(rng2)
    S_loop = jnp.asarray((T_gt2[n_kf2 - 1] @ np.linalg.inv(T_gt2[0]))[None])
    edges, _ = pose_graph.make_edges_from_covisibility(
        kf_S, valid, covis, parent,
        loop_i=jnp.asarray([n_kf2 - 1]), loop_j=jnp.asarray([0]), loop_S=S_loop,
        covis_min=100, max_edges=64,
    )
    fixed = jnp.zeros((kf_S.shape[0],), bool).at[0].set(True)
    S_single = pose_graph.optimize_pose_graph(
        kf_S, valid, fixed, edges, iters=20
    )
    S_dist = dist_pose_graph.distributed_pose_graph(
        mesh, kf_S, valid, fixed, edges, iters=20
    )
    S_dist_h = fetch_replicated(S_dist)
    dd = np.abs(S_dist_h - np.asarray(S_single)).max()
    assert dd < 1e-3, dd  # exact same algorithm, fp reduction order differs

    if pid == 0:
        print(f"PASS ba_basin_max={max_d:.5f} pgo_diff={dd:.2e} "
              f"procs={jax.process_count()} devices={len(jax.devices())}")


if __name__ == "__main__":
    main()
