"""Distributed Sim(3) pose-graph optimization over a device mesh.

The essential graph after a loop closure is the reference's single biggest
global pass besides GBA (Optimizer::OptimizeEssentialGraph,
Optimizer.cc:717-956). Distribution: EDGES are sharded across
the mesh axis "dp" (each device holds E/n edges of the loop-closure graph);
every device assembles the normal-equation contribution of its edge shard
(solvers/pose_graph.edge_system) and ONE psum (NCCL all-reduce over
NVLink) combines the dense
[7K, 7K] system; the Cholesky solve + pose update are replicated (tiny
next to edge work).

Communication per GN iteration: one psum of (7K)^2 + 7K floats
(K=256 -> 12.9 MB) — independent of the edge count, so scaling over edges
is near-linear until the collective dominates (same recipe as
parallel/dist_ba.py and the BASELINE.json north star).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sdslam_tpu.solvers import pose_graph as pg


def _pad_edges(edges: pg.PoseGraphEdges, n_shards: int) -> pg.PoseGraphEdges:
    """Pad the edge arrays to a multiple of the shard count with weight-0
    edges (weight scales the one-hot assembly, so padding contributes
    exactly zero to H and b)."""
    E = edges.i.shape[0]
    pad = (-E) % n_shards
    if pad == 0:
        return edges
    return pg.PoseGraphEdges(
        i=jnp.concatenate([edges.i, jnp.zeros((pad,), jnp.int32)]),
        j=jnp.concatenate([edges.j, jnp.zeros((pad,), jnp.int32)]),
        S_ij=jnp.concatenate(
            [edges.S_ij, jnp.broadcast_to(jnp.eye(4), (pad, 4, 4))]
        ),
        weight=jnp.concatenate([edges.weight, jnp.zeros((pad,), jnp.float32)]),
    )


def distributed_pose_graph(
    mesh: Mesh,
    kf_Ssw,
    kf_valid,
    fixed_mask,
    edges: pg.PoseGraphEdges,
    iters: int = 20,
    fix_scale: bool = False,
    lm_lambda: float = 1e-6,
):
    """Drop-in distributed optimize_pose_graph (same result up to f32
    reduction order). Poses/masks are replicated; edges are sharded."""
    K = kf_Ssw.shape[0]
    n = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    edges = _pad_edges(edges, n)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(), P("dp"), P("dp"), P("dp"), P("dp")),
        out_specs=P(),
    )
    def run(S0, valid, fixed, ei, ej, Sij, w):
        local = pg.PoseGraphEdges(ei, ej, Sij, w)

        def gn_step(_, S_all):
            H, b = pg.edge_system(S_all, local, K, fix_scale)
            H = jax.lax.psum(H, "dp")
            b = jax.lax.psum(b, "dp")
            return pg.solve_and_update(
                S_all, H, b, valid, fixed, fix_scale, lm_lambda
            )

        return jax.lax.fori_loop(0, iters, gn_step, S0)

    # process-spanning global arrays when the mesh spans hosts
    from sdslam_tpu.parallel.multihost import global_put

    args = (
        global_put(mesh, kf_Ssw, P()),
        global_put(mesh, kf_valid, P()),
        global_put(mesh, fixed_mask, P()),
        global_put(mesh, edges.i, P("dp")),
        global_put(mesh, edges.j, P("dp")),
        global_put(mesh, edges.S_ij, P("dp")),
        global_put(mesh, edges.weight, P("dp")),
    )
    return jax.jit(run)(*args)
