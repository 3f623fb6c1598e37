"""Multi-host distributed runtime: process-spanning device meshes.

The reference is a single-process shared-memory program (SURVEY.md §2.9);
this build scales the map passes over cards that may span HOSTS:
`jax.distributed` for the process group, one global Mesh over every device
of every process, and global arrays assembled from process-local data. The
shard_map kernels (dist_ba / dist_align / dist_pose_graph) are
topology-agnostic — the same `psum("dp")` lowers to an NCCL all-reduce over
NVLink between the cards of a host and over the network across hosts; only
array construction differs (a process can only address its own devices),
which `global_put` hides.

Scaling recipe (BASELINE.md: near-linear frames/s at 1 chip -> 1 host ->
>= 2 hosts): keyframe pools and observation blocks are sharded over 'dp';
per-iteration communication is one psum of the reduced camera system
([6K,6K] — independent of the point count), so adding hosts adds point
throughput at constant collective cost.

Testing without a pod: 2 processes x 4 virtual CPU devices over localhost
TCP (tests/test_multihost.py) prove exact equivalence with the
single-process result — the same harness the driver's dryrun uses, plus a
real process boundary.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def init_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_count: Optional[int] = None,
    platform: Optional[str] = None,
):
    """Join (or create) a multi-process JAX runtime.

    Call BEFORE any other jax API touches the backend. Pass the
    coordinator address (e.g. `localhost:<port>` on one host), the process
    count and this process's id explicitly: nothing in the environment
    supplies them. For CPU-based testing also set `local_device_count`
    virtual devices per process. No-op when num_processes == 1 and no
    coordinator is configured (single-host mode)."""
    if local_device_count is not None:
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count={local_device_count}"
            ).strip()
        platform = platform or "cpu"
    if platform is not None:
        os.environ["JAX_PLATFORMS"] = platform
    import jax

    if platform is not None:
        jax.config.update("jax_platforms", platform)
    if coordinator_address is None and num_processes in (None, 1):
        return jax  # single host, nothing to initialize
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return jax


def global_mesh(axis: str = "dp"):
    """One flat mesh over EVERY device of EVERY process: the shard_map
    kernels only use collectives over a single axis, and every card of a
    host reaches every other over NVLink at the same rate, so the flat
    layout places no constraint on which devices own which shards."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()), (axis,))


def global_put(mesh, arr, spec):
    """Build a global (possibly process-spanning) array from host data.

    Every process passes the SAME full-size host array; each one
    contributes only the shards its own devices hold. Works identically in
    single-process mode (== device_put with a NamedSharding)."""
    import jax
    from jax.sharding import NamedSharding

    sh = NamedSharding(mesh, spec)
    a = np.asarray(arr)
    return jax.make_array_from_callback(a.shape, sh, lambda idx: a[idx])


def fetch_replicated(x):
    """Host value of a replicated global array (every process can read its
    addressable shard of a fully-replicated output)."""
    import jax

    shards = x.addressable_shards
    return np.asarray(shards[0].data)
