"""Hamming-distance matching primitives for packed 256-bit ORB descriptors.

Replaces ORBmatcher's popcount loop + per-point candidate iteration
(/root/reference/src/ORBmatcher.cc:1459-1473 DescriptorDistance, and the
windowed searches built on it) with dense masked [Q, T] distance matrices
instead of pointer-chasing per candidate.

Conventions: descriptors are [N, 8] uint32 (256 bits).  Invalid slots must be
masked by the caller; distances at masked entries are BIG.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

TH_LOW = 50  # strict match threshold (ORBmatcher.cc:36)
TH_HIGH = 100  # loose match threshold (ORBmatcher.cc:37)
HISTO_BINS = 30  # rotation-consistency histogram bins (ORBmatcher.cc:38)
BIG = 1 << 20  # sentinel distance for masked entries


def _unpack_bits_i8(d):
    """[N,8] uint32 -> [N,256] int8 in {0,1}."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    b = (d[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)
    return b.reshape(d.shape[0], 256).astype(jnp.int8)


def hamming_matrix(da, db):
    """[Qa,8] x [Qb,8] uint32 -> [Qa,Qb] int32 Hamming distances.

    pop(a ^ b) = pop(a) + pop(b) - 2 <bits(a), bits(b)>: the bits are
    unpacked to 0/1 int8 once and the cross term is one int8 dot_general
    with int32 accumulation — exact, and on the H100 faster than an
    XOR+popcount broadcast at matcher shapes (PERF.md)."""
    ba = _unpack_bits_i8(da)
    bb = _unpack_bits_i8(db)
    dot = jax.lax.dot_general(
        ba, bb, (((1,), (1,)), ((), ())), preferred_element_type=jnp.int32,
    )
    pa = jnp.sum(ba.astype(jnp.int32), axis=1)
    pb = jnp.sum(bb.astype(jnp.int32), axis=1)
    return pa[:, None] + pb[None, :] - 2 * dot


def hamming_vec(da, db):
    """Rowwise distance for aligned pairs: [N,8] x [N,8] -> [N]."""
    x = jnp.bitwise_xor(da, db)
    return jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)


def masked_dist(da, db, mask):
    """Distance matrix with BIG where mask is False. mask: [Qa,Qb] bool."""
    return jnp.where(mask, hamming_matrix(da, db), BIG)


def best2(dist):
    """Per-row best and second-best: returns (d1, j1, d2)."""
    j1 = jnp.argmin(dist, axis=1)
    d1 = jnp.take_along_axis(dist, j1[:, None], axis=1)[:, 0]
    dist2 = dist.at[jnp.arange(dist.shape[0]), j1].set(BIG)
    d2 = jnp.min(dist2, axis=1)
    return d1, j1, d2


def resolve_to_targets(best_j, best_d, q_valid, n_targets: int):
    """Invert a query->target assignment, keeping the lowest-distance query
    per target (the reference's "already matched with smaller dist" rule,
    e.g. ORBmatcher.cc:1007-1030).

    Returns target->query [n_targets] int32 (-1 none) and its distance.
    """
    q = jnp.arange(best_j.shape[0], dtype=jnp.int32)
    # combined int32 sort key: distance (10 bits suffice for <=256-bit
    # descriptors) in high bits, query index (16 bits, so fused multi-frame
    # query batches fit) in low bits
    d10 = jnp.clip(best_d, 0, 1022)
    sentinel = 1023 * (1 << 16)
    key = jnp.where(q_valid, d10 * (1 << 16) + q, sentinel)
    tgt_key = jnp.full((n_targets,), sentinel, jnp.int32)
    tgt_key = tgt_key.at[jnp.clip(best_j, 0, n_targets - 1)].min(key)
    has = tgt_key < sentinel
    match_q = jnp.where(has, tgt_key % (1 << 16), -1).astype(jnp.int32)
    match_d = jnp.where(has, tgt_key // (1 << 16), BIG).astype(jnp.int32)
    return match_q, match_d


def rotation_consistency(dtheta, valid, bins: int = HISTO_BINS):
    """Keep only matches whose angle difference falls in the 3 dominant
    histogram bins (ORBmatcher::ComputeThreeMaxima, ORBmatcher.cc:1423-1454).

    dtheta: [N] radians; valid: [N] bool.  Returns filtered valid mask.
    """
    two_pi = 2.0 * jnp.pi
    frac = jnp.mod(dtheta / two_pi, 1.0)
    b = jnp.clip(jnp.round(frac * bins).astype(jnp.int32) % bins, 0, bins - 1)
    hist = jnp.zeros((bins,), jnp.int32).at[b].add(valid.astype(jnp.int32))
    top3 = jax.lax.top_k(hist, 3)[0]
    # reference keeps bins 2/3 only if >= 0.1x the max bin; a bin survives if
    # its count reaches the weakest kept top-3 count
    kept = jnp.where(top3 * 10 >= top3[0], top3, jnp.iinfo(jnp.int32).max)
    min_kept = jnp.maximum(jnp.min(kept), 1)
    return valid & (hist[b] >= min_kept)
