"""Tests that need a CUDA device (marker `gpu`).

They skip on the CPU; `python chip_smoke.py` runs them on the card, in its
own process (its kernel phase compares each kernel, compiled for the card,
with its XLA version at full width, and its RGB-D phase holds the tracker's
accuracy gates). What they guard is what the CPU suite cannot see: float32
products silently running in TF32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sdslam_tpu.geometry import lie

pytestmark = pytest.mark.gpu


def test_pose_products_keep_float32_on_card(gpu_device):
    """lie.mm composes poses at full float32 on the card: a 40-long chain
    of products (one frame's worth) stays within float32 rounding of the
    float64 product, where TF32 would be off by ~1e-3."""
    rng = np.random.default_rng(0)
    xi = rng.normal(size=(40, 6)).astype(np.float32) * 0.3
    Ts = np.asarray(lie.se3_exp(jnp.asarray(xi)), np.float64)
    ref = np.eye(4)
    for T in Ts:
        ref = T @ ref

    @jax.jit
    def chain(Ts):
        return jax.lax.fori_loop(
            0, Ts.shape[0], lambda i, A: lie.mm(Ts[i], A),
            jnp.eye(4, dtype=jnp.float32),
        )

    out = np.asarray(chain(jax.device_put(Ts.astype(np.float32), gpu_device)))
    assert np.abs(out - ref).max() < 2e-5
