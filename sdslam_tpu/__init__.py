"""sdslam_tpu: semi-direct SLAM in JAX (JAX/XLA, Pallas kernels on CUDA).

Precision: a GPU runs a float32 product in TF32 (~3 decimal digits) unless
a precision is asked for. Pose chains, Schur reductions, normal equations
and one-hot gather matmuls need full float32 — a 4x4 pose product would lose
orthonormality at ~1e-4 per multiply and the error would compound across
frames — so every such product states `precision=HIGHEST` (`geometry.lie.mm`
for matrix products). Exact-by-construction products (0/1 incidence
matrices in bf16, integer Hamming terms) state their own dtypes.
"""
