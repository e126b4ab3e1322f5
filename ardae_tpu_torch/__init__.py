"""PyTorch/CUDA port of ardae_tpu for one NVIDIA H100.

Mirrors ``ardae_tpu/``'s layout and module names. Plain tensor code is
PyTorch; the phase-A fused denoising-score-matching kernels are CUDA C++
written by hand for Hopper (``csrc/fused_dsm.cu`` for the res-style cdae and
``csrc/fused_dsm_grad.cu`` for the grad-style one, bound in ``ops/``). Public functions keep the JAX package's shapes and
row layouts: latents are (bsz, nz, z_dim) and images flat 784-pixel rows.
"""
