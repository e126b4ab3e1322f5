"""The benchmark of the PyTorch and CUDA port, ardae_tpu_torch: one H100,
the joint AR-DAE step of the published lines (python -m portbench.run)."""
