"""The benchmark of the PyTorch/CUDA port, rrin_tpu_torch (see README.md)."""
