"""The benchmark of the PyTorch and CUDA port (`chaorec_tpu_torch`); see README.md."""
