"""Port of ``cfd_with_cuda_tpu/io``."""
