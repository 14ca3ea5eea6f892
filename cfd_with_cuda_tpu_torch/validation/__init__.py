"""Port of ``cfd_with_cuda_tpu/validation``: external ground-truth
validation data, profile extraction and the cavity validation driver."""
