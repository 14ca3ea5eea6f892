"""cfd_with_cuda_tpu_torch.parallel: the sharded kernel path over torch.distributed."""
