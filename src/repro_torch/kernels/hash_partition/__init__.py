from repro_torch.kernels.hash_partition import ops, ref  # noqa: F401
