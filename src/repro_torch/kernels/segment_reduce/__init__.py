from repro_torch.kernels.segment_reduce import ops, ref  # noqa: F401
