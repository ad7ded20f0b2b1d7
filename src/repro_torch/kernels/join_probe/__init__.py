from repro_torch.kernels.join_probe import ops, ref  # noqa: F401
