"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (:mod:`repro_torch.kernels.ref`)."""
