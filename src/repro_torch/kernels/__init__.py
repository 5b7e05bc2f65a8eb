"""`repro_torch.kernels` — hand-written Hopper kernels, each with its plain
PyTorch twin beside it."""
