"""`repro_torch.kernels.flash_attention` — the flash-attention forward kernel
(CUDA C++ for sm_90a), its plain twin, the layout wrapper and the exact
softmax oracle."""
