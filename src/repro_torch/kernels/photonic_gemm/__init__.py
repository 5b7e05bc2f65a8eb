"""`repro_torch.kernels.photonic_gemm` — the photonic GEMM kernels (CUDA C++
for sm_90a), their twin, the shared epilogue and the untiled oracle."""
