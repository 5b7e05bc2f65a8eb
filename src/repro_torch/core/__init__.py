"""`repro_torch.core` — port of `repro.core` (operating point, quantization,
and private copies of the JAX-free circuit/scalability models)."""
