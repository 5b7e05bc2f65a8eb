"""`repro_torch.core` — port of `repro.core` (operating point, quantization,
and private copies of the JAX-free circuit, scalability and system models:
the perf model, the CNN workloads, the organization views and the Fig. 7
simulator)."""
