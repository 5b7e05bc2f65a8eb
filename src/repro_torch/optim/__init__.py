"""`repro_torch.optim` — port of `repro.optim` (AdamW; gradient compression
waits for the tensor-parallel slice)."""
