"""`repro_torch.data` — port of `repro.data` (the synthetic token stream)."""
