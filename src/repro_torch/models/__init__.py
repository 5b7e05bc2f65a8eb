"""`repro_torch.models` — port of `repro.models` (the dense GQA decoder)."""
