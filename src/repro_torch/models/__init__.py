"""`repro_torch.models` — port of `repro.models` (the dense, MoE, vision cross-attention and whisper families)."""
