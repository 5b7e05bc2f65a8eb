"""`repro_torch.analysis` — runtime contract checks (the port's counterpart
of `repro.analysis.contracts`)."""
