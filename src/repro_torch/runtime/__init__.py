"""`repro_torch.runtime` — port of `repro.runtime`: the serving entry point
(``serve``)."""
