"""`repro_torch.runtime` — port of `repro.runtime`: the serving entry point
(``serve``) and the single-device training loop (``train_loop``)."""
