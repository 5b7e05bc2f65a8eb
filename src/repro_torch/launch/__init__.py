"""`repro_torch.launch` — port of `repro.launch`: device meshes over
``torch.distributed`` (``mesh``) and starting the ranks that fill them."""
