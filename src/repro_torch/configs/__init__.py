"""`repro_torch.configs` — the ported model configs; importing this package
registers them with ``repro_torch.models.registry``."""

from repro_torch.configs import qwen2_0_5b  # noqa: F401
