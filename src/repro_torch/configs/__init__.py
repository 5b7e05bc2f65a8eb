"""`repro_torch.configs` — the ported model configs; importing this package
registers them with ``repro_torch.models.registry``: the four dense
decoders qwen2-0.5b, qwen2-1.5b, granite-3-8b and deepseek-67b."""

from repro_torch.configs import deepseek_67b, granite_3_8b, qwen2_0_5b, qwen2_1_5b  # noqa: F401
