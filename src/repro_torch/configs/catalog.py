"""Private copy of ``repro.configs.catalog`` for the PyTorch port (``import
repro_torch`` loads nothing of ``repro``); only intra-package imports
differ; every name resolves through ``repro_torch.models.registry``.

Imports every assigned architecture config, registering them all.

Also defines the paper's own CNN workloads (photonic accelerator targets) —
see repro.core.cnn_workloads for the layer tables.
"""

from repro_torch.configs import (  # noqa: F401
    deepseek_67b,
    deepseek_v2_lite_16b,
    granite_3_8b,
    llama_3_2_vision_90b,
    phi3_5_moe_42b,
    qwen2_0_5b,
    qwen2_1_5b,
    whisper_medium,
    xlstm_350m,
    zamba2_2_7b,
)

ASSIGNED = [
    "granite-3-8b",
    "qwen2-1.5b",
    "deepseek-67b",
    "qwen2-0.5b",
    "llama-3.2-vision-90b",
    "phi3.5-moe-42b-a6.6b",
    "deepseek-v2-lite-16b",
    "xlstm-350m",
    "zamba2-2.7b",
    "whisper-medium",
]
