"""deepseek-67b [dense]: 95L d=8192 64H (GQA kv=8) d_ff=22016 vocab=102400,
llama-arch: no QKV bias, an untied ``lm_head``. [arXiv:2401.02954; hf]

Port of ``repro.configs.deepseek_67b`` (same FULL and SMOKE configs).
"""

import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import make_arch

FULL = ModelConfig(
    arch_id="deepseek-67b",
    family="dense",
    num_layers=95,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=102400,
    param_dtype=torch.bfloat16,
    compute_dtype=torch.bfloat16,
)

SMOKE = ModelConfig(
    arch_id="deepseek-67b-smoke",
    family="dense",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=160,
    vocab_size=320,
)

ARCH = make_arch(
    "deepseek-67b", "dense", FULL, SMOKE,
    skip_shapes=("long_500k",),
    notes="long_500k skipped: pure full-attention arch.",
)
