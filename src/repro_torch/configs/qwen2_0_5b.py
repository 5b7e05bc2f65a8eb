"""qwen2-0.5b [dense]: 24L d=896 14H (GQA kv=2) d_ff=4864 vocab=151936,
QKV bias, tied embeddings. [arXiv:2407.10671; hf]

Port of ``repro.configs.qwen2_0_5b`` (same FULL and SMOKE configs).
"""

import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import make_arch

FULL = ModelConfig(
    arch_id="qwen2-0.5b",
    family="dense",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1e6,
    param_dtype=torch.bfloat16,
    compute_dtype=torch.bfloat16,
)

SMOKE = ModelConfig(
    arch_id="qwen2-0.5b-smoke",
    family="dense",
    num_layers=2,
    d_model=56,
    num_heads=7,
    num_kv_heads=1,
    d_ff=112,
    vocab_size=256,
    qkv_bias=True,
    tie_embeddings=True,
)

ARCH = make_arch(
    "qwen2-0.5b", "dense", FULL, SMOKE,
    notes="q-heads 14 padded to 16 for TP=16; long_500k skipped: full attention.",
)
