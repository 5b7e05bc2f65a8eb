"""qwen2-1.5b [dense]: 28L d=1536 12H (GQA kv=2) d_ff=8960 vocab=151936,
QKV bias, tied embeddings. [arXiv:2407.10671; hf]

Port of ``repro.configs.qwen2_1_5b`` (same FULL and SMOKE configs).
"""

import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import make_arch

FULL = ModelConfig(
    arch_id="qwen2-1.5b",
    family="dense",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1e6,
    param_dtype=torch.bfloat16,
    compute_dtype=torch.bfloat16,
)

SMOKE = ModelConfig(
    arch_id="qwen2-1.5b-smoke",
    family="dense",
    num_layers=2,
    d_model=48,
    num_heads=3,
    num_kv_heads=1,
    d_ff=96,
    vocab_size=256,
    qkv_bias=True,
    tie_embeddings=True,
)

ARCH = make_arch(
    "qwen2-1.5b", "dense", FULL, SMOKE,
    skip_shapes=("long_500k",),
    notes="q-heads 12 padded to 16 for TP=16 (zero-init, DESIGN.md §7); "
    "long_500k skipped: full attention.",
)
