"""zamba2-2.7b [hybrid]: 54L d=2560 32H (kv=32) d_ff=10240 vocab=32000,
ssm_state=64 — Mamba2 backbone + weight-shared attention block every 6th
layer. [arXiv:2411.15242; hf]

Mamba2 state is O(1); the shared attention block keeps one KV cache per
invocation.

Port of ``repro.configs.zamba2_2_7b`` (same FULL and SMOKE configs).
"""

import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import make_arch

FULL = ModelConfig(
    arch_id="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    ssm_state_size=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    attn_every=6,
    param_dtype=torch.bfloat16,
    compute_dtype=torch.bfloat16,
)

SMOKE = ModelConfig(
    arch_id="zamba2-2.7b-smoke",
    family="hybrid",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    ssm_state_size=8,
    ssm_expand=2,
    ssm_head_dim=16,
    ssm_chunk=16,
    attn_every=2,
)

ARCH = make_arch(
    "zamba2-2.7b", "hybrid", FULL, SMOKE,
    notes="shared attn block: one weight set, 9 invocations, per-invocation "
    "KV caches; LoRA adapters + embedding-concat omitted (DESIGN.md §7).",
)
