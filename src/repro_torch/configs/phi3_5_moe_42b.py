"""phi3.5-moe-42b-a6.6b [moe]: 32L d=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, MoE 16 experts top-2. [hf:microsoft/Phi-3.5-MoE-instruct; hf]

Port of ``repro.configs.phi3_5_moe_42b`` (same FULL and SMOKE configs).
"""

import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import make_arch

FULL = ModelConfig(
    arch_id="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    num_experts=16,
    num_experts_per_tok=2,
    param_dtype=torch.bfloat16,
    compute_dtype=torch.bfloat16,
)

SMOKE = ModelConfig(
    arch_id="phi3.5-moe-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=96,
    vocab_size=320,
    num_experts=4,
    num_experts_per_tok=2,
)

ARCH = make_arch(
    "phi3.5-moe-42b-a6.6b", "moe", FULL, SMOKE,
    skip_shapes=("long_500k",),
    notes="16 experts / TP=16 -> 1 expert per model shard (EP); "
    "long_500k skipped: full attention.",
)
