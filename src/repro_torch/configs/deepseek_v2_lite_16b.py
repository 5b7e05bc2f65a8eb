"""deepseek-v2-lite-16b [moe]: 27L d=2048 MLA (kv_lora=512) 16H, MoE 64
routed experts top-6 + 2 shared, expert d_ff=1408, vocab=102400.
[arXiv:2405.04434; hf]

Port of ``repro.configs.deepseek_v2_lite_16b`` (same FULL and SMOKE
configs).  Layer 0 uses a dense FFN (d_ff=10944) per the paper.
"""

import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import make_arch

FULL = ModelConfig(
    arch_id="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=10944,  # dense first layer
    vocab_size=102400,
    mla=True,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    num_experts=64,
    num_experts_per_tok=6,
    num_shared_experts=2,
    moe_d_ff=1408,  # per routed expert
    param_dtype=torch.bfloat16,
    compute_dtype=torch.bfloat16,
)

SMOKE = ModelConfig(
    arch_id="deepseek-v2-lite-smoke",
    family="moe",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=320,
    mla=True,
    kv_lora_rank=32,
    qk_nope_head_dim=16,
    qk_rope_head_dim=8,
    v_head_dim=16,
    num_experts=8,
    num_experts_per_tok=2,
    num_shared_experts=1,
    moe_d_ff=48,
)

ARCH = make_arch(
    "deepseek-v2-lite-16b", "moe", FULL, SMOKE,
    skip_shapes=("long_500k",),
    notes="MLA compressed KV cache (c_kv 512 + rope 64 per token); "
    "long_500k skipped: full attention.",
)
