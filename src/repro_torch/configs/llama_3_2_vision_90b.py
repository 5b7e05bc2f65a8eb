"""llama-3.2-vision-90b [vlm]: 100L d=8192 64H (GQA kv=8) d_ff=28672
vocab=128256, a gated cross-attention image layer every 5th layer; the
patch frontend is a stub (the caller passes precomputed patch embeddings
``vision``). [hf:meta-llama/Llama-3.2-90B-Vision; unverified]

Port of ``repro.configs.llama_3_2_vision_90b`` (same FULL and SMOKE configs).
"""

import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import make_arch

FULL = ModelConfig(
    arch_id="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=5e5,
    cross_attn_every=5,
    vision_seq=1600,
    param_dtype=torch.bfloat16,
    compute_dtype=torch.bfloat16,
)

SMOKE = ModelConfig(
    arch_id="llama-3.2-vision-90b-smoke",
    family="vlm",
    num_layers=6,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=320,
    cross_attn_every=3,
    vision_seq=16,
)

ARCH = make_arch(
    "llama-3.2-vision-90b", "vlm", FULL, SMOKE,
    skip_shapes=("long_500k",),
    notes="100 layers = 80 self + 20 gated cross-attn (every 5th); "
    "long_500k skipped: full attention.",
)
