"""granite-3-8b [dense]: 40L d=4096 32H (GQA kv=8) d_ff=12800 vocab=49155,
no QKV bias, tied embeddings. [hf:ibm-granite/granite-3.0-8b-base; hf]

Port of ``repro.configs.granite_3_8b`` (same FULL and SMOKE configs).
"""

import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import make_arch

FULL = ModelConfig(
    arch_id="granite-3-8b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=12800,
    vocab_size=49155,
    tie_embeddings=True,
    param_dtype=torch.bfloat16,
    compute_dtype=torch.bfloat16,
)

SMOKE = ModelConfig(
    arch_id="granite-3-8b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=503,
    tie_embeddings=True,
)

ARCH = make_arch(
    "granite-3-8b", "dense", FULL, SMOKE,
    skip_shapes=("long_500k",),
    notes="long_500k skipped: pure full-attention arch (DESIGN.md §6).",
)
