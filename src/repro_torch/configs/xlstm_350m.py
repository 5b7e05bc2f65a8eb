"""xlstm-350m [ssm]: 24L d=1024 4H vocab=50304 — sLSTM + mLSTM blocks,
7:1 ratio (sLSTM every 8th layer). [arXiv:2405.04517; unverified]

Decode state is O(1) (matrix memory), no KV cache.  Projection factor 2
per the official mLSTM block (the parameter count lands above the "350m"
family label; DESIGN.md §7).

Port of ``repro.configs.xlstm_350m`` (same FULL and SMOKE configs).
"""

import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import make_arch

FULL = ModelConfig(
    arch_id="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    slstm_every=8,
    ssm_expand=2,
    ssm_chunk=256,
    param_dtype=torch.bfloat16,
    compute_dtype=torch.bfloat16,
)

SMOKE = ModelConfig(
    arch_id="xlstm-350m-smoke",
    family="ssm",
    num_layers=4,
    d_model=64,
    num_heads=2,
    num_kv_heads=2,
    d_ff=0,
    vocab_size=256,
    slstm_every=2,
    ssm_expand=2,
    ssm_chunk=16,
)

ARCH = make_arch(
    "xlstm-350m", "ssm", FULL, SMOKE,
    notes="photonic GEMM applies to projections only; the sLSTM/mLSTM "
    "recurrences are elementwise/outer-product updates (DESIGN.md §6).",
)
