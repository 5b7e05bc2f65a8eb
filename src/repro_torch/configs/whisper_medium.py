"""whisper-medium [audio]: enc-dec 24L+24L d=1024 16H d_ff=4096 vocab=51865,
conv frontend stubbed (precomputed frame embeddings). [arXiv:2212.04356;
unverified]

Decoder length = seq_len // 4; GELU FFN per the original.  long_500k
skipped: full attention enc-dec.

Port of ``repro.configs.whisper_medium`` (same FULL and SMOKE configs).
"""

import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import make_arch

FULL = ModelConfig(
    arch_id="whisper-medium",
    family="audio",
    num_layers=24,  # decoder layers
    encoder_layers=24,
    encoder_decoder=True,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    ffn_act="gelu",
    decoder_ratio=4,
    param_dtype=torch.bfloat16,
    compute_dtype=torch.bfloat16,
)

SMOKE = ModelConfig(
    arch_id="whisper-medium-smoke",
    family="audio",
    num_layers=2,
    encoder_layers=2,
    encoder_decoder=True,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=320,
    ffn_act="gelu",
    decoder_ratio=4,
)

ARCH = make_arch(
    "whisper-medium", "audio", FULL, SMOKE,
    skip_shapes=("long_500k",),
    notes="decode caches: decoder self-KV (seq/4) + cross-KV over encoder "
    "frames (seq); RoPE replaces learned/sinusoidal positions.",
)
