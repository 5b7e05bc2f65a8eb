"""`repro_torch.configs` — the ported model configs; importing this package
registers them with ``repro_torch.models.registry``: the four dense
decoders qwen2-0.5b, qwen2-1.5b, granite-3-8b and deepseek-67b, the two
MoE decoders deepseek-v2-lite-16b (MLA) and phi3.5-moe-42b-a6.6b (GQA),
the vision decoder llama-3.2-vision-90b (gated cross-attention), the
encoder-decoder whisper-medium, the recurrent xlstm-350m (mLSTM / sLSTM)
and the hybrid zamba2-2.7b (Mamba2 with a shared attention block): every
arch the reference registers."""

from repro_torch.configs import (  # noqa: F401
    deepseek_67b,
    deepseek_v2_lite_16b,
    granite_3_8b,
    llama_3_2_vision_90b,
    phi3_5_moe_42b,
    qwen2_0_5b,
    qwen2_1_5b,
    whisper_medium,
    xlstm_350m,
    zamba2_2_7b,
)
