"""`repro_torch.noise` — port of `repro.noise`: the analog channel model and
the counter-based signal-chain stages."""

from repro_torch.noise.channel import (
    ChannelModel,
    analog_pass_psums,
    build_channel_model,
    shard_local_channel,
    sliced_channel,
)
from repro_torch.noise.stages import (
    adc_quantize,
    data_tweak,
    fold_seed,
    gaussian_from_counter,
    hash_mix32,
    neighbor_sum,
    seed_from_key,
)

__all__ = [
    "ChannelModel",
    "adc_quantize",
    "analog_pass_psums",
    "build_channel_model",
    "data_tweak",
    "fold_seed",
    "gaussian_from_counter",
    "hash_mix32",
    "neighbor_sum",
    "seed_from_key",
    "shard_local_channel",
    "sliced_channel",
]
