"""Architecture registry (the dense, moe, vlm, ssm, hybrid and audio
families: all of the reference's).

Port of ``repro.models.registry``: each arch exposes its config, a smoke
config, ``param_defs(cfg)``, ``loss(params, batch, cfg)``,
``prefill(params, batch, cfg, max_seq)``, ``decode(params, token, cache,
cfg)`` and ``cache_def(cfg, batch, max_seq, meta, dtype)``.  The vlm
family's batches carry ``vision`` ``(B, vision_seq, D)`` beside
``tokens``; the audio family's carry ``audio_embed`` ``(B, T_enc, D)``,
and its ``cache_def`` reads the encoder length from ``meta["enc_seq"]``.
The ssm (xLSTM) and hybrid (Zamba2) families take ``tokens`` only.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

from repro_torch.models import lm, whisper, xlstm, zamba2
from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class Arch:
    name: str
    family: str
    config: ModelConfig
    smoke_config: ModelConfig
    param_defs: Callable[[ModelConfig], Any]
    loss: Callable[..., Any]
    prefill: Callable[..., Any]
    decode: Callable[..., Any]
    cache_def: Callable[..., Any]
    skip_shapes: Tuple[str, ...] = ()
    notes: str = ""


def _lm_loss(params, batch, cfg):
    return lm.lm_loss(params, batch, cfg)


def _lm_prefill(params, batch, cfg, max_seq):
    return lm.lm_prefill(params, batch["tokens"], cfg, max_seq, vision=batch.get("vision"))


def _lm_decode(params, token, cache, cfg):
    return lm.lm_decode(params, token, cache, cfg)


def _lm_cache_def(cfg, batch, max_seq, meta, dtype):
    return lm.lm_cache_def(cfg, batch, max_seq, dtype)


def _xlstm_prefill(params, batch, cfg, max_seq):
    return xlstm.xlstm_prefill(params, batch["tokens"], cfg)


def _xlstm_cache_def(cfg, batch, max_seq, meta, dtype):
    return xlstm.xlstm_cache_def(cfg, batch, max_seq, dtype)


def _zamba_prefill(params, batch, cfg, max_seq):
    return zamba2.zamba2_prefill(params, batch["tokens"], cfg, max_seq)


def _zamba_cache_def(cfg, batch, max_seq, meta, dtype):
    return zamba2.zamba2_cache_def(cfg, batch, max_seq, dtype)


def _whisper_prefill(params, batch, cfg, max_seq):
    return whisper.whisper_prefill(params, batch, cfg, max_seq)


def _whisper_cache_def(cfg, batch, max_seq, meta, dtype):
    return whisper.whisper_cache_def(cfg, batch, max_seq, meta["enc_seq"], dtype)


FAMILY_FNS = {
    "dense": (lm.lm_def, _lm_loss, _lm_prefill, _lm_decode, _lm_cache_def),
    "vlm": (lm.lm_def, _lm_loss, _lm_prefill, _lm_decode, _lm_cache_def),
    "moe": (lm.lm_def, _lm_loss, _lm_prefill, _lm_decode, _lm_cache_def),
    "ssm": (
        xlstm.xlstm_def,
        xlstm.xlstm_loss,
        _xlstm_prefill,
        xlstm.xlstm_decode,
        _xlstm_cache_def,
    ),
    "hybrid": (
        zamba2.zamba2_def,
        zamba2.zamba2_loss,
        _zamba_prefill,
        zamba2.zamba2_decode,
        _zamba_cache_def,
    ),
    "audio": (
        whisper.whisper_def,
        whisper.whisper_loss,
        _whisper_prefill,
        whisper.whisper_decode,
        _whisper_cache_def,
    ),
}
_REGISTRY: Dict[str, Arch] = {}


def make_arch(name: str, family: str, config: ModelConfig, smoke_config: ModelConfig,
              skip_shapes: Tuple[str, ...] = (), notes: str = "") -> Arch:
    """Reference: ``repro.models.registry:make_arch``."""
    defs, loss, prefill, decode, cache_def = FAMILY_FNS[family]
    arch = Arch(name, family, config, smoke_config, defs, loss, prefill, decode, cache_def,
                skip_shapes, notes)
    _REGISTRY[name] = arch
    return arch


def get(name: str) -> Arch:
    """Reference: ``repro.models.registry:get``."""
    if not _REGISTRY:
        import repro_torch.configs  # noqa: F401  (registers the ported archs)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]
