"""Architecture registry (the dense, moe, vlm and audio families).

Port of ``repro.models.registry``: each arch exposes its config, a smoke
config, ``param_defs(cfg)``, ``loss(params, batch, cfg)``,
``prefill(params, batch, cfg, max_seq)``, ``decode(params, token, cache,
cfg)`` and ``cache_def(cfg, batch, max_seq, meta, dtype)``.  The vlm
family's batches carry ``vision`` ``(B, vision_seq, D)`` beside
``tokens``; the audio family's carry ``audio_embed`` ``(B, T_enc, D)``,
and its ``cache_def`` reads the encoder length from ``meta["enc_seq"]``.
The reference's ssm and hybrid families wait for their slices (ROADMAP.md
Queue 1), and asking for one of their archs raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

from repro_torch.models import lm, whisper
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


def _whisper_prefill(params, batch, cfg, max_seq):
    return whisper.whisper_prefill(params, batch, cfg, max_seq)


def _whisper_cache_def(cfg, batch, max_seq, meta, dtype):
    return whisper.whisper_cache_def(cfg, batch, max_seq, meta["enc_seq"], dtype)


FAMILY_FNS = {
    "dense": (lm.lm_def, _lm_loss, _lm_prefill, _lm_decode, _lm_cache_def),
    "vlm": (lm.lm_def, _lm_loss, _lm_prefill, _lm_decode, _lm_cache_def),
    "moe": (lm.lm_def, _lm_loss, _lm_prefill, _lm_decode, _lm_cache_def),
    "audio": (
        whisper.whisper_def,
        whisper.whisper_loss,
        _whisper_prefill,
        whisper.whisper_decode,
        _whisper_cache_def,
    ),
}
# The reference's archs whose families are not ported yet.
UNPORTED = {
    "xlstm-350m": "ssm",
    "zamba2-2.7b": "hybrid",
}


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet; the port has the {sorted(FAMILY_FNS)} families, and "
        f"{sorted(set(UNPORTED.values()))} wait for their slices (ROADMAP.md Queue 1)"
    )

_REGISTRY: Dict[str, Arch] = {}


def make_arch(name: str, family: str, config: ModelConfig, smoke_config: ModelConfig,
              skip_shapes: Tuple[str, ...] = (), notes: str = "") -> Arch:
    """Reference: ``repro.models.registry:make_arch``."""
    if family not in FAMILY_FNS:
        raise _unported(f"family {family!r}")
    defs, loss, prefill, decode, cache_def = FAMILY_FNS[family]
    arch = Arch(name, family, config, smoke_config, defs, loss, prefill, decode, cache_def,
                skip_shapes, notes)
    _REGISTRY[name] = arch
    return arch


def get(name: str) -> Arch:
    """Reference: ``repro.models.registry:get``."""
    if not _REGISTRY:
        import repro_torch.configs  # noqa: F401  (registers the ported archs)
    if name in UNPORTED:
        raise _unported(f"arch {name!r} (family {UNPORTED[name]!r})")
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]
