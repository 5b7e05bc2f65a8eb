"""Architecture registry (dense family).

Port of ``repro.models.registry``: each arch exposes its config, a smoke
config, ``param_defs(cfg)``, ``loss(params, batch, cfg)``,
``prefill(params, batch, cfg, max_seq)``, ``decode(params, token, cache,
cfg)`` and ``cache_def(cfg, batch, max_seq, meta, dtype)``.  Only the dense
decoder family is ported; the other families wait for their slices
(ROADMAP.md Queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

from repro_torch.models import lm
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
    return lm.lm_prefill(params, batch["tokens"], cfg, max_seq)


def _lm_decode(params, token, cache, cfg):
    return lm.lm_decode(params, token, cache, cfg)


def _lm_cache_def(cfg, batch, max_seq, meta, dtype):
    return lm.lm_cache_def(cfg, batch, max_seq, dtype)


FAMILY_FNS = {"dense": (lm.lm_def, _lm_loss, _lm_prefill, _lm_decode, _lm_cache_def)}

_REGISTRY: Dict[str, Arch] = {}


def make_arch(name: str, family: str, config: ModelConfig, smoke_config: ModelConfig,
              skip_shapes: Tuple[str, ...] = (), notes: str = "") -> Arch:
    """Reference: ``repro.models.registry:make_arch``."""
    if family not in FAMILY_FNS:
        raise NotImplementedError(f"family {family!r} is not ported yet (ROADMAP.md Queue 1)")
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
