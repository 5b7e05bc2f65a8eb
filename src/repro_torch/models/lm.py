"""Decoder-only LM over the paged KV pool (dense GQA family), in PyTorch.

Port of ``repro.models.lm``'s paged serving path.  The reference scans a
stacked layer tree; here ``params["layers"]`` is a per-layer list walked
by a Python loop, and the layer index is folded into every GEMM's noise
stream exactly as the scan counter is there.  The KV pool is one stacked
tensor per leaf, ``(layers, num_blocks, block_size, kv, hd)``, updated in
place (the reference returns a new pool; the port saves the copy).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import ffn
from repro_torch.models.common import ModelConfig
from repro_torch.serving import kv_cache as kvc


def block_def(cfg: ModelConfig) -> Dict[str, Any]:
    """Reference: ``repro.models.lm:block_def`` (self-attention + MLP)."""
    return {
        "ln1": cm.rmsnorm_def(cfg.d_model),
        "ln2": cm.rmsnorm_def(cfg.d_model),
        "attn": attn.gqa_def(cfg),
        "ffn": ffn.mlp_def(cfg),
    }


def _check_paged_support(cfg: ModelConfig) -> None:
    if cfg.mla or cfg.cross_attn_every or cfg.num_experts:
        raise NotImplementedError(
            "the port serves the dense GQA stack only; MLA, MoE and vision "
            "cross-attention wait for their slices (ROADMAP.md Queue 1)"
        )


def lm_def(cfg: ModelConfig) -> Dict[str, Any]:
    """Parameter definitions, one block dict per layer.  Reference:
    ``repro.models.lm:lm_def`` (dense family)."""
    _check_paged_support(cfg)
    defs: Dict[str, Any] = {
        "embed": cm.embed_def(cfg.n_vocab, cfg.d_model),
        "layers": [block_def(cfg) for _ in range(cfg.num_layers)],
        "final_norm": cm.rmsnorm_def(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = cm.qdense_def(cfg, cfg.d_model, cfg.n_vocab, (None, "vocab"))
    return defs


def lm_cache_def(cfg: ModelConfig, batch: int, max_seq: int, dtype) -> Dict[str, Any]:
    """Stacked per-layer cache shapes.  Reference:
    ``repro.models.lm:lm_cache_def`` (GQA)."""
    layer = attn.gqa_cache_def(cfg, batch, max_seq, dtype)
    return {
        "layers": {
            k: ((cfg.num_layers,) + shape, (None,) + axes, dt)
            for k, (shape, axes, dt) in layer.items()
        }
    }


def _layer_pool(kv_pool: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    return {k: v[i] for k, v in kv_pool.items()}


def _paged_head(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Reference: ``repro.models.lm:_paged_head``.  The tied head is the
    digital ``x @ table.T``."""
    x = cm.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return cm.unembed(params["embed"], x, cfg)
    return cm.dense(params["lm_head"], x, cfg, site="lm_head")


def _ffn_residual(p, x, cfg, idx):
    h = cm.rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + ffn.mlp(p["ffn"], h, cfg, layer=idx)


def lm_prefill_chunk(
    params,
    tokens: torch.Tensor,  # (1, tc)
    kv_pool: Dict[str, torch.Tensor],  # leaves (layers, num_blocks, bs, kv, hd)
    block_table: torch.Tensor,  # (W,)
    t0: int,
    cfg: ModelConfig,
    *,
    t_full: int,
    block_size: int,
    with_logits: bool,
):
    """One chunked-prefill step over tokens ``[t0, t0 + tc)`` of one prompt;
    returns ``(logits or None, kv_pool)``.  Reference:
    ``repro.models.lm:lm_prefill_chunk``."""
    _check_paged_support(cfg)
    tc = tokens.shape[1]
    x = cm.embed(params["embed"], tokens, cfg)
    positions = t0 + torch.arange(tc, dtype=torch.int64, device=tokens.device)
    for idx, p in enumerate(params["layers"]):
        h = cm.rmsnorm(p["ln1"], x, cfg.norm_eps)
        a, _ = attn.gqa_prefill_chunk(
            p["attn"], h, _layer_pool(kv_pool, idx), block_table, t0, cfg,
            t_full=t_full, block_size=block_size, positions=positions, layer=idx,
        )
        x = _ffn_residual(p, x + a, cfg, idx)
    logits = _paged_head(params, x[:, -1:, :], cfg) if with_logits else None
    return logits, kv_pool


def lm_decode_paged(
    params,
    token: torch.Tensor,  # (B, 1)
    kv_pool: Dict[str, torch.Tensor],
    block_table: torch.Tensor,  # (B, W)
    pos: torch.Tensor,  # (B,)
    active: torch.Tensor,  # (B,) bool
    trash_blocks: torch.Tensor,  # (B,)
    cfg: ModelConfig,
    *,
    gather_len: int,
    block_size: int,
):
    """One decode step with per-request positions; inactive rows write to
    their trash block.  Returns ``(logits (B, 1, V), kv_pool)``.
    Reference: ``repro.models.lm:lm_decode_paged``."""
    _check_paged_support(cfg)
    blocks, offsets = kvc.token_dest(block_table, pos, active, trash_blocks, block_size)
    x = cm.embed(params["embed"], token, cfg)
    for idx, p in enumerate(params["layers"]):
        h = cm.rmsnorm(p["ln1"], x, cfg.norm_eps)
        a, _ = attn.gqa_decode_paged(
            p["attn"], h, _layer_pool(kv_pool, idx), block_table, pos, blocks,
            offsets, cfg, gather_len=gather_len, layer=idx,
        )
        x = _ffn_residual(p, x + a, cfg, idx)
    return _paged_head(params, x, cfg), kv_pool
