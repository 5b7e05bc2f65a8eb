"""Decoder-only LM (dense GQA family), in PyTorch: the full-sequence
forward, one-shot prefill/decode over a dense cache, and the paged path.

Port of ``repro.models.lm``'s dense family.  The reference scans a stacked
layer tree; here ``params["layers"]`` is a per-layer list walked by a
Python loop, and the layer index is folded into every GEMM's noise stream
exactly as the scan counter is there (so a block recomputed under
``remat`` draws the same noise stream).  Caches keep the reference's stacked
layout, one tensor per leaf with the layer axis first: the one-shot cache
``(layers, batch, max_seq, kv, hd)`` plus a batchless ``pos``, the paged
pool ``(layers, num_blocks, block_size, kv, hd)``.  Both are updated in
place by decode (the reference returns new ones; the port saves the copy).
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


def _check_dense_family(cfg: ModelConfig) -> None:
    if cfg.mla or cfg.cross_attn_every or cfg.num_experts:
        raise NotImplementedError(
            "the port serves the dense GQA stack only; MLA, MoE and vision "
            "cross-attention wait for their slices (ROADMAP.md Queue 1)"
        )


def lm_def(cfg: ModelConfig) -> Dict[str, Any]:
    """Parameter definitions, one block dict per layer.  Reference:
    ``repro.models.lm:lm_def`` (dense family)."""
    _check_dense_family(cfg)
    defs: Dict[str, Any] = {
        "embed": cm.embed_def(cfg.n_vocab, cfg.d_model),
        "layers": [block_def(cfg) for _ in range(cfg.num_layers)],
        "final_norm": cm.rmsnorm_def(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = cm.qdense_def(cfg, cfg.d_model, cfg.n_vocab, (None, "vocab"))
    return defs


def lm_cache_def(cfg: ModelConfig, batch: int, max_seq: int, dtype) -> Dict[str, Any]:
    """Stacked per-layer cache shapes and the batchless ``pos``.  Reference:
    ``repro.models.lm:lm_cache_def`` (GQA)."""
    layer = attn.gqa_cache_def(cfg, batch, max_seq, dtype)
    return {
        "layers": {
            k: ((cfg.num_layers,) + shape, (None,) + axes, dt)
            for k, (shape, axes, dt) in layer.items()
        },
        "pos": ((), (), torch.int32),
    }


def _layer_pool(kv_pool: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    return {k: v[i] for k, v in kv_pool.items()}


def _head(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Final norm and logits.  Reference: ``repro.models.lm:_paged_head``
    (the same tail closes ``lm_logits``, ``lm_prefill`` and ``lm_decode``).
    The tied head is the digital ``x @ table.T``."""
    x = cm.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return cm.unembed(params["embed"], x, cfg)
    return cm.dense(params["lm_head"], x, cfg, site="lm_head")


def _ffn_residual(p, x, cfg, idx):
    h = cm.rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + ffn.mlp(p["ffn"], h, cfg, layer=idx)


# ---------------------------------------------------------------------------
# Full-sequence forward
# ---------------------------------------------------------------------------
def self_block(params, x: torch.Tensor, cfg: ModelConfig, positions, layer=None):
    """One decoder layer over the whole sequence; returns ``(x, aux)`` with
    ``aux = 0`` (no MoE).  Reference: ``repro.models.lm:self_block`` (dense
    branch)."""
    h = cm.rmsnorm(params["ln1"], x, cfg.norm_eps)
    a = attn.gqa_attention(params["attn"], h, cfg, positions=positions, layer=layer)
    x = _ffn_residual(params, x + a, cfg, layer)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def _remat_body(p, idx, x, positions, cfg):
    return self_block(p, x, cfg, positions, layer=idx)


def lm_logits(params, tokens: torch.Tensor, cfg: ModelConfig):
    """Logits of every position, ``(B, T, V)``, and the MoE aux loss (0
    here); differentiable, each block under :func:`~repro_torch.models.
    common.apply_remat` as the reference's scanned body is.  Reference:
    ``repro.models.lm:lm_logits`` (dense stack) and ``_scan_blocks``."""
    _check_dense_family(cfg)
    t = tokens.shape[1]
    x = cm.embed(params["embed"], tokens, cfg)
    positions = torch.arange(t, device=tokens.device)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    block = cm.apply_remat(_remat_body, cfg)
    for idx, p in enumerate(params["layers"]):
        x, a = block(p, idx, x, positions, cfg)
        aux = aux + a
    return _head(params, x, cfg), aux


def lm_loss(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig) -> torch.Tensor:
    """Mean next-token cross-entropy plus ``0.01 x`` the aux loss.
    Reference: ``repro.models.lm:lm_loss``."""
    logits, aux = lm_logits(params, batch["tokens"], cfg)
    ce = cm.softmax_cross_entropy(logits, batch["labels"], cfg.vocab_size)
    return ce + 0.01 * aux


# ---------------------------------------------------------------------------
# One-shot serving: prefill + decode over a dense per-layer cache
# ---------------------------------------------------------------------------
def _layer_prefill(p, x, cfg, positions, max_seq, layer=None):
    """Reference: ``repro.models.lm:_layer_prefill`` (GQA, dense FFN)."""
    h = cm.rmsnorm(p["ln1"], x, cfg.norm_eps)
    a, cache = attn.gqa_prefill(p["attn"], h, cfg, positions=positions, max_seq=max_seq, layer=layer)
    return _ffn_residual(p, x + a, cfg, layer), cache


def _layer_decode(p, x, cache, pos, cfg, layer=None):
    """Reference: ``repro.models.lm:_layer_decode`` (GQA, dense FFN)."""
    h = cm.rmsnorm(p["ln1"], x, cfg.norm_eps)
    a, cache = attn.gqa_decode(p["attn"], h, cache, pos, cfg, layer=layer)
    return _ffn_residual(p, x + a, cfg, layer), cache


def lm_prefill(params, tokens: torch.Tensor, cfg: ModelConfig, max_seq: int):
    """Run the prompt ``(B, T)``; returns ``(last-token logits (B, 1, V),
    caches)`` with ``caches = {"layers": {"k", "v"}, "pos": T}`` (leaves
    ``(layers, B, max_seq, kv, hd)``).  Reference:
    ``repro.models.lm:lm_prefill`` (dense family)."""
    _check_dense_family(cfg)
    t = tokens.shape[1]
    x = cm.embed(params["embed"], tokens, cfg)
    positions = torch.arange(t, device=tokens.device)
    layer_caches = []
    for idx, p in enumerate(params["layers"]):
        x, c = _layer_prefill(p, x, cfg, positions, max_seq, layer=idx)
        layer_caches.append(c)
    caches = {
        "layers": {k: torch.stack([c[k] for c in layer_caches]) for k in layer_caches[0]},
        "pos": t,
    }
    return _head(params, x[:, -1:, :], cfg), caches


def lm_decode(params, token: torch.Tensor, caches, cfg: ModelConfig):
    """One decode step for ``token`` ``(B, 1)``; returns ``(logits (B, 1,
    V), caches)`` with ``pos`` advanced.  Reference:
    ``repro.models.lm:lm_decode`` (dense family).  The cache tensors are
    updated in place; the returned dict is new, holding the same tensors."""
    _check_dense_family(cfg)
    pos = caches["pos"]
    x = cm.embed(params["embed"], token, cfg)
    layers = caches["layers"]
    for idx, p in enumerate(params["layers"]):
        x, _ = _layer_decode(p, x, _layer_pool(layers, idx), pos, cfg, layer=idx)
    return _head(params, x, cfg), {**caches, "pos": pos + 1}


# ---------------------------------------------------------------------------
# Paged serving: chunked prefill, paged decode
# ---------------------------------------------------------------------------
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
    _check_dense_family(cfg)
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
    logits = _head(params, x[:, -1:, :], cfg) if with_logits else None
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
    _check_dense_family(cfg)
    blocks, offsets = kvc.token_dest(block_table, pos, active, trash_blocks, block_size)
    x = cm.embed(params["embed"], token, cfg)
    for idx, p in enumerate(params["layers"]):
        h = cm.rmsnorm(p["ln1"], x, cfg.norm_eps)
        a, _ = attn.gqa_decode_paged(
            p["attn"], h, _layer_pool(kv_pool, idx), block_table, pos, blocks,
            offsets, cfg, gather_len=gather_len, layer=idx,
        )
        x = _ffn_residual(p, x + a, cfg, idx)
    return _head(params, x, cfg), kv_pool
