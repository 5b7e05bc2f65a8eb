"""Decoder-only LM (the dense and MoE families: GQA or MLA attention, a
dense MLP or a top-k MoE), in PyTorch: the full-sequence forward, one-shot
prefill/decode over a dense cache, and the paged path (GQA stacks only).

Port of ``repro.models.lm`` (vision cross-attention waits for its slice).
The reference scans a stacked layer tree; here ``params["layers"]`` is a
per-layer list walked by a Python loop, and the layer index is folded into
every GEMM's noise stream exactly as the scan counter is there (so a block
recomputed under ``remat`` draws the same noise stream).  DeepSeek-V2's
dense first block is the unstacked ``params["first_block"]`` at layer 0,
the list following from layer 1, as the reference folds them.  Caches keep
the reference's stacked layout, one tensor per leaf with the layer axis
first: the one-shot cache (GQA ``(layers, batch, max_seq, kv, hd)``, MLA
``(layers, batch, max_seq, width)`` plus the first block's under
``first``) with a batchless ``pos``, the paged pool ``(layers,
num_blocks, block_size, kv, hd)``.  Both are updated in
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


def block_def(cfg: ModelConfig, kind: str = "self") -> Dict[str, Any]:
    """One decoder block: MLA or GQA attention, then the MoE (when the
    config has experts and ``kind`` is "self") or a dense MLP ("dense_ffn",
    DeepSeek-V2's first layer).  Reference: ``repro.models.lm:block_def``
    (self-attention kinds)."""
    d: Dict[str, Any] = {
        "ln1": cm.rmsnorm_def(cfg.d_model),
        "ln2": cm.rmsnorm_def(cfg.d_model),
        "attn": attn.mla_def(cfg) if cfg.mla else attn.gqa_def(cfg),
    }
    if kind == "dense_ffn" or cfg.num_experts == 0:
        d["ffn"] = ffn.mlp_def(cfg)
    else:
        d["ffn"] = ffn.moe_def(cfg)
    return d


def _check_family(cfg: ModelConfig) -> None:
    if cfg.cross_attn_every:
        raise NotImplementedError(
            "the port serves the dense, MLA and MoE decoders; vision "
            "cross-attention (llama-3.2-vision) waits for its slice (ROADMAP.md Queue 1)"
        )


def _check_paged_support(cfg: ModelConfig) -> None:
    """Reference: ``repro.models.lm:_check_paged_support``."""
    _check_family(cfg)
    if cfg.mla:
        raise ValueError(
            "paged serving covers the GQA self-attention stack only (no MLA "
            "latent caches); serve MLA through runtime.serve.LegacyEngine"
        )


def _has_first_block(cfg: ModelConfig) -> bool:
    return bool(cfg.mla and cfg.num_experts)


def _n_self(cfg: ModelConfig) -> int:
    """Layers in the ``layers`` list: all but DeepSeek-V2's dense first
    block.  Reference: ``repro.models.lm:_n_self`` (no cross layers)."""
    return cfg.num_layers - int(_has_first_block(cfg))


def lm_def(cfg: ModelConfig) -> Dict[str, Any]:
    """Parameter definitions, one block dict per layer, plus the unstacked
    ``first_block`` of the MLA + MoE family.  Reference:
    ``repro.models.lm:lm_def``."""
    _check_family(cfg)
    defs: Dict[str, Any] = {
        "embed": cm.embed_def(cfg.n_vocab, cfg.d_model),
        "layers": [block_def(cfg, "self") for _ in range(_n_self(cfg))],
        "final_norm": cm.rmsnorm_def(cfg.d_model),
    }
    if _has_first_block(cfg):
        defs["first_block"] = block_def(cfg, "dense_ffn")
    if not cfg.tie_embeddings:
        defs["lm_head"] = cm.qdense_def(cfg, cfg.d_model, cfg.n_vocab, (None, "vocab"))
    return defs


def lm_cache_def(cfg: ModelConfig, batch: int, max_seq: int, dtype) -> Dict[str, Any]:
    """Stacked per-layer cache shapes, the first block's cache under
    ``first`` (MLA + MoE) and the batchless ``pos``.  Reference:
    ``repro.models.lm:lm_cache_def``."""
    layer = (
        attn.mla_cache_def(cfg, batch, max_seq, dtype)
        if cfg.mla
        else attn.gqa_cache_def(cfg, batch, max_seq, dtype)
    )
    out: Dict[str, Any] = {
        "layers": {
            k: ((_n_self(cfg),) + shape, (None,) + axes, dt)
            for k, (shape, axes, dt) in layer.items()
        },
        "pos": ((), (), torch.int32),
    }
    if _has_first_block(cfg):
        out["first"] = layer
    return out


def _blocks(params, cfg: ModelConfig):
    """``(layer index, block params)`` in order: the first block at layer 0
    when there is one, then the list from ``base``, the folds of the
    reference's unscanned block and ``_scan_blocks(base=...)``."""
    base = 0
    if _has_first_block(cfg):
        yield 0, params["first_block"]
        base = 1
    for i, p in enumerate(params["layers"]):
        yield base + i, p


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


def _ffn(p, x, cfg, idx):
    """The block's FFN residual and the MoE aux loss (None without
    experts)."""
    h = cm.rmsnorm(p["ln2"], x, cfg.norm_eps)
    if "router" in p["ffn"]:
        f, aux = ffn.moe(p["ffn"], h, cfg, layer=idx)
        return x + f, aux
    return x + ffn.mlp(p["ffn"], h, cfg, layer=idx), None


def _ffn_residual(p, x, cfg, idx):
    return _ffn(p, x, cfg, idx)[0]


# ---------------------------------------------------------------------------
# Full-sequence forward
# ---------------------------------------------------------------------------
def self_block(params, x: torch.Tensor, cfg: ModelConfig, positions, layer=None):
    """One decoder layer over the whole sequence; returns ``(x, aux)``, the
    aux loss 0 without experts.  Reference: ``repro.models.lm:self_block``."""
    h = cm.rmsnorm(params["ln1"], x, cfg.norm_eps)
    if cfg.mla:
        a = attn.mla_attention(params["attn"], h, cfg, positions=positions, layer=layer)
    else:
        a = attn.gqa_attention(params["attn"], h, cfg, positions=positions, layer=layer)
    x, aux = _ffn(params, x + a, cfg, layer)
    return x, torch.zeros((), dtype=torch.float32, device=x.device) if aux is None else aux


def _remat_body(p, idx, x, positions, cfg):
    return self_block(p, x, cfg, positions, layer=idx)


def lm_logits(params, tokens: torch.Tensor, cfg: ModelConfig):
    """Logits of every position, ``(B, T, V)``, and the summed MoE aux
    loss; differentiable, each block under :func:`~repro_torch.models.
    common.apply_remat` as the reference's scanned body is.  Reference:
    ``repro.models.lm:lm_logits`` and ``_scan_blocks``: the first block's
    aux plus the list's, summed from 0 in layer order."""
    _check_family(cfg)
    t = tokens.shape[1]
    x = cm.embed(params["embed"], tokens, cfg)
    positions = torch.arange(t, device=tokens.device)
    zero = torch.zeros((), dtype=torch.float32, device=tokens.device)
    aux_first, aux = zero, zero
    base = int(_has_first_block(cfg))
    block = cm.apply_remat(_remat_body, cfg)
    for idx, p in _blocks(params, cfg):
        x, a = block(p, idx, x, positions, cfg)
        if idx < base:
            aux_first = aux_first + a
        else:
            aux = aux + a
    return _head(params, x, cfg), aux_first + aux


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
    """Reference: ``repro.models.lm:_layer_prefill``."""
    h = cm.rmsnorm(p["ln1"], x, cfg.norm_eps)
    prefill = attn.mla_prefill if cfg.mla else attn.gqa_prefill
    a, cache = prefill(p["attn"], h, cfg, positions=positions, max_seq=max_seq, layer=layer)
    return _ffn_residual(p, x + a, cfg, layer), cache


def _layer_decode(p, x, cache, pos, cfg, layer=None):
    """Reference: ``repro.models.lm:_layer_decode``."""
    h = cm.rmsnorm(p["ln1"], x, cfg.norm_eps)
    decode = attn.mla_decode if cfg.mla else attn.gqa_decode
    a, cache = decode(p["attn"], h, cache, pos, cfg, layer=layer)
    return _ffn_residual(p, x + a, cfg, layer), cache


def lm_prefill(params, tokens: torch.Tensor, cfg: ModelConfig, max_seq: int):
    """Run the prompt ``(B, T)``; returns ``(last-token logits (B, 1, V),
    caches)``: ``layers`` stacked (GQA ``k``/``v`` leaves ``(layers, B,
    max_seq, kv, hd)``, MLA ``c_kv``/``k_rope`` ``(layers, B, max_seq,
    width)``), the first block's cache under ``first`` (MLA + MoE) and
    ``pos = T``.  Reference: ``repro.models.lm:lm_prefill``."""
    _check_family(cfg)
    t = tokens.shape[1]
    x = cm.embed(params["embed"], tokens, cfg)
    positions = torch.arange(t, device=tokens.device)
    caches: Dict[str, Any] = {}
    layer_caches = []
    base = int(_has_first_block(cfg))
    for idx, p in _blocks(params, cfg):
        x, c = _layer_prefill(p, x, cfg, positions, max_seq, layer=idx)
        if idx < base:
            caches["first"] = c
        else:
            layer_caches.append(c)
    caches["layers"] = {k: torch.stack([c[k] for c in layer_caches]) for k in layer_caches[0]}
    caches["pos"] = t
    return _head(params, x[:, -1:, :], cfg), caches


def lm_decode(params, token: torch.Tensor, caches, cfg: ModelConfig):
    """One decode step for ``token`` ``(B, 1)``; returns ``(logits (B, 1,
    V), caches)`` with ``pos`` advanced.  Reference:
    ``repro.models.lm:lm_decode``.  The cache tensors are updated in
    place; the returned dict is new, holding the same tensors."""
    _check_family(cfg)
    pos = caches["pos"]
    x = cm.embed(params["embed"], token, cfg)
    layers = caches["layers"]
    base = int(_has_first_block(cfg))
    for idx, p in _blocks(params, cfg):
        cache = caches["first"] if idx < base else _layer_pool(layers, idx - base)
        x, _ = _layer_decode(p, x, cache, pos, cfg, layer=idx)
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
    ``repro.models.lm:lm_prefill_chunk`` (a GQA stack, dense or MoE)."""
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
    Reference: ``repro.models.lm:lm_decode_paged`` (a GQA stack, dense or
    MoE)."""
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
    return _head(params, x, cfg), kv_pool
