"""Decoder-only LM (the dense, MoE and vision cross-attention families:
GQA or MLA attention, a dense MLP or a top-k MoE, gated cross-attention
layers), in PyTorch: the full-sequence forward, one-shot prefill/decode over
a dense cache, and the paged path (GQA self-attention stacks only).

Port of ``repro.models.lm``.  The reference scans a stacked layer tree;
here ``params["layers"]`` is a per-layer list walked by a Python loop, and
the layer index is folded into every GEMM's noise stream exactly as the
scan counter is there (so a block recomputed under ``remat`` draws the same
noise stream).  DeepSeek-V2's dense first block is the unstacked
``params["first_block"]`` at layer 0, the list following from layer 1, as
the reference folds them.  llama-3.2-vision's stack is groups of
``cross_attn_every - 1`` self layers (folding ``base + g * per + i``) and
one gated cross layer from the ``params["cross"]`` list (folding
``num_layers + g``, a range disjoint from the self layers').  Caches keep
the reference's stacked layout, one tensor per leaf with the layer axis
first: the one-shot cache (GQA ``(layers, batch, max_seq, kv, hd)``, MLA
``(layers, batch, max_seq, width)`` plus the first block's under
``first``, the cross layers' memory K/V pair under ``cross_kv``) with a
batchless ``pos``, the paged pool ``(layers, num_blocks, block_size, kv,
hd)``.  Both are updated in place by decode (the reference returns new
ones; the port saves the copy).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import ffn
from repro_torch.models.common import P, ModelConfig
from repro_torch.serving import kv_cache as kvc


def block_def(cfg: ModelConfig, kind: str = "self") -> Dict[str, Any]:
    """One decoder block: MLA or GQA attention, then the MoE (when the
    config has experts and ``kind`` is "self") or a dense MLP ("dense_ffn",
    DeepSeek-V2's first layer); or, for ``kind`` "cross", gated
    cross-attention and a dense MLP behind the ``(1,)`` ``gate_ffn``
    (zeros at init).  Reference: ``repro.models.lm:block_def``."""
    d: Dict[str, Any] = {
        "ln1": cm.rmsnorm_def(cfg.d_model),
        "ln2": cm.rmsnorm_def(cfg.d_model),
    }
    if kind == "cross":
        d["attn"] = attn.cross_attn_def(cfg)
        d["gate_ffn"] = P((1,), (None,), init="zeros")
    else:
        d["attn"] = attn.mla_def(cfg) if cfg.mla else attn.gqa_def(cfg)
    if kind in ("dense_ffn", "cross") or cfg.num_experts == 0:
        d["ffn"] = ffn.mlp_def(cfg)
    else:
        d["ffn"] = ffn.moe_def(cfg)
    return d


def _check_paged_support(cfg: ModelConfig) -> None:
    """Reference: ``repro.models.lm:_check_paged_support`` (its message,
    with the engine named)."""
    if cfg.mla or cfg.cross_attn_every:
        raise ValueError(
            "paged serving covers the GQA self-attention stack only "
            "(no MLA latent caches / vision cross-attention); serve these "
            "families through the legacy fixed-slot engine (runtime.serve.LegacyEngine)"
        )


def _has_first_block(cfg: ModelConfig) -> bool:
    return bool(cfg.mla and cfg.num_experts)


def _n_cross(cfg: ModelConfig) -> int:
    """Gated cross-attention layers.  Reference: ``repro.models.lm:_n_cross``."""
    return cfg.num_layers // cfg.cross_attn_every if cfg.cross_attn_every else 0


def _n_self(cfg: ModelConfig) -> int:
    """Layers in the ``layers`` list: all but the cross layers and
    DeepSeek-V2's dense first block.  Reference: ``repro.models.lm:_n_self``."""
    return cfg.num_layers - _n_cross(cfg) - int(_has_first_block(cfg))


def lm_def(cfg: ModelConfig) -> Dict[str, Any]:
    """Parameter definitions, one block dict per layer, plus the unstacked
    ``first_block`` of the MLA + MoE family and the ``cross`` list of the
    vision family.  Reference: ``repro.models.lm:lm_def``."""
    defs: Dict[str, Any] = {
        "embed": cm.embed_def(cfg.n_vocab, cfg.d_model),
        "layers": [block_def(cfg, "self") for _ in range(_n_self(cfg))],
        "final_norm": cm.rmsnorm_def(cfg.d_model),
    }
    if _has_first_block(cfg):
        defs["first_block"] = block_def(cfg, "dense_ffn")
    if cfg.cross_attn_every:
        defs["cross"] = [block_def(cfg, "cross") for _ in range(_n_cross(cfg))]
    if not cfg.tie_embeddings:
        defs["lm_head"] = cm.qdense_def(cfg, cfg.d_model, cfg.n_vocab, (None, "vocab"))
    return defs


def lm_cache_def(cfg: ModelConfig, batch: int, max_seq: int, dtype) -> Dict[str, Any]:
    """Stacked per-layer cache shapes, the first block's cache under
    ``first`` (MLA + MoE), the cross layers' memory K/V pair under
    ``cross_kv`` and the batchless ``pos``.  Reference:
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
    if cfg.cross_attn_every:
        kv_shape = (_n_cross(cfg), batch, cfg.vision_seq, cfg.num_kv_heads, cfg.hd)
        axes = (None, "batch", None, "kv_heads", None)
        out["cross_kv"] = ((kv_shape, axes, dtype), (kv_shape, axes, dtype))
    return out


def _blocks(params, cfg: ModelConfig):
    """``(kind, layer index, block params)`` in order, the index being the
    block's noise fold: the first block at layer 0 when there is one, then
    the ``layers`` list from ``base`` (``_scan_blocks(base=...)``); in the
    vision family, each group's self layers at ``base + g * per + i`` and
    then its cross layer (kind "cross") at ``num_layers + g``."""
    base = 0
    if _has_first_block(cfg):
        yield "self", 0, params["first_block"]
        base = 1
    per = cfg.cross_attn_every - 1
    for i, p in enumerate(params["layers"]):
        yield "self", base + i, p
        if cfg.cross_attn_every and (i + 1) % per == 0:
            g = i // per
            yield "cross", cfg.num_layers + g, params["cross"][g]


def _vision(vision, cfg: ModelConfig):
    if cfg.cross_attn_every and vision is None:
        raise ValueError(
            f"{cfg.arch_id} has cross-attention layers: pass vision= (B, vision_seq, d_model)"
        )
    return vision


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
    x = cm.with_logical(x + a, ("batch", "seq_sp", None))
    x, aux = _ffn(params, x, cfg, layer)
    x = cm.with_logical(x, ("batch", "seq_sp", None))
    return x, torch.zeros((), dtype=torch.float32, device=x.device) if aux is None else aux


def cross_block(params, x: torch.Tensor, memory_kv, cfg: ModelConfig, layer=None) -> torch.Tensor:
    """One gated cross-attention layer: ``x + cross_attention(gated)``, then
    ``x + tanh(gate_ffn) * mlp``.  Reference: ``repro.models.lm:cross_block``."""
    h = cm.rmsnorm(params["ln1"], x, cfg.norm_eps)
    x = x + attn.cross_attention(params["attn"], h, memory_kv, cfg, gated=True, layer=layer)
    h = cm.rmsnorm(params["ln2"], x, cfg.norm_eps)
    x = x + torch.tanh(params["gate_ffn"].to(x.dtype)) * ffn.mlp(params["ffn"], h, cfg, layer=layer)
    return cm.with_logical(x, ("batch", "seq_sp", None))


def _remat_body(p, idx, x, positions, cfg):
    return self_block(p, x, cfg, positions, layer=idx)


def _remat_cross(p, idx, x, kv, cfg):
    return cross_block(p, x, kv, cfg, layer=idx)


def lm_logits(params, tokens: torch.Tensor, cfg: ModelConfig, vision: Optional[torch.Tensor] = None):
    """Logits of every position, ``(B, T, V)``, and the summed MoE aux
    loss; differentiable, each block under :func:`~repro_torch.models.
    common.apply_remat` as the reference's scanned body is (a cross layer's
    ``cross_kv`` of ``vision`` ``(B, vision_seq, D)`` outside it, as there).
    Reference: ``repro.models.lm:lm_logits`` and ``_scan_blocks``: the
    first block's aux plus the list's, summed from 0 in layer order."""
    vision = _vision(vision, cfg)
    t = tokens.shape[1]
    x = cm.embed(params["embed"], tokens, cfg)
    x = cm.with_logical(x, ("batch", "seq_sp", None))
    positions = torch.arange(t, device=tokens.device)
    zero = torch.zeros((), dtype=torch.float32, device=tokens.device)
    aux_first, aux = zero, zero
    base = int(_has_first_block(cfg))
    block = cm.apply_remat(_remat_body, cfg)
    cross = cm.apply_remat(_remat_cross, cfg)
    for kind, idx, p in _blocks(params, cfg):
        if kind == "cross":
            kv = attn.cross_kv(p["attn"], vision, cfg, layer=idx)
            x = cross(p, idx, x, kv, cfg)
            continue
        x, a = block(p, idx, x, positions, cfg)
        if idx < base:
            aux_first = aux_first + a
        else:
            aux = aux + a
    return _head(params, x, cfg), aux_first + aux


def lm_loss(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig) -> torch.Tensor:
    """Mean next-token cross-entropy plus ``0.01 x`` the aux loss, the
    batch's ``vision`` feeding the cross layers.  Reference:
    ``repro.models.lm:lm_loss``."""
    logits, aux = lm_logits(params, batch["tokens"], cfg, vision=batch.get("vision"))
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
    return cm.with_logical(_ffn_residual(p, x + a, cfg, layer), ("batch", "seq_sp", None)), cache


def _layer_decode(p, x, cache, pos, cfg, layer=None):
    """Reference: ``repro.models.lm:_layer_decode``."""
    h = cm.rmsnorm(p["ln1"], x, cfg.norm_eps)
    decode = attn.mla_decode if cfg.mla else attn.gqa_decode
    a, cache = decode(p["attn"], h, cache, pos, cfg, layer=layer)
    return _ffn_residual(p, x + a, cfg, layer), cache


def lm_prefill(
    params, tokens: torch.Tensor, cfg: ModelConfig, max_seq: int, vision: Optional[torch.Tensor] = None
):
    """Run the prompt ``(B, T)``; returns ``(last-token logits (B, 1, V),
    caches)``: ``layers`` stacked (GQA ``k``/``v`` leaves ``(layers, B,
    max_seq, kv, hd)``, MLA ``c_kv``/``k_rope`` ``(layers, B, max_seq,
    width)``), the first block's cache under ``first`` (MLA + MoE), the
    cross layers' ``cross_kv`` of ``vision`` as a stacked ``(k, v)`` pair
    ``(cross layers, B, vision_seq, kv, hd)`` each, and ``pos = T``.
    Reference: ``repro.models.lm:lm_prefill``."""
    vision = _vision(vision, cfg)
    t = tokens.shape[1]
    x = cm.embed(params["embed"], tokens, cfg)
    positions = torch.arange(t, device=tokens.device)
    caches: Dict[str, Any] = {}
    layer_caches, cross_kvs = [], []
    base = int(_has_first_block(cfg))
    for kind, idx, p in _blocks(params, cfg):
        if kind == "cross":
            kv = attn.cross_kv(p["attn"], vision, cfg, layer=idx)
            x = cross_block(p, x, kv, cfg, layer=idx)
            cross_kvs.append(kv)
            continue
        x, c = _layer_prefill(p, x, cfg, positions, max_seq, layer=idx)
        if idx < base:
            caches["first"] = c
        else:
            layer_caches.append(c)
    empty = lm_cache_def(cfg, tokens.shape[0], max_seq, x.dtype)  # the reference's zero-length scans
    if layer_caches:
        caches["layers"] = {k: torch.stack([c[k] for c in layer_caches]) for k in layer_caches[0]}
    else:
        caches["layers"] = cm.zeros_of(empty["layers"], x.device)
    if cross_kvs:
        caches["cross_kv"] = tuple(torch.stack(side) for side in zip(*cross_kvs))
    elif cfg.cross_attn_every:
        caches["cross_kv"] = tuple(torch.zeros(s, dtype=dt, device=x.device) for s, _, dt in empty["cross_kv"])
    caches["pos"] = t
    return _head(params, x[:, -1:, :], cfg), caches


def lm_decode(params, token: torch.Tensor, caches, cfg: ModelConfig):
    """One decode step for ``token`` ``(B, 1)``; returns ``(logits (B, 1,
    V), caches)`` with ``pos`` advanced; the cross layers read their
    ``cross_kv`` and never recompute it.  Reference:
    ``repro.models.lm:lm_decode``.  The cache tensors are updated in
    place; the returned dict is new, holding the same tensors."""
    pos = caches["pos"]
    x = cm.embed(params["embed"], token, cfg)
    layers = caches["layers"]
    base = int(_has_first_block(cfg))
    for kind, idx, p in _blocks(params, cfg):
        if kind == "cross":
            g = idx - cfg.num_layers
            kv = (caches["cross_kv"][0][g], caches["cross_kv"][1][g])
            x = cross_block(p, x, kv, cfg, layer=idx)
            continue
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
        x = cm.with_logical(_ffn_residual(p, x + a, cfg, idx), ("batch", "seq_sp", None))
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
