"""Attention in PyTorch: GQA self-attention (RoPE, QKV bias) with the
full-sequence forward, the one-shot prefill/decode over a dense cache and
the paged prefill/decode over the block pool; MLA (DeepSeek-V2); and
cross-attention over a precomputed memory (llama-3.2-vision's gated
layers, the whisper decoder).

Port of ``repro.models.attention``.  The reference's
``lax.scan`` over KV blocks becomes a Python loop with the same online
softmax; masks stay ``-1e30`` (not ``-inf``), and the GQA head map is
``repeat_interleave`` (``jnp.repeat``'s element order).  ``attn_impl =
"flash"`` sends the prefill/forward attention core to the flash kernel
(:func:`_attend`); the paged and decode cores stay as the reference has
them.  A fused ``wqkv`` bank (:func:`repro_torch.photonic.fuse_qkv_params`)
runs the Q/K/V projections as one GEMM, and ``kv_cache_int8`` stores the
KV cache as int8 with one f32 scale per (token, KV head) on the one-shot
and paged paths.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.dpu import quantize_symmetric
from repro_torch.models.common import P, ModelConfig, apply_rope, dense, qdense_def, with_logical
from repro_torch.serving import kv_cache as kvc

NEG = -1e30


def gqa_def(cfg: ModelConfig) -> Dict[str, Any]:
    """Reference: ``repro.models.attention:gqa_def``."""
    d, h, kv, hd = cfg.d_model, cfg.n_q_heads, cfg.num_kv_heads, cfg.hd
    return {
        "wq": qdense_def(cfg, d, h * hd, (None, "heads"), bias=cfg.qkv_bias),
        "wk": qdense_def(cfg, d, kv * hd, (None, "kv_heads"), bias=cfg.qkv_bias),
        "wv": qdense_def(cfg, d, kv * hd, (None, "kv_heads"), bias=cfg.qkv_bias),
        "wo": qdense_def(cfg, h * hd, d, ("heads", None)),
    }


def cross_attn_def(cfg: ModelConfig) -> Dict[str, Any]:
    """``gqa_def`` plus the ``(1,)`` ``gate`` of llama-vision's gated
    cross-attention, initialized to zeros (so a gated block starts as the
    identity).  Reference: ``repro.models.attention:cross_attn_def``."""
    d = gqa_def(cfg)
    d["gate"] = P((1,), (None,), init="zeros")
    return d


def gqa_cache_def(cfg: ModelConfig, batch: int, max_seq: int, dtype) -> Dict[str, Any]:
    """Reference: ``repro.models.attention:gqa_cache_def``: float K/V, or
    int8 K/V with f32 ``k_scale`` / ``v_scale`` of shape ``(batch,
    max_seq, kv)`` under ``kv_cache_int8``."""
    kv, hd = cfg.num_kv_heads, cfg.hd
    shape = (batch, max_seq, kv, hd)
    axes = ("batch", "kv_seq", "kv_heads", None)
    if cfg.kv_cache_int8:
        sshape = (batch, max_seq, kv)
        saxes = ("batch", "kv_seq", "kv_heads")
        return {
            "k": (shape, axes, torch.int8),
            "v": (shape, axes, torch.int8),
            "k_scale": (sshape, saxes, torch.float32),
            "v_scale": (sshape, saxes, torch.float32),
        }
    return {"k": (shape, axes, dtype), "v": (shape, axes, dtype)}


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    return k if n_rep == 1 else torch.repeat_interleave(k, n_rep, dim=2)


def chunked_attention(
    q: torch.Tensor,  # (B, Tq, H, hd)
    k: torch.Tensor,  # (B, Tk, KV, hd)
    v: torch.Tensor,  # (B, Tk, KV, hd_v)
    *,
    causal: bool,
    q_offset=0,
    chunk: int = 512,
    scale: Optional[float] = None,
    acc_dtype=torch.float32,
) -> torch.Tensor:
    """Online-softmax attention over KV blocks of ``chunk`` rows.  Reference:
    ``repro.models.attention:chunked_attention``."""
    b, tq, h, hd = q.shape
    _, tk, kvh, hdv = v.shape
    n_rep = h // kvh
    scale = scale if scale is not None else hd**-0.5
    chunk = min(chunk, tk)
    kv_valid = tk
    if tk % chunk:
        pad = (-tk) % chunk
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        tk = tk + pad
    n_chunks = tk // chunk
    dev = q.device

    qf = (q.to(acc_dtype) * scale).transpose(1, 2)  # (B, H, Tq, hd)
    q_pos = q_offset + torch.arange(tq, device=dev)
    m = torch.full((b, h, tq), NEG, dtype=acc_dtype, device=dev)
    l_sum = torch.zeros((b, h, tq), dtype=acc_dtype, device=dev)
    acc = torch.zeros((b, h, tq, hdv), dtype=acc_dtype, device=dev)
    for c_idx in range(n_chunks):
        sl = slice(c_idx * chunk, (c_idx + 1) * chunk)
        kb = _repeat_kv(k[:, sl], n_rep).permute(0, 2, 3, 1)  # (B, H, hd, chunk)
        vb = _repeat_kv(v[:, sl], n_rep).permute(0, 2, 1, 3)  # (B, H, chunk, hdv)
        s = torch.matmul(qf, kb.to(acc_dtype))  # (B, H, Tq, chunk)
        kv_pos = c_idx * chunk + torch.arange(chunk, device=dev)
        valid = (kv_pos[None, :] < kv_valid).expand(tq, chunk)
        if causal:
            valid = valid & (kv_pos[None, :] <= q_pos[:, None])
        s = s.masked_fill(~valid[None, None], NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_sum = l_sum * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.matmul(p, vb.to(acc_dtype))
        m = m_new
    out = acc / torch.clamp(l_sum[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)  # (B, Tq, H, hdv)


def _split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    b, t, _ = x.shape
    return x.reshape(b, t, n, -1)


def _qkv_proj(params, x, cfg: ModelConfig, *, layer=None):
    """Q/K/V projections, head-split, RoPE not yet applied: one GEMM at
    site "attn.wqkv" when the dict holds a fused ``wqkv`` bank (its output
    columns split back here), else three.  Reference:
    ``repro.models.attention:_qkv_proj``."""
    h, kv, hd = cfg.n_q_heads, cfg.num_kv_heads, cfg.hd
    if "wqkv" in params:
        y = dense(params["wqkv"], x, cfg, site="attn.wqkv", layer=layer)
        yq, yk, yv = torch.split(y, (h * hd, kv * hd, kv * hd), dim=-1)
    else:
        yq = dense(params["wq"], x, cfg, site="attn.wq", layer=layer)
        yk = dense(params["wk"], x, cfg, site="attn.wk", layer=layer)
        yv = dense(params["wv"], x, cfg, site="attn.wv", layer=layer)
    return _split_heads(yq, h), _split_heads(yk, kv), _split_heads(yv, kv)


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, KV head) symmetric int8 quantization of K/V rows in f32:
    ``(q int8, scale f32)``, the scale taken over the head dimension in the
    reference's spelling (``quantize_symmetric``).  Reference:
    ``repro.models.attention:_quantize_kv``."""
    q, scale = quantize_symmetric(x.to(torch.float32), 8, axis=-1)
    return q, scale.squeeze(-1)


def _kv_rows(k, v, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The cache rows of computed K/V: as they are, or int8 with their
    scales under ``kv_cache_int8``.  Reference:
    ``repro.models.attention:_kv_rows`` (the caller drops the batch axis)."""
    if cfg.kv_cache_int8:
        qk, sk = _quantize_kv(k)
        qv, sv = _quantize_kv(v)
        return {"k": qk, "v": qv, "k_scale": sk, "v_scale": sv}
    return {"k": k, "v": v}


def _kv_view(g: Dict[str, torch.Tensor], cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 K/V of a cache slab, dequantizing an int8 cache as
    ``q.float() * scale[..., None]``.  Reference:
    ``repro.models.attention:_kv_view``."""
    if cfg.kv_cache_int8:
        kf = g["k"].to(torch.float32) * g["k_scale"][..., None]
        vf = g["v"].to(torch.float32) * g["v_scale"][..., None]
        return kf, vf
    return g["k"].to(torch.float32), g["v"].to(torch.float32)


def _acc_dtype(cfg: ModelConfig):
    return torch.float32 if cfg.attn_f32 else torch.bfloat16


def _attend(q, k, v, cfg: ModelConfig, *, causal: bool, q_offset: int = 0):
    """The prefill/forward attention core behind ``cfg.attn_impl``:
    "chunked" is the online-softmax loop, "flash" the flash-attention
    kernel through the ``repro_torch.photonic`` surface.  Reference:
    ``repro.models.attention:_attend``."""
    if cfg.attn_impl == "flash":
        from repro_torch.photonic.flash import flash_attention

        return flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    return chunked_attention(
        q, k, v, causal=causal, q_offset=q_offset,
        chunk=cfg.attn_chunk, acc_dtype=_acc_dtype(cfg),
    )


def gqa_attention(
    params: Dict[str, Any],
    x: torch.Tensor,  # (B, T, D)
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,  # (T,)
    causal: bool = True,
    q_offset: int = 0,
    layer: Optional[int] = None,
) -> torch.Tensor:
    """Full-sequence self-attention.  Reference:
    ``repro.models.attention:gqa_attention``."""
    q, k, v = _qkv_proj(params, x, cfg, layer=layer)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q = with_logical(q, ("batch", None, "heads", None))
    k = with_logical(k, ("batch", None, "kv_heads", None))
    v = with_logical(v, ("batch", None, "kv_heads", None))
    out = _attend(q, k, v, cfg, causal=causal, q_offset=q_offset)
    out = out.reshape(*x.shape[:2], -1)
    return dense(params["wo"], out, cfg, site="attn.wo", layer=layer)


def gqa_prefill(
    params, x: torch.Tensor, cfg: ModelConfig, *, positions: torch.Tensor, max_seq: int, layer=None
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Self-attention over the prompt; returns the output and a dense KV
    cache padded to ``max_seq`` rows (int8 with its scales under
    ``kv_cache_int8``).  Reference: ``repro.models.attention:gqa_prefill``."""
    b, t, _ = x.shape
    q, k, v = _qkv_proj(params, x, cfg, layer=layer)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = _attend(q, k, v, cfg, causal=True)
    out = dense(params["wo"], out.reshape(b, t, -1), cfg, site="attn.wo", layer=layer)
    cache = {
        name: torch.nn.functional.pad(r, (0, 0) * (r.dim() - 2) + (0, max_seq - t))
        for name, r in _kv_rows(k, v, cfg).items()
    }
    return out, cache


def gqa_decode(
    params,
    x: torch.Tensor,  # (B, 1, D)
    cache: Dict[str, torch.Tensor],  # leaves (B, max_seq, kv, hd)
    pos,  # int or 0-d tensor: the current length
    cfg: ModelConfig,
    *,
    layer: Optional[int] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode token per row against the dense cache, mask ``kv_pos <=
    pos``.  Reference: ``repro.models.attention:gqa_decode``.  The new
    K/V row (int8 with its scales under ``kv_cache_int8``) is written into
    ``cache`` in place (the reference returns an updated copy), at ``pos``
    clamped into the cache as ``dynamic_update_slice`` clamps it; the
    returned dict holds the same tensors."""
    h, kv = cfg.n_q_heads, cfg.num_kv_heads
    b = x.shape[0]
    pos = int(pos)
    q, k1, v1 = _qkv_proj(params, x, cfg, layer=layer)
    posv = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    q = apply_rope(q, posv, cfg.rope_theta)
    k1 = apply_rope(k1, posv, cfg.rope_theta)
    rows = _kv_rows(k1[:, 0], v1[:, 0], cfg)
    s_max = cache["k"].shape[1]
    at = min(max(pos, 0), s_max - 1)
    for name, row in rows.items():
        cache[name][:, at] = row.to(cache[name].dtype)
    with_logical(cache["k"], ("batch", "kv_seq", "kv_heads", None))
    with_logical(cache["v"], ("batch", "kv_seq", "kv_heads", None))
    kf, vf = _kv_view(cache, cfg)
    kf = _repeat_kv(kf, h // kv)
    vf = _repeat_kv(vf, h // kv)
    qf = q.to(torch.float32) * (cfg.hd**-0.5)
    s = torch.einsum("bqhd,bshd->bhqs", qf, kf)
    kv_pos = torch.arange(s_max, device=x.device)
    s = s.masked_fill(~(kv_pos <= pos)[None, None, None, :], NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqs,bshd->bqhd", p, vf)
    out = dense(
        params["wo"], out.reshape(b, 1, -1).to(x.dtype), cfg, site="attn.wo", layer=layer
    )
    return out, {name: cache[name] for name in rows}


def gqa_prefill_chunk(
    params,
    x: torch.Tensor,  # (1, tc, D)
    kv_pool: Dict[str, torch.Tensor],  # this layer's pool leaves (num_blocks, bs, kv, hd)
    block_table: torch.Tensor,  # (W,) int
    t0: int,
    cfg: ModelConfig,
    *,
    t_full: int,
    block_size: int,
    positions: torch.Tensor,  # (tc,)
    layer=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One chunk of a chunked prefill: this chunk's K/V scatter into the
    pool (in place), then attention over cache rows ``[0, t_full)``.
    Reference: ``repro.models.attention:gqa_prefill_chunk``: a chunk that
    covers the whole prompt attends over its own K/V, as the one-shot
    prefill does (no int8 round trip)."""
    tc = x.shape[1]
    q, k, v = _qkv_proj(params, x, cfg, layer=layer)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    blocks, offsets = kvc.chunk_dest(block_table, t0, tc, block_size)
    kvc.scatter_kv(kv_pool, blocks, offsets, _kv_rows(k[0], v[0], cfg))

    if t_full == tc:
        kf, vf = k, v
        q_offset = 0
    else:
        kf, vf = _kv_view(kvc.gather_kv(kv_pool, block_table[None], t_full), cfg)
        q_offset = t0
    out = chunked_attention(
        q, kf, vf, causal=True, q_offset=q_offset,
        chunk=cfg.attn_chunk, acc_dtype=_acc_dtype(cfg),
    )
    out = dense(params["wo"], out.reshape(1, tc, -1), cfg, site="attn.wo", layer=layer)
    return out, kv_pool


def gqa_decode_paged(
    params,
    x: torch.Tensor,  # (B, 1, D)
    kv_pool: Dict[str, torch.Tensor],
    block_table: torch.Tensor,  # (B, W)
    pos: torch.Tensor,  # (B,)
    blocks: torch.Tensor,  # (B,)
    offsets: torch.Tensor,  # (B,)
    cfg: ModelConfig,
    *,
    gather_len: int,
    layer=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode token per row against the paged pool, per-row causal mask
    ``kv_pos <= pos[b]``.  Reference:
    ``repro.models.attention:gqa_decode_paged``."""
    h, kv = cfg.n_q_heads, cfg.num_kv_heads
    b = x.shape[0]
    q, k1, v1 = _qkv_proj(params, x, cfg, layer=layer)
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k1 = apply_rope(k1, pos[:, None], cfg.rope_theta)

    kvc.scatter_kv(kv_pool, blocks, offsets, _kv_rows(k1[:, 0], v1[:, 0], cfg))
    kf, vf = _kv_view(kvc.gather_kv(kv_pool, block_table, gather_len), cfg)
    kf = _repeat_kv(kf, h // kv)
    vf = _repeat_kv(vf, h // kv)
    qf = q.to(torch.float32) * (cfg.hd**-0.5)
    s = torch.einsum("bqhd,bshd->bhqs", qf, kf)
    kv_pos = torch.arange(gather_len, device=x.device)
    mask = (kv_pos[None, :] <= pos[:, None])[:, None, None, :]
    s = s.masked_fill(~mask, NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqs,bshd->bqhd", p, vf)
    out = dense(
        params["wo"], out.reshape(b, 1, -1).to(x.dtype), cfg, site="attn.wo", layer=layer
    )
    return out, kv_pool


# ---------------------------------------------------------------------------
# Cross-attention (vision / whisper decoder): static memory, no RoPE on K/V
# ---------------------------------------------------------------------------
def cross_attention(
    params,
    x: torch.Tensor,  # (B, T, D)
    memory_kv: Tuple[torch.Tensor, torch.Tensor],  # precomputed (B, S, KV, hd) pair
    cfg: ModelConfig,
    *,
    gated: bool = False,
    layer: Optional[int] = None,
) -> torch.Tensor:
    """Q from ``x`` against the memory's K/V, non-causal, then ``attn.wo``;
    ``gated`` scales the output by ``tanh(gate)``.  The core stays the
    chunked online softmax whatever ``attn_impl`` says, as in the
    reference.  Reference: ``repro.models.attention:cross_attention``."""
    b, t, _ = x.shape
    q = _split_heads(dense(params["wq"], x, cfg, site="attn.wq", layer=layer), cfg.n_q_heads)
    k, v = memory_kv
    out = chunked_attention(q, k, v, causal=False, chunk=cfg.attn_chunk, acc_dtype=_acc_dtype(cfg))
    out = dense(params["wo"], out.reshape(b, t, -1), cfg, site="attn.wo", layer=layer)
    if gated:
        out = torch.tanh(params["gate"].to(out.dtype)) * out
    return out


def cross_kv(params, memory: torch.Tensor, cfg: ModelConfig, layer=None):
    """The memory's cross-attention K/V ``(B, S, KV, hd)`` each, through
    ``attn.wk`` / ``attn.wv`` (in the memory's dtype: an f32 memory gives
    f32 K/V).  Reference: ``repro.models.attention:cross_kv``."""
    kv = cfg.num_kv_heads
    k = _split_heads(dense(params["wk"], memory, cfg, site="attn.wk", layer=layer), kv)
    v = _split_heads(dense(params["wv"], memory, cfg, site="attn.wv", layer=layer), kv)
    return k, v


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, DeepSeek-V2)
# ---------------------------------------------------------------------------
def mla_def(cfg: ModelConfig) -> Dict[str, Any]:
    """Reference: ``repro.models.attention:mla_def``."""
    d, h = cfg.d_model, cfg.n_q_heads
    nope, rope, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    return {
        "wq": qdense_def(cfg, d, h * (nope + rope), (None, "heads")),
        "wdkv": qdense_def(cfg, d, r + rope, (None, None)),
        "wuk": qdense_def(cfg, r, h * nope, (None, "heads")),
        "wuv": qdense_def(cfg, r, h * vd, (None, "heads")),
        "wo": qdense_def(cfg, h * vd, d, ("heads", None)),
    }


def mla_cache_def(cfg: ModelConfig, batch: int, max_seq: int, dtype) -> Dict[str, Any]:
    """The compressed cache: ``c_kv (batch, max_seq, kv_lora_rank)`` and
    ``k_rope (batch, max_seq, rope)``.  Reference:
    ``repro.models.attention:mla_cache_def``."""
    axes = ("batch", "kv_seq", None)
    return {
        "c_kv": ((batch, max_seq, cfg.kv_lora_rank), axes, dtype),
        "k_rope": ((batch, max_seq, cfg.qk_rope_head_dim), axes, dtype),
    }


def _mla_up_weight(p: Dict[str, Any]) -> torch.Tensor:
    """Float view of an MLA up-projection weight for the absorbed-decode
    products, dequantizing a prepacked or int8-stored layout.  Reference:
    ``repro.models.attention:_mla_up_weight``."""
    from repro_torch.photonic.packing import PackedDense

    w = p["w"]
    if isinstance(w, PackedDense):
        return w.dequant()
    if "w_scale" in p:
        return w.to(torch.float32) * p["w_scale"].to(torch.float32)[None, :]
    return w


def _mla_qkv(params, x, cfg: ModelConfig, positions, layer=None):
    """``(q_nope, q_rope, c_kv, k_rope)``, RoPE applied; ``k_rope`` is one
    head ``(B, T, 1, rope)``.  Reference: ``repro.models.attention:_mla_qkv``."""
    h = cfg.n_q_heads
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    b, t, _ = x.shape
    q = dense(params["wq"], x, cfg, site="attn.wq", layer=layer).reshape(b, t, h, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    dkv = dense(params["wdkv"], x, cfg, site="attn.wdkv", layer=layer)  # (B, T, r + rope)
    c_kv, k_rope = dkv[..., : cfg.kv_lora_rank], dkv[..., cfg.kv_lora_rank :]
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope


def _mla_expand_kv(params, c_kv, k_rope, cfg: ModelConfig, layer=None):
    """Per-head K (nope up-projection beside the shared RoPE key) and V
    from the latent rows.  Reference: ``repro.models.attention:_mla_expand_kv``."""
    h = cfg.n_q_heads
    nope, vd = cfg.qk_nope_head_dim, cfg.v_head_dim
    b, t, _ = c_kv.shape
    k_nope = dense(params["wuk"], c_kv, cfg, site="attn.wuk", layer=layer).reshape(b, t, h, nope)
    v = dense(params["wuv"], c_kv, cfg, site="attn.wuv", layer=layer).reshape(b, t, h, vd)
    k = torch.cat([k_nope, k_rope.expand(b, t, h, k_rope.shape[-1])], dim=-1)
    return k, v


def _mla_core(params, x, cfg: ModelConfig, positions, causal: bool, layer):
    b, t, _ = x.shape
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(params, x, cfg, positions, layer)
    k, v = _mla_expand_kv(params, c_kv, k_rope, cfg, layer)
    q = torch.cat([q_nope, q_rope], dim=-1)
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    out = chunked_attention(
        q, k, v, causal=causal, scale=scale, chunk=cfg.attn_chunk, acc_dtype=_acc_dtype(cfg)
    )
    out = dense(params["wo"], out.reshape(b, t, -1), cfg, site="attn.wo", layer=layer)
    return out, c_kv, k_rope


def mla_attention(params, x, cfg: ModelConfig, *, positions, causal: bool = True, layer=None):
    """Full-sequence MLA; the core is chunked attention with Q 192 and V
    128 wide at DeepSeek-V2's widths.  Reference:
    ``repro.models.attention:mla_attention``."""
    return _mla_core(params, x, cfg, positions, causal, layer)[0]


def mla_prefill(params, x, cfg: ModelConfig, *, positions, max_seq: int, layer=None):
    """MLA over the prompt; returns the output and the compressed cache
    padded to ``max_seq`` rows.  Reference: ``repro.models.attention:mla_prefill``."""
    t = x.shape[1]
    out, c_kv, k_rope = _mla_core(params, x, cfg, positions, True, layer)
    pad = (0, 0, 0, max_seq - t)
    cache = {
        "c_kv": torch.nn.functional.pad(c_kv, pad),
        "k_rope": torch.nn.functional.pad(k_rope[:, :, 0, :], pad),
    }
    return out, cache


def _mla_cache_write(params, x, cache, pos: int, cfg: ModelConfig, layer):
    """The decode token's projections, its latent and RoPE-key rows written
    into ``cache`` in place at ``pos`` (clamped into the cache, as
    ``dynamic_update_slice`` clamps it)."""
    posv = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    q_nope, q_rope, c_kv1, k_rope1 = _mla_qkv(params, x, cfg, posv, layer)
    c, kr = cache["c_kv"], cache["k_rope"]
    at = min(max(pos, 0), c.shape[1] - 1)
    c[:, at] = c_kv1[:, 0].to(c.dtype)
    kr[:, at] = k_rope1[:, 0, 0].to(kr.dtype)
    return q_nope, q_rope, c, kr


def _decode_softmax(s: torch.Tensor, pos: int) -> torch.Tensor:
    kv_pos = torch.arange(s.shape[-1], device=s.device)
    return torch.softmax(s.masked_fill(~(kv_pos <= pos)[None, None, None, :], NEG), dim=-1)


def mla_decode_absorbed(params, x, cache, pos, cfg: ModelConfig, layer=None):
    """MLA decode with the up-projections absorbed into the query and
    output paths: attention runs against the latent cache in f32, with
    ``wuk`` / ``wuv`` read as floats (dequantized when packed or
    int8-stored), so no per-head K/V is expanded.  Reference:
    ``repro.models.attention:mla_decode_absorbed``.  The cache is updated
    in place; the returned dict holds the same tensors."""
    b = x.shape[0]
    h = cfg.n_q_heads
    nope, rope, vd, r = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
    pos = int(pos)
    q_nope, q_rope, c, kr = _mla_cache_write(params, x, cache, pos, cfg, layer)
    c = with_logical(c, ("batch", "kv_seq", None))
    kr = with_logical(kr, ("batch", "kv_seq", None))
    f32 = torch.float32
    w_uk = _mla_up_weight(params["wuk"]).to(f32).reshape(r, h, nope)
    w_uv = _mla_up_weight(params["wuv"]).to(f32).reshape(r, h, vd)
    q_abs = torch.einsum("bqhn,rhn->bqhr", q_nope.to(f32), w_uk)
    cf = c.to(f32)
    s_nope = torch.einsum("bqhr,bsr->bhqs", q_abs, cf)
    s_rope = torch.einsum("bqhe,bse->bhqs", q_rope.to(f32), kr.to(f32))
    p = _decode_softmax((s_nope + s_rope) * (nope + rope) ** -0.5, pos)
    ctx = torch.einsum("bhqs,bsr->bqhr", p, cf)
    out = torch.einsum("bqhr,rhv->bqhv", ctx, w_uv)
    out = dense(params["wo"], out.reshape(b, 1, -1).to(x.dtype), cfg, site="attn.wo", layer=layer)
    return out, {"c_kv": c, "k_rope": kr}


def mla_decode(params, x, cache, pos, cfg: ModelConfig, layer=None):
    """MLA decode against the compressed cache.  Without ``mla_absorb`` the
    up-projections re-expand every row of the padded cache (``B *
    max_seq`` rows through ``wuk`` and ``wuv``, padding included, so the
    noise streams follow the reference's tiling).  Reference:
    ``repro.models.attention:mla_decode``."""
    if cfg.mla_absorb:
        return mla_decode_absorbed(params, x, cache, pos, cfg, layer)
    b = x.shape[0]
    pos = int(pos)
    q_nope, q_rope, c, kr = _mla_cache_write(params, x, cache, pos, cfg, layer)
    c = with_logical(c, ("batch", "kv_seq", None))
    kr = with_logical(kr, ("batch", "kv_seq", None))
    k, v = _mla_expand_kv(params, c, kr[:, :, None, :], cfg, layer)
    q = torch.cat([q_nope, q_rope], dim=-1)
    qf = q.to(torch.float32) * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    p = _decode_softmax(torch.einsum("bqhd,bshd->bhqs", qf, k.to(torch.float32)), pos)
    out = torch.einsum("bhqs,bshd->bqhd", p, v.to(torch.float32))
    out = dense(params["wo"], out.reshape(b, 1, -1).to(x.dtype), cfg, site="attn.wo", layer=layer)
    return out, {"c_kv": c, "k_rope": kr}
