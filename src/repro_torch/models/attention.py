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

Under a placement of the KV heads over ``model``
(:func:`repro_torch.runtime.sharding.placement`: prefill and decode, and
for the dense family training) the GQA functions compute only this rank's
KV heads and the q heads that read them: ``attn.wq`` / ``wk`` / ``wv``
(or a fused ``wqkv``) are column-parallel over the heads (``dense(columns=
...)``, on the weights' blocks where the parameters are placed, else on the
rank's columns of whole weights), so no computed column is thrown away.
The dense caches hold those heads, and ``attn.wo`` takes the local heads as
its K block (``dense(k_local="heads")``).  MLA places its heads only with
its parameters (the MoE decoders' placement): ``wq`` / ``wuk`` / ``wuv``
are then column-parallel over the heads and ``wo`` row-parallel, while
``wdkv`` stays whole, so every rank of ``model`` writes the same latent
cache, placed by rows alone.

Under a placement of ``"kv_seq"`` over "data" (a decode step whose one
row cannot take "data": ``long_500k``) every dense cache leaf is this
rank's block of ``max_seq`` positions, as the reference's ``(batch,
kv_seq, ...)`` cache holds it: a prefill keeps its block of the padded
cache, a decode step's new row is written by the rank that owns ``pos``
(clamped as ``dynamic_update_slice`` clamps it), and the decode softmax
is the one the reference's GSPMD partitions (:func:`_decode_attend`): each
rank scores its positions under the ``kv_pos <= pos`` mask at ``-1e30``,
the row max meets in a ``MAX`` all-reduce (exact, so ``exp(s - m)`` is
elementwise the replicated program's), the exp-sums and ``P @ V``
partials in one SUM all-reduce, and the output is normalized once.  The
sums run in another order than the replicated softmax's, so the output
is within rounding of it, not bitwise.  An expanded MLA decode routes
this rank's latent rows through ``wuk`` / ``wuv`` (``sharding.rows_over``:
their activation scale a ``MAX`` over the blocks) in the form of the
replicated program (:func:`mla_decode`); whisper's cross cache is a block
of the encoder frames, merged the same way.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.dpu import quantize_symmetric
from repro_torch.models.common import P, ModelConfig, apply_rope, dense, qdense_def, with_logical
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.sharding import block, copy_to_model
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
    kv_blocks: bool = False,
) -> torch.Tensor:
    """Online-softmax attention over KV blocks of ``chunk`` rows.  Reference:
    ``repro.models.attention:chunked_attention``.  ``kv_blocks``: ``k`` /
    ``v`` are this rank's block of the placed ``"kv_seq"`` (non-causal: a
    cross cache), the ranks' running max, exp-sums and accumulators merged
    before the one normalization (:func:`_merge`)."""
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
    if kv_blocks and block("kv_seq") is not None:
        corr = torch.exp(m - shd.kv_merge(m.clone(), "max"))
        acc, l_sum = _merge(acc * corr[..., None], l_sum * corr)
    out = acc / torch.clamp(l_sum[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)  # (B, Tq, H, hdv)


def _merge(acc: torch.Tensor, l_sum: torch.Tensor):
    """``(acc, l_sum)`` summed over the placed ``"kv_seq"`` in one SUM
    all-reduce, side by side."""
    both = shd.kv_merge(torch.cat([acc.reshape(-1), l_sum.reshape(-1)]), "sum")
    return both[: acc.numel()].reshape(acc.shape), both[acc.numel():].reshape(l_sum.shape)


def _decode_attend(s: torch.Tensor, pos: int, spec: str, values: torch.Tensor) -> torch.Tensor:
    """``einsum(spec, softmax(s), values)`` for decode scores ``s`` ``(B, H,
    q, S)`` over the cache positions, masked to ``kv_pos <= pos`` at
    ``-1e30``; ``spec`` gives ``(B, q, H, .)``.  Where ``"kv_seq"`` is
    placed, ``S`` is this rank's block of positions and the softmax is
    merged across the ranks (module docstring)."""
    n = s.shape[-1]
    kv_pos = shd.kv_origin(n) + torch.arange(n, device=s.device)
    s = s.masked_fill(~(kv_pos <= pos)[None, None, None, :], NEG)
    if block("kv_seq") is None:
        return torch.einsum(spec, torch.softmax(s, dim=-1), values)
    m = shd.kv_merge(s.amax(dim=-1), "max")
    e = torch.exp(s - m[..., None])
    acc, l_sum = _merge(torch.einsum(spec, e, values), e.sum(dim=-1))
    return acc / l_sum.transpose(1, 2)[..., None]


def cache_block(t: torch.Tensor) -> torch.Tensor:
    """This rank's block of a cache leaf's positions (dimension 1) where
    ``"kv_seq"`` is placed, sized by the leaf (whisper's cross cache holds
    the encoder's frames); ``t`` as it is elsewhere."""
    b = block("kv_seq")
    if b is None:
        return t
    return dataclasses.replace(b, size=t.shape[1]).take(t, 1).contiguous()


def _write_row(cache: Dict[str, torch.Tensor], rows: Dict[str, torch.Tensor], pos: int) -> None:
    """Decode's new rows written into the cache in place at ``pos``
    clamped into the global cache, as ``dynamic_update_slice`` clamps it,
    by the rank that holds that position (every rank where ``"kv_seq"`` is
    not placed)."""
    n = next(iter(cache.values())).shape[1]
    b = block("kv_seq")
    at = min(max(pos, 0), n * (1 if b is None else b.count) - 1) - shd.kv_origin(n)
    if 0 <= at < n:
        for name, row in rows.items():
            cache[name][:, at] = row.to(cache[name].dtype)


def _split_heads(x: torch.Tensor, hd: int) -> torch.Tensor:
    """``(B, T, n * hd)`` as ``(B, T, n, hd)``: ``n`` the heads the columns
    hold (this rank's under a placement of the heads)."""
    b, t, _ = x.shape
    return x.reshape(b, t, -1, hd)


def _q_columns(cfg: ModelConfig):
    return (("heads", cfg.n_q_heads * cfg.hd),)


def _kv_columns(cfg: ModelConfig):
    return (("kv_heads", cfg.num_kv_heads * cfg.hd),)


def columns_placed(params, cfg: ModelConfig) -> bool:
    """Whether every GEMM that reads a GQA block's input is column-parallel
    on this rank's columns of placed weights (``wq`` / ``wk`` / ``wv``, or
    the fused ``wqkv``; heads and KV heads are placed together): the
    Megatron entry of ``sharding.seq_block`` applies."""
    if "wqkv" in params:
        return shd.placed_columns(params["wqkv"]["w"], _q_columns(cfg) + _kv_columns(cfg) * 2)
    return shd.placed_columns(params["wq"]["w"], _q_columns(cfg))


def _qkv_proj(params, x, cfg: ModelConfig, *, layer=None):
    """Q/K/V projections, head-split, RoPE not yet applied: one GEMM at
    site "attn.wqkv" when the dict holds a fused ``wqkv`` bank (its output
    columns split back here), else three; each column-parallel over the
    heads where they are placed, so the heads are this rank's (q head ``h``
    reads KV head ``h // n_rep``, and the placement cuts both into the same
    number of blocks).  Reference: ``repro.models.attention:_qkv_proj``."""
    h, kv, hd = cfg.n_q_heads, cfg.num_kv_heads, cfg.hd
    if "wqkv" in params:
        y = dense(params["wqkv"], x, cfg, site="attn.wqkv", layer=layer,
                  columns=_q_columns(cfg) + _kv_columns(cfg) * 2)
        blocks = (h + 2 * kv) * hd // y.shape[-1]  # 1, or this rank's share of the columns
        yq, yk, yv = torch.split(y, (h * hd // blocks, kv * hd // blocks, kv * hd // blocks), dim=-1)
    else:
        yq = dense(params["wq"], x, cfg, site="attn.wq", layer=layer, columns=_q_columns(cfg))
        yk = dense(params["wk"], x, cfg, site="attn.wk", layer=layer, columns=_kv_columns(cfg))
        yv = dense(params["wv"], x, cfg, site="attn.wv", layer=layer, columns=_kv_columns(cfg))
    return _split_heads(yq, hd), _split_heads(yk, hd), _split_heads(yv, hd)


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
    return dense(params["wo"], out, cfg, site="attn.wo", layer=layer, k_local="heads")


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
    out = dense(params["wo"], out.reshape(b, t, -1), cfg, site="attn.wo", layer=layer, k_local="heads")
    cache = {
        name: cache_block(torch.nn.functional.pad(r, (0, 0) * (r.dim() - 2) + (0, max_seq - t)))
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
    returned dict holds the same tensors.  Where ``"kv_seq"`` is placed
    the cache is this rank's block of positions (module docstring)."""
    h, kv = cfg.n_q_heads, cfg.num_kv_heads
    b = x.shape[0]
    pos = int(pos)
    q, k1, v1 = _qkv_proj(params, x, cfg, layer=layer)
    posv = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    q = apply_rope(q, posv, cfg.rope_theta)
    k1 = apply_rope(k1, posv, cfg.rope_theta)
    rows = _kv_rows(k1[:, 0], v1[:, 0], cfg)
    _write_row(cache, rows, pos)
    with_logical(cache["k"], ("batch", "kv_seq", "kv_heads", None))
    with_logical(cache["v"], ("batch", "kv_seq", "kv_heads", None))
    kf, vf = _kv_view(cache, cfg)
    kf = _repeat_kv(kf, h // kv)
    vf = _repeat_kv(vf, h // kv)
    qf = q.to(torch.float32) * (cfg.hd**-0.5)
    s = torch.einsum("bqhd,bshd->bhqs", qf, kf)
    out = _decode_attend(s, pos, "bhqs,bshd->bqhd", vf)
    out = dense(
        params["wo"], out.reshape(b, 1, -1).to(x.dtype), cfg, site="attn.wo", layer=layer, k_local="heads"
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
    kv_blocks: bool = False,
) -> torch.Tensor:
    """Q from ``x`` against the memory's K/V, non-causal, then ``attn.wo``;
    ``gated`` scales the output by ``tanh(gate)``.  The core stays the
    chunked online softmax whatever ``attn_impl`` says, as in the
    reference.  ``kv_blocks``: the memory is a cache leaf, this rank's
    block of its frames where ``"kv_seq"`` is placed (whisper's decode).
    Reference: ``repro.models.attention:cross_attention``."""
    b, t, _ = x.shape
    q = _split_heads(dense(params["wq"], x, cfg, site="attn.wq", layer=layer, columns=_q_columns(cfg)), cfg.hd)
    k, v = memory_kv
    out = chunked_attention(q, k, v, causal=False, chunk=cfg.attn_chunk, acc_dtype=_acc_dtype(cfg),
                            kv_blocks=kv_blocks)
    out = dense(params["wo"], out.reshape(b, t, -1), cfg, site="attn.wo", layer=layer, k_local="heads")
    if gated:
        out = torch.tanh(params["gate"].to(out.dtype)) * out
    return out


def cross_kv(params, memory: torch.Tensor, cfg: ModelConfig, layer=None):
    """The memory's cross-attention K/V ``(B, S, KV, hd)`` each, through
    ``attn.wk`` / ``attn.wv`` (in the memory's dtype: an f32 memory gives
    f32 K/V), this rank's KV heads where they are placed.  Reference:
    ``repro.models.attention:cross_kv``."""
    k = _split_heads(dense(params["wk"], memory, cfg, site="attn.wk", layer=layer, columns=_kv_columns(cfg)), cfg.hd)
    v = _split_heads(dense(params["wv"], memory, cfg, site="attn.wv", layer=layer, columns=_kv_columns(cfg)), cfg.hd)
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
    products, dequantizing a prepacked or int8-stored layout (an int8
    block with its ``w_scale`` block alike).  Reference:
    ``repro.models.attention:_mla_up_weight``."""
    from repro_torch.photonic.packing import PackedDense

    w = p["w"]
    if isinstance(w, PackedDense):
        return w.dequant()
    if "w_scale" in p:
        return w.to(torch.float32) * p["w_scale"].to(torch.float32)[None, :]
    return w


def _mla_columns(cfg: ModelConfig, per_head: int):
    return (("heads", cfg.n_q_heads * per_head),)


def _mla_qkv(params, x, cfg: ModelConfig, positions, layer=None):
    """``(q_nope, q_rope, c_kv, k_rope)``, RoPE applied; ``k_rope`` is one
    head ``(B, T, 1, rope)``.  Reference: ``repro.models.attention:_mla_qkv``."""
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    b, t, _ = x.shape
    q = dense(params["wq"], x, cfg, site="attn.wq", layer=layer, columns=_mla_columns(cfg, nope + rope))
    q = q.reshape(b, t, -1, nope + rope)  # this rank's heads where they are placed
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    dkv = dense(params["wdkv"], x, cfg, site="attn.wdkv", layer=layer)  # (B, T, r + rope)
    c_kv, k_rope = dkv[..., : cfg.kv_lora_rank], dkv[..., cfg.kv_lora_rank :]
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope


def _mla_expand_kv(params, c_kv, k_rope, cfg: ModelConfig, layer=None):
    """Per-head K (nope up-projection beside the shared RoPE key) and V
    from the latent rows, this rank's heads where they are placed (``wuk``
    / ``wuv`` column-parallel at the block's column origin).  Reference:
    ``repro.models.attention:_mla_expand_kv``."""
    nope, vd = cfg.qk_nope_head_dim, cfg.v_head_dim
    b, t, _ = c_kv.shape
    k_nope = dense(params["wuk"], c_kv, cfg, site="attn.wuk", layer=layer, columns=_mla_columns(cfg, nope))
    k_nope = k_nope.reshape(b, t, -1, nope)
    v = dense(params["wuv"], c_kv, cfg, site="attn.wuv", layer=layer, columns=_mla_columns(cfg, vd))
    v = v.reshape(b, t, -1, vd)
    h = k_nope.shape[2]
    heads = block("heads")
    if heads is not None:  # the shared RoPE key meets this rank's heads only: its gradient sums over theirs
        k_rope = copy_to_model(k_rope, heads.part)
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
    out = dense(params["wo"], out.reshape(b, t, -1), cfg, site="attn.wo", layer=layer, k_local="heads")
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
        "c_kv": cache_block(torch.nn.functional.pad(c_kv, pad)),
        "k_rope": cache_block(torch.nn.functional.pad(k_rope[:, :, 0, :], pad)),
    }
    return out, cache


def _mla_cache_write(params, x, cache, pos: int, cfg: ModelConfig, layer):
    """The decode token's projections, its latent and RoPE-key rows written
    into ``cache`` in place at ``pos`` (clamped into the cache, as
    ``dynamic_update_slice`` clamps it, by the rank that holds it:
    :func:`_write_row`)."""
    posv = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    q_nope, q_rope, c_kv1, k_rope1 = _mla_qkv(params, x, cfg, posv, layer)
    _write_row(cache, {"c_kv": c_kv1[:, 0], "k_rope": k_rope1[:, 0, 0]}, pos)
    return q_nope, q_rope, cache["c_kv"], cache["k_rope"]


def mla_decode_absorbed(params, x, cache, pos, cfg: ModelConfig, layer=None):
    """MLA decode with the up-projections absorbed into the query and
    output paths: attention runs against the latent cache in f32, with
    ``wuk`` / ``wuv`` read as floats (dequantized when packed or
    int8-stored), so no per-head K/V is expanded.  Reference:
    ``repro.models.attention:mla_decode_absorbed``.  The cache is updated
    in place; the returned dict holds the same tensors."""
    b = x.shape[0]
    nope, rope, vd, r = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
    pos = int(pos)
    q_nope, q_rope, c, kr = _mla_cache_write(params, x, cache, pos, cfg, layer)
    c = with_logical(c, ("batch", "kv_seq", None))
    kr = with_logical(kr, ("batch", "kv_seq", None))
    f32 = torch.float32
    # (r, heads, .): this rank's heads where they are placed
    w_uk = _mla_up_weight(params["wuk"]).to(f32).reshape(r, -1, nope)
    w_uv = _mla_up_weight(params["wuv"]).to(f32).reshape(r, -1, vd)
    q_abs = torch.einsum("bqhn,rhn->bqhr", q_nope.to(f32), w_uk)
    cf = c.to(f32)
    s_nope = torch.einsum("bqhr,bsr->bhqs", q_abs, cf)
    s_rope = torch.einsum("bqhe,bse->bhqs", q_rope.to(f32), kr.to(f32))
    ctx = _decode_attend((s_nope + s_rope) * (nope + rope) ** -0.5, pos, "bhqs,bsr->bqhr", cf)
    out = torch.einsum("bqhr,rhv->bqhv", ctx, w_uv)
    out = dense(params["wo"], out.reshape(b, 1, -1).to(x.dtype), cfg, site="attn.wo", layer=layer,
                k_local="heads")
    return out, {"c_kv": c, "k_rope": kr}


def _expands_whole(cfg: ModelConfig, rows: int) -> bool:
    """Whether an expanded MLA decode over a ``kv_seq``-placed cache of
    ``rows`` batch rows expands the gathered cache (the replicated
    program's rows) and keeps its block of positions, where this rank's
    block of the latent rows cannot draw the replicated program's noise by
    itself (:func:`mla_decode`).  Only a noisy channel's ids depend on
    where a row lies."""
    from repro_torch.models.common import engine_from_model_config
    from repro_torch.photonic import sharded

    eng = engine_from_model_config(cfg)
    if eng is None or not (eng.routes("attn.wuk") or eng.routes("attn.wuv")) or not eng.noisy:
        return False
    if eng.backend == "exact":
        return False
    if eng.slicing is not None or block("batch") is not None:
        return True
    tp = sharded.current_tp()
    if tp is None or tp.size() <= 1:
        return False
    if tp.manual:
        return True
    data = tuple(a for a in tp.mesh.mesh_dim_names if a != tp.axis)
    part = block("kv_seq").part
    return rows != 1 or (part if isinstance(part, tuple) else (part,)) != data


def mla_decode(params, x, cache, pos, cfg: ModelConfig, layer=None):
    """MLA decode against the compressed cache.  Without ``mla_absorb`` the
    up-projections re-expand every row of the padded cache (``B *
    max_seq`` rows through ``wuk`` and ``wuv``, padding included, so the
    noise streams follow the reference's tiling).  Where ``"kv_seq"`` is
    placed a rank expands its block of the rows, their activation scale a
    ``MAX`` over the blocks (``sharding.rows_over``), in the form of the
    program it replaces:

    * without a tensor-parallel scope the replicated program runs the rows
      whole: each batch row's block runs at its global row origin with the
      whole operand's content word (``engine._stream_gemm``,
      ``sharding.row_segments`` / ``rows_word``), one launch a batch row;
    * under ``tensor_parallel(mesh)`` the replicated program splits the
      ``B * max_seq`` rows over the mesh's other axes itself (the
      reference's ``_row_sharding``), each block drawing with its own tiling
      and content word: at one row over those axes (``long_500k``) this
      rank's block is that block, and it runs as it is;
    * elsewhere on a noisy channel (a TP row block that is not this rank's
      positions, manual TP, a bit-sliced engine, placed batch rows: see
      :func:`_expands_whole`) the rank gathers the latent rows over
      ``kv_seq`` (two all-gathers, ``SEQ_COLLECTIVES["kv_rows"]``), expands
      them as the replicated program does and keeps its positions.

    Reference: ``repro.models.attention:mla_decode``."""
    if cfg.mla_absorb:
        return mla_decode_absorbed(params, x, cache, pos, cfg, layer)
    b = x.shape[0]
    pos = int(pos)
    q_nope, q_rope, c, kr = _mla_cache_write(params, x, cache, pos, cfg, layer)
    c = with_logical(c, ("batch", "kv_seq", None))
    kr = with_logical(kr, ("batch", "kv_seq", None))
    kv = block("kv_seq")
    if kv is not None and _expands_whole(cfg, b):
        cw, krw = (shd.gather_block(t, "kv_seq", 1, "kv_rows") for t in (c, kr))
        k, v = (dataclasses.replace(kv, size=t.shape[1]).take(t, 1)
                for t in _mla_expand_kv(params, cw, krw[:, :, None, :], cfg, layer))
    else:
        with shd.rows_over("kv_seq"):
            k, v = _mla_expand_kv(params, c, kr[:, :, None, :], cfg, layer)
    q = torch.cat([q_nope, q_rope], dim=-1)
    qf = q.to(torch.float32) * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    s = torch.einsum("bqhd,bshd->bhqs", qf, k.to(torch.float32))
    out = _decode_attend(s, pos, "bhqs,bshd->bqhd", v.to(torch.float32))
    out = dense(params["wo"], out.reshape(b, 1, -1).to(x.dtype), cfg, site="attn.wo", layer=layer,
                k_local="heads")
    return out, {"c_kv": c, "k_rope": kr}
