"""Whisper-medium backbone (the audio family): a transformer
encoder-decoder, in PyTorch.

Port of ``repro.models.whisper``.  The conv/mel frontend is a stub, as
there: the encoder takes precomputed frame embeddings ``(B, T_enc, D)``, and
RoPE stands in for the learned/sinusoidal positions.  ``enc_layers`` and
``dec_layers`` are per-layer lists (the reference stacks and scans them).
No GEMM here passes ``layer=``, exactly as in the reference: the 24
encoder layers share one noise stream per site, and so do the 24 decoder
layers (a reference quirk the port copies, not a fault of the port).  The
encoder's residual stream stays in the embeddings' dtype (``encode`` never
casts to ``compute_dtype``), so an f32 ``audio_embed`` gives f32 encoder
activations and f32 cross K/V beside the decoder's bf16 queries.

Placed (``runtime.sharding.place_params``), every attention and MLP takes
the dense decoders' forms: column-parallel ``wq`` / ``wk`` / ``wv`` over
the heads (the cross-attention's ``wk`` / ``wv`` write the rank's KV heads
of the cross cache) and ``ffn.wi`` over ``d_ff``, row-parallel ``wo`` and
``ffn.wo``, the embedding and head over the (padded) vocab.

Under a placement of ``"seq_sp"`` (prefill and training) ``audio_embed``
comes in as this rank's block of the frames and the encoder's residual
between layers is that block, as the reference's ``("batch", "seq_sp",
None)`` constraints hold it: each layer gathers the frames where it reads
them whole and cuts its output back (``lm``'s form).  The encoder output
is gathered once, before the final norm (every decoder layer's cross K/V
reads it whole).  The training decoder's residual is a block of its own
``T_enc // decoder_ratio`` positions (``sharding.sequence``); the prefill's
and decode's decoder stay whole, as the reference constrains neither.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import ffn
from repro_torch.models.common import ModelConfig
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.sharding import RESIDUAL


def _enc_block_def(cfg: ModelConfig) -> Dict[str, Any]:
    """Reference: ``repro.models.whisper:_enc_block_def``."""
    return {
        "ln1": cm.rmsnorm_def(cfg.d_model),
        "attn": attn.gqa_def(cfg),
        "ln2": cm.rmsnorm_def(cfg.d_model),
        "ffn": ffn.mlp_def(cfg),
    }


def _dec_block_def(cfg: ModelConfig) -> Dict[str, Any]:
    """Reference: ``repro.models.whisper:_dec_block_def``."""
    d = _enc_block_def(cfg)
    d["ln_cross"] = cm.rmsnorm_def(cfg.d_model)
    d["cross"] = attn.gqa_def(cfg)
    return d


def whisper_def(cfg: ModelConfig) -> Dict[str, Any]:
    """Reference: ``repro.models.whisper:whisper_def`` (per-layer lists)."""
    return {
        "enc_layers": [_enc_block_def(cfg) for _ in range(cfg.encoder_layers)],
        "enc_norm": cm.rmsnorm_def(cfg.d_model),
        "embed": cm.embed_def(cfg.n_vocab, cfg.d_model),
        "dec_layers": [_dec_block_def(cfg) for _ in range(cfg.num_layers)],
        "final_norm": cm.rmsnorm_def(cfg.d_model),
        "lm_head": cm.qdense_def(cfg, cfg.d_model, cfg.n_vocab, (None, "vocab")),
    }


def _norm(cfg):
    """The blocks' rmsnorm, ``(params, x) -> x`` (``sharding.seq_block``:
    each block in the Megatron form where ``"seq_sp"`` is placed, as
    ``models.lm``'s)."""
    return lambda p, x: cm.rmsnorm(p, x, cfg.norm_eps)


def _enc_body(p, x, positions, cfg):
    with shd.seq_block(x, _norm(cfg), p["ln1"], attn.columns_placed(p["attn"], cfg)) as h:
        a = attn.gqa_attention(p["attn"], h, cfg, positions=positions, causal=False)
    x = x + shd.seq_scatter(a, None)
    with shd.seq_block(x, _norm(cfg), p["ln2"], ffn.columns_placed(p["ffn"], cfg)) as h:
        f = ffn.mlp(p["ffn"], h, cfg)
    x = x + shd.seq_scatter(f, None)
    return cm.with_logical(x, RESIDUAL)


def encode(params, audio_embed: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The encoder over ``audio_embed`` ``(B, T_enc, D)``: non-causal
    self-attention (the flash kernel's core under ``attn_impl="flash"``)
    and the gelu MLP, each layer under ``apply_remat``; ``audio_embed``
    this rank's block of the frames where ``"seq_sp"`` is placed (the
    output is whole).  Reference: ``repro.models.whisper:encode``."""
    b = shd.block("seq_sp")
    t = audio_embed.shape[1] * (1 if b is None else b.count)
    positions = torch.arange(t, device=audio_embed.device)
    body = cm.apply_remat(_enc_body, cfg)
    x = cm.with_logical(audio_embed, RESIDUAL)
    for p in params["enc_layers"]:
        x = body(p, x, positions, cfg)
    x = cm.rmsnorm(params["enc_norm"], shd.seq_gather(x), cfg.norm_eps)
    # replicated over "model" once: every decoder layer's cross K/V reads it
    return cm.with_logical(x, ("batch", None, None))


def _dec_block(p, x, enc_kv, cfg: ModelConfig, positions):
    """Reference: ``repro.models.whisper:_dec_block``."""
    with shd.seq_block(x, _norm(cfg), p["ln1"], attn.columns_placed(p["attn"], cfg)) as h:
        a = attn.gqa_attention(p["attn"], h, cfg, positions=positions, causal=True)
    x = x + shd.seq_scatter(a, None)
    with shd.seq_block(x, _norm(cfg), p["ln_cross"]) as h:
        a = attn.cross_attention(p["cross"], h, enc_kv, cfg)
    x = x + shd.seq_scatter(a, None)
    with shd.seq_block(x, _norm(cfg), p["ln2"], ffn.columns_placed(p["ffn"], cfg)) as h:
        f = ffn.mlp(p["ffn"], h, cfg)
    x = x + shd.seq_scatter(f, None)
    return cm.with_logical(x, RESIDUAL)


def whisper_logits(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """Decoder logits ``(B, T_dec, V)`` of ``batch["tokens"]`` against the
    encoded ``batch["audio_embed"]``, and a zero aux loss.  Reference:
    ``repro.models.whisper:whisper_logits``."""
    enc = encode(params, batch["audio_embed"], cfg)
    tokens = batch["tokens"]
    with shd.sequence(tokens.shape[1]):
        with shd.scattering():
            x = shd.seq_scatter(cm.embed(params["embed"], tokens, cfg), None)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        body = cm.apply_remat(lambda p, x, kv: _dec_block(p, x, kv, cfg, positions), cfg)
        for p in params["dec_layers"]:
            x = body(p, x, attn.cross_kv(p["cross"], enc, cfg))
        x = cm.rmsnorm(params["final_norm"], shd.seq_gather(x), cfg.norm_eps)
    logits = cm.dense(params["lm_head"], x, cfg, site="lm_head", columns=(("vocab", cfg.n_vocab),))
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def whisper_loss(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig) -> torch.Tensor:
    """Mean next-token cross-entropy of the decoder.  Reference:
    ``repro.models.whisper:whisper_loss``."""
    logits, _ = whisper_logits(params, batch, cfg)
    return cm.softmax_cross_entropy(logits, batch["labels"], cfg.vocab_size)


def whisper_prefill(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig, max_seq: int):
    """Encode ``batch["audio_embed"]`` and run the decoder prompt
    ``batch["tokens"]``; returns ``(last-position logits (B, 1, V),
    cache)``, the cache ``{"self": stacked GQA cache (layers, B, max_seq,
    ...), "cross": (k, v) each (layers, B, T_enc, kv, hd), "pos": T}``.
    Reference: ``repro.models.whisper:whisper_prefill``."""
    enc = encode(params, batch["audio_embed"], cfg)
    tokens = batch["tokens"]
    t = tokens.shape[1]
    x = cm.embed(params["embed"], tokens, cfg)
    positions = torch.arange(t, device=tokens.device)
    self_caches, cross_kvs = [], []
    for p in params["dec_layers"]:
        h = cm.rmsnorm(p["ln1"], x, cfg.norm_eps)
        a, kv_self = attn.gqa_prefill(p["attn"], h, cfg, positions=positions, max_seq=max_seq)
        x = x + a
        h = cm.rmsnorm(p["ln_cross"], x, cfg.norm_eps)
        kv_cross = attn.cross_kv(p["cross"], enc, cfg)
        x = x + attn.cross_attention(p["cross"], h, kv_cross, cfg)
        h = cm.rmsnorm(p["ln2"], x, cfg.norm_eps)
        x = x + ffn.mlp(p["ffn"], h, cfg)
        self_caches.append(kv_self)
        cross_kvs.append(tuple(attn.cache_block(t) for t in kv_cross))
    x = cm.rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    logits = cm.dense(params["lm_head"], x, cfg, site="lm_head", columns=(("vocab", cfg.n_vocab),))
    if self_caches:
        cache = {
            "self": {k: torch.stack([c[k] for c in self_caches]) for k in self_caches[0]},
            "cross": tuple(torch.stack(side) for side in zip(*cross_kvs)),
        }
    else:  # no decoder layers: the reference's zero-length scan
        empty = whisper_cache_def(cfg, tokens.shape[0], max_seq, enc.shape[1], enc.dtype)
        cache = {"self": cm.zeros_of(empty["self"], x.device),
                 "cross": tuple(torch.zeros(s, dtype=dt, device=x.device) for s, _, dt in empty["cross"])}
    cache["pos"] = t
    return logits, cache


def whisper_decode(params, token: torch.Tensor, cache, cfg: ModelConfig):
    """One decoder step for ``token`` ``(B, 1)``: self-attention against
    the ``self`` cache (written in place at ``pos``), cross-attention
    against the ``cross`` K/V, which decode reads and never recomputes.
    Returns ``(logits (B, 1, V), cache)`` with ``pos`` advanced.
    Reference: ``repro.models.whisper:whisper_decode``."""
    x = cm.embed(params["embed"], token, cfg)
    pos = cache["pos"]
    ck, cv = cache["cross"]
    for i, p in enumerate(params["dec_layers"]):
        h = cm.rmsnorm(p["ln1"], x, cfg.norm_eps)
        kv_self = {k: v[i] for k, v in cache["self"].items()}
        a, _ = attn.gqa_decode(p["attn"], h, kv_self, pos, cfg)
        x = x + a
        h = cm.rmsnorm(p["ln_cross"], x, cfg.norm_eps)
        x = x + attn.cross_attention(p["cross"], h, (ck[i], cv[i]), cfg, kv_blocks=True)
        h = cm.rmsnorm(p["ln2"], x, cfg.norm_eps)
        x = x + ffn.mlp(p["ffn"], h, cfg)
    x = cm.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = cm.dense(params["lm_head"], x, cfg, site="lm_head", columns=(("vocab", cfg.n_vocab),))
    return logits, {**cache, "pos": pos + 1}


def whisper_cache_def(cfg: ModelConfig, batch: int, max_seq: int, enc_seq: int, dtype) -> Dict[str, Any]:
    """Reference: ``repro.models.whisper:whisper_cache_def``."""
    n = cfg.num_layers
    self_c = attn.gqa_cache_def(cfg, batch, max_seq, dtype)
    cross_shape = (n, batch, enc_seq, cfg.num_kv_heads, cfg.hd)
    cross_axes = (None, "batch", "kv_seq", "kv_heads", None)
    return {
        "self": {k: ((n,) + shape, (None,) + axes, dt) for k, (shape, axes, dt) in self_c.items()},
        "cross": ((cross_shape, cross_axes, dtype), (cross_shape, cross_axes, dtype)),
        "pos": ((), (), torch.int32),
    }
