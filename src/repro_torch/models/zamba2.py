"""Zamba2 hybrid (arXiv:2411.15242), in PyTorch: a Mamba2 backbone with a
single weight-shared attention + MLP block applied every ``attn_every``
layers.

Port of ``repro.models.zamba2``, with its simplifications (DESIGN.md
§7): the shared block reads the hidden state only (no concat with the
original embedding), the per-invocation LoRA adapters are left out, and
each invocation keeps its own KV cache (stacked), since it attends over
its own inputs.  ``params["mamba"]`` is a list of groups, each a list of
per-layer dicts (the reference stacks them ``(n_groups, attn_every,
...)``); ``params["shared"]`` is one set of weights.  The caches keep the
reference's stacked layout (``mamba`` leaves ``(n_groups, attn_every, B,
...)``, ``attn`` leaves ``(n_groups, B, max_seq, kv, hd)``) with a
batchless ``pos``, and decode updates them in place.  No GEMM here passes
``layer=``, exactly as in the reference: the Mamba2 layers share one noise
stream per site, and the shared block's invocations share theirs (a
reference quirk the port copies, not a fault of the port).

Placed (``runtime.sharding.place_params``), the Mamba2 stack holds its
``inner`` / ``mamba_heads`` blocks (``models.ssm``), the shared block its
heads and ``d_ff`` (one weight set, placed once, read by every
invocation: column-parallel ``wq`` / ``wk`` / ``wv`` / ``ffn.wi``,
row-parallel ``wo`` / ``ffn.wo``), and the embedding and head their vocab
blocks.  Under a placement of ``"seq_sp"`` the training forward's
residual between layers is this rank's block of the sequence, as the
reference's constraints hold it: each Mamba2 layer and the shared block
gather the sequence they scan and attend over whole and cut their output
back (``lm``'s form), and the head gathers it.  The prefill, which the
reference does not constrain, stays whole.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import ffn, ssm
from repro_torch.models.common import ModelConfig
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.sharding import RESIDUAL


def _n_groups(cfg: ModelConfig) -> int:
    return cfg.num_layers // cfg.attn_every


def zamba2_def(cfg: ModelConfig) -> Dict[str, Any]:
    """Reference: ``repro.models.zamba2:zamba2_def`` (lists where it stacks)."""
    return {
        "embed": cm.embed_def(cfg.n_vocab, cfg.d_model),
        "mamba": [[ssm.mamba_def(cfg) for _ in range(cfg.attn_every)] for _ in range(_n_groups(cfg))],
        "shared": {  # ONE set of weights, applied at every group boundary
            "ln1": cm.rmsnorm_def(cfg.d_model),
            "attn": attn.gqa_def(cfg),
            "ln2": cm.rmsnorm_def(cfg.d_model),
            "ffn": ffn.mlp_def(cfg),
        },
        "final_norm": cm.rmsnorm_def(cfg.d_model),
        "lm_head": cm.qdense_def(cfg, cfg.d_model, cfg.n_vocab, (None, "vocab")),
    }


def _shared_block(params, x, cfg: ModelConfig, positions):
    """Reference: ``repro.models.zamba2:_shared_block``."""
    h = cm.rmsnorm(params["ln1"], x, cfg.norm_eps)
    x = x + attn.gqa_attention(params["attn"], h, cfg, positions=positions)
    return _shared_ffn(params, x, cfg)


def _shared_ffn(params, x, cfg: ModelConfig):
    h = cm.rmsnorm(params["ln2"], x, cfg.norm_eps)
    return x + ffn.mlp(params["ffn"], h, cfg)


def _head(params, x, cfg: ModelConfig) -> torch.Tensor:
    x = cm.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return cm.dense(params["lm_head"], x, cfg, site="lm_head", columns=(("vocab", cfg.n_vocab),))


def zamba2_logits(params, tokens: torch.Tensor, cfg: ModelConfig):
    """Logits of every position ``(B, T, V)`` and a zero aux loss; each
    Mamba2 block under ``apply_remat``, as the reference's scan has it.
    Reference: ``repro.models.zamba2:zamba2_logits``."""
    with shd.sequence(tokens.shape[1]):
        x = shd.seq_scatter(cm.embed(params["embed"], tokens, cfg))
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        mblk = cm.apply_remat(lambda p, x: shd.seq_scatter(ssm.mamba_block(p, shd.seq_gather(x), cfg), None), cfg)
        for group in params["mamba"]:
            for p in group:
                x = cm.with_logical(mblk(p, x), RESIDUAL)
            x = shd.seq_scatter(_shared_block(params["shared"], shd.seq_gather(x), cfg, positions), None)
            x = cm.with_logical(x, RESIDUAL)
        logits = _head(params, shd.seq_gather(x), cfg)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def zamba2_loss(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig) -> torch.Tensor:
    """Reference: ``repro.models.zamba2:zamba2_loss``."""
    logits, _ = zamba2_logits(params, batch["tokens"], cfg)
    return cm.softmax_cross_entropy(logits, batch["labels"], cfg.vocab_size)


def zamba2_prefill(params, tokens: torch.Tensor, cfg: ModelConfig, max_seq: int):
    """Run the prompt ``(B, T)``; returns ``(last-position logits (B, 1,
    V), cache)`` (module docstring), ``pos = T``.  Reference:
    ``repro.models.zamba2:zamba2_prefill``."""
    t = tokens.shape[1]
    x = cm.embed(params["embed"], tokens, cfg)
    positions = torch.arange(t, device=tokens.device)
    shared = params["shared"]
    mamba_states, attn_caches = [], []
    for group in params["mamba"]:
        msts = []
        for p in group:
            x, st = ssm.mamba_prefill(p, x, cfg)
            msts.append(st)
        mamba_states.append(cm.stack_states(msts))
        h = cm.rmsnorm(shared["ln1"], x, cfg.norm_eps)
        a, kv = attn.gqa_prefill(shared["attn"], h, cfg, positions=positions, max_seq=max_seq)
        x = _shared_ffn(shared, x + a, cfg)
        attn_caches.append(kv)
    if attn_caches:
        cache = {"mamba": cm.stack_states(mamba_states), "attn": cm.stack_states(attn_caches)}
    else:  # no groups: the reference's zero-length scans
        empty = zamba2_cache_def(cfg, tokens.shape[0], max_seq, x.dtype)
        cache = {k: cm.zeros_of(empty[k], x.device) for k in ("mamba", "attn")}
    cache["pos"] = t
    return _head(params, x[:, -1:], cfg), cache


def zamba2_decode(params, token: torch.Tensor, cache, cfg: ModelConfig):
    """One step for ``token`` ``(B, 1)``; every invocation of the shared
    attention decodes at the cache's one ``pos``.  Returns ``(logits (B,
    1, V), cache)`` with ``pos`` advanced; the state and KV tensors are
    updated in place, the returned dict is new, holding the same tensors.
    Reference: ``repro.models.zamba2:zamba2_decode``."""
    x = cm.embed(params["embed"], token, cfg)
    pos = cache["pos"]
    shared = params["shared"]
    mc = cache["mamba"]
    for g, group in enumerate(params["mamba"]):
        for i, p in enumerate(group):
            x, st = ssm.mamba_decode(p, x, {k: v[g, i] for k, v in mc.items()}, cfg)
            for k, v in st.items():
                mc[k][g, i].copy_(v)
        h = cm.rmsnorm(shared["ln1"], x, cfg.norm_eps)
        a, _ = attn.gqa_decode(shared["attn"], h, {k: v[g] for k, v in cache["attn"].items()}, pos, cfg)
        x = _shared_ffn(shared, x + a, cfg)
    return _head(params, x, cfg), {**cache, "pos": pos + 1}


def zamba2_cache_def(cfg: ModelConfig, batch: int, max_seq: int, dtype) -> Dict[str, Any]:
    """Reference: ``repro.models.zamba2:zamba2_cache_def``."""
    g, per = _n_groups(cfg), cfg.attn_every
    mstate = ssm.mamba_state_def(cfg, batch, dtype)
    acache = attn.gqa_cache_def(cfg, batch, max_seq, dtype)
    return {
        "mamba": {k: ((g, per) + shape, shd.lead((None, None), axes), dt) for k, (shape, axes, dt) in mstate.items()},
        "attn": {k: ((g,) + shape, (None,) + axes, dt) for k, (shape, axes, dt) in acache.items()},
        "pos": ((), (), torch.int32),
    }
