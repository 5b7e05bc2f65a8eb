"""xLSTM (arXiv:2405.04517), in PyTorch: mLSTM (matrix memory,
chunkwise-parallel with log-domain stabilization) and sLSTM (scalar
memory, a sequential scan with recurrent gating), in groups of
``slstm_every - 1`` mLSTM layers and one sLSTM layer.

Port of ``repro.models.xlstm``.  The mLSTM recurrences (stabilizer m_t)::

    m_t = max(log f_t + m_{t-1}, i~_t)
    C_t = e^{log f_t + m_{t-1} - m_t} C_{t-1} + e^{i~_t - m_t} k_t v_t^T
    n_t = e^{log f_t + m_{t-1} - m_t} n_{t-1} + e^{i~_t - m_t} k_t
    h_t = (q_t C_t) / max(|q_t n_t|, e^{-m_t})

The full sequence and prefill use the chunkwise form (a loop over chunks
here, a ``lax.scan`` there), decode the O(1) recurrence; the sLSTM is a
loop over time.  All of it is plain ``torch``, as it is ``jnp`` outside any
Pallas kernel in the reference.  ``params["mlstm"]`` is a list of groups,
each a list of per-layer dicts, and ``params["slstm"]`` a list of one
layer a group (the reference stacks them ``(n_groups, per, ...)`` and
``(n_groups, ...)``); the caches keep the reference's stacked layout and
decode updates them in place.  No GEMM here passes ``layer=``, exactly as
in the reference: all mLSTM layers share one noise stream per site, and so
do all sLSTM layers (a reference quirk the port copies, not a fault of the
port).  Padding sentinels and the stabilizer's start are ``-1e30``, never
``-inf``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm
from repro_torch.models.common import P, ModelConfig, dense, dense_def, qdense_def

NEG = -1e30


def _inner(cfg: ModelConfig) -> int:
    return cfg.ssm_expand * cfg.d_model  # projection factor 2 by default


def _dh(cfg: ModelConfig) -> int:
    return _inner(cfg) // cfg.num_heads


def _groups(cfg: ModelConfig) -> Tuple[int, int]:
    """(groups, mLSTM layers a group)."""
    return cfg.num_layers // cfg.slstm_every, cfg.slstm_every - 1


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def mlstm_def(cfg: ModelConfig) -> Dict[str, Any]:
    """Reference: ``repro.models.xlstm:mlstm_def``.  The gates ``wi`` and
    ``wf`` are plain ``dense_def`` (float under ``weights_int8`` too)."""
    d, inner, h = cfg.d_model, _inner(cfg), cfg.num_heads
    return {
        "ln": cm.rmsnorm_def(d),
        "up": qdense_def(cfg, d, 2 * inner, (None, "inner")),
        "wq": qdense_def(cfg, inner, inner, (None, "inner")),
        "wk": qdense_def(cfg, inner, inner, (None, "inner")),
        "wv": qdense_def(cfg, inner, inner, (None, "inner")),
        "wi": dense_def(inner, h, (None, None), init="zeros"),
        "wf": dense_def(inner, h, (None, None), init="zeros"),
        "out_norm": cm.rmsnorm_def(inner),
        "down": qdense_def(cfg, inner, d, ("inner", None)),
    }


def _mlstm_chunked(
    q, k, v,  # (B, T, H, dh)
    li, lf,  # (B, T, H)  input-gate preact, log-forget
    chunk: int,
    state: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
):
    """Chunkwise mLSTM: ``(h (B, T, H, dh) f32, (C, n, m))``.  ``chunk =
    min(chunk, T)``; T is padded to a multiple of it, ``li`` with
    ``-1e30``.  Reference: ``repro.models.xlstm:_mlstm_chunked``."""
    b, t, h, dh = q.shape
    chunk = min(chunk, t)
    pad = (-t) % chunk
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        li = F.pad(li, (0, 0, 0, pad), value=NEG)
        lf = F.pad(lf, (0, 0, 0, pad))
    tp = t + pad
    scale = dh**-0.5
    f32 = torch.float32
    dev = q.device
    if state is None:
        state = (
            torch.zeros((b, h, dh, dh), dtype=f32, device=dev),  # C
            torch.zeros((b, h, dh), dtype=f32, device=dev),  # n
            torch.full((b, h), NEG, dtype=f32, device=dev),  # m
        )
    c_prev, n_prev, m_prev = state
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=dev))
    hs = []
    for c0 in range(0, tp, chunk):
        sl = slice(c0, c0 + chunk)
        qc = q[:, sl].to(f32) * scale
        kc = k[:, sl].to(f32)
        vc = v[:, sl].to(f32)
        lic, lfc = li[:, sl], lf[:, sl]
        bcum = torch.cumsum(lfc, dim=1)  # (B, L, H)
        # intra log-weights: D[t,s] = b_t - b_s + li_s  (s <= t)
        dmat = bcum[:, :, None, :] - bcum[:, None, :, :] + lic[:, None, :, :]
        dmat = torch.where(tri[None, :, :, None], dmat, NEG)
        inter_w = bcum + m_prev[:, None, :]  # (B, L, H)
        m_t = torch.maximum(dmat.amax(dim=2), inter_w)  # (B, L, H)
        dexp = torch.exp(dmat - m_t[:, :, None, :])
        s = torch.einsum("blhd,bshd->blsh", qc, kc) * dexp  # (B, L, S, H)
        num = torch.einsum("blsh,bshd->blhd", s, vc)
        den = s.sum(dim=2)  # (B, L, H)
        wi = torch.exp(inter_w - m_t)  # (B, L, H)
        num = num + wi[..., None] * torch.einsum("blhd,bhde->blhe", qc, c_prev)
        den = den + wi * torch.einsum("blhd,bhd->blh", qc, n_prev)
        hs.append(num / torch.maximum(torch.abs(den), torch.exp(-m_t))[..., None])
        # chunk-end state
        btot = bcum[:, -1, :]  # (B, H)
        up_w = btot[:, None, :] - bcum + lic  # (B, L, H)
        m_next = torch.maximum(btot + m_prev, up_w.amax(dim=1))
        wexp = torch.exp(up_w - m_next[:, None, :])
        c_new = torch.einsum("blh,blhd,blhe->bhde", wexp, kc, vc)
        n_new = torch.einsum("blh,blhd->bhd", wexp, kc)
        decay = torch.exp(btot + m_prev - m_next)
        c_prev = decay[:, :, None, None] * c_prev + c_new
        n_prev = decay[:, :, None] * n_prev + n_new
        m_prev = m_next
    return torch.cat(hs, dim=1)[:, :t], (c_prev, n_prev, m_prev)


def _mlstm_qkv_gates(params, xin, cfg: ModelConfig):
    """Reference: ``repro.models.xlstm:_mlstm_qkv_gates``."""
    b, t, _ = xin.shape
    h, dh = cfg.num_heads, _dh(cfg)
    q = dense(params["wq"], xin, cfg, site="wq").reshape(b, t, h, dh)
    k = dense(params["wk"], xin, cfg, site="wk").reshape(b, t, h, dh)
    v = dense(params["wv"], xin, cfg, site="wv").reshape(b, t, h, dh)
    li = dense(params["wi"], xin, cfg, site="wi").to(torch.float32)  # (B, T, H)
    lf = cm.log_sigmoid(dense(params["wf"], xin, cfg, site="wf").to(torch.float32))
    return q, k, v, li, lf


def _mlstm_in(params, x, cfg: ModelConfig):
    """The block's norm, up projection and split: ``(q, k, v, li, lf,
    gate)``."""
    xn = cm.rmsnorm(params["ln"], x, cfg.norm_eps)
    u = dense(params["up"], xn, cfg, site="up")
    xin, gate = torch.chunk(u, 2, dim=-1)
    return (*_mlstm_qkv_gates(params, xin, cfg), gate)


def _mlstm_out(params, x, hs, gate, cfg: ModelConfig):
    hs = hs.reshape(*x.shape[:2], -1).to(x.dtype)
    y = cm.rmsnorm(params["out_norm"], hs, cfg.norm_eps) * F.silu(gate)
    return x + dense(params["down"], y, cfg, site="down")


def mlstm_prefill(params, x, cfg: ModelConfig):
    """The full-sequence mLSTM block and its decode state ``{"C", "n",
    "m"}``.  Reference: ``repro.models.xlstm:mlstm_prefill``."""
    q, k, v, li, lf, gate = _mlstm_in(params, x, cfg)
    hs, (c, n, m) = _mlstm_chunked(q, k, v, li, lf, cfg.ssm_chunk)
    return _mlstm_out(params, x, hs, gate, cfg), {"C": c, "n": n, "m": m}


def mlstm_block(params, x, cfg: ModelConfig) -> torch.Tensor:
    """Reference: ``repro.models.xlstm:mlstm_block``."""
    return mlstm_prefill(params, x, cfg)[0]


def mlstm_decode(params, x, state, cfg: ModelConfig):
    """``x`` ``(B, 1, D)``; the O(1) recurrent step.  Returns the output
    and the new state (fresh tensors).  Reference:
    ``repro.models.xlstm:mlstm_decode``."""
    dh = _dh(cfg)
    f32 = torch.float32
    q, k, v, li, lf, gate = _mlstm_in(params, x, cfg)
    q1 = q[:, 0].to(f32) * (dh**-0.5)  # (B, H, dh)
    k1, v1 = k[:, 0].to(f32), v[:, 0].to(f32)
    li1, lf1 = li[:, 0], lf[:, 0]  # (B, H)
    c_prev, n_prev, m_prev = state["C"], state["n"], state["m"]
    m_t = torch.maximum(lf1 + m_prev, li1)
    fw = torch.exp(lf1 + m_prev - m_t)
    iw = torch.exp(li1 - m_t)
    c_t = fw[:, :, None, None] * c_prev + iw[:, :, None, None] * torch.einsum("bhd,bhe->bhde", k1, v1)
    n_t = fw[:, :, None] * n_prev + iw[:, :, None] * k1
    num = torch.einsum("bhd,bhde->bhe", q1, c_t)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", q1, n_t)), torch.exp(-m_t))
    hout = num / den[..., None]
    return _mlstm_out(params, x, hout[:, None], gate, cfg), {"C": c_t, "n": n_t, "m": m_t}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def slstm_def(cfg: ModelConfig) -> Dict[str, Any]:
    """Reference: ``repro.models.xlstm:slstm_def``."""
    d, h = cfg.d_model, cfg.num_heads
    dh = d // h
    return {
        "ln": cm.rmsnorm_def(d),
        "wx": qdense_def(cfg, d, 4 * d, (None, "inner")),
        "r": P((h, dh, 4 * dh), (None, None, None)),  # block-diag recurrent
        "out_norm": cm.rmsnorm_def(d),
        "down": qdense_def(cfg, d, d, ("inner", None)),
    }


def _slstm_scan(params, gx, cfg: ModelConfig, state):
    """``gx`` ``(B, T, 4D)``: the input-side gate preacts; sequential over
    T, the gates split ``i, f, z, o``.  Returns ``(h (B, T, D) f32, (c,
    n, m, h))``.  Reference: ``repro.models.xlstm:_slstm_scan``."""
    b, t, _ = gx.shape
    d, h = cfg.d_model, cfg.num_heads
    dh = d // h
    r = params["r"].to(torch.float32)
    c, n, m, hprev = state
    # jnp.maximum(n, 1e-6): a tie splits the gradient, as torch.maximum
    # does (torch.clamp_min would pass all of it).
    n_floor = torch.full((), 1e-6, dtype=torch.float32, device=gx.device)
    hs = []
    for i in range(t):
        rec = torch.einsum("bhd,hde->bhe", hprev.reshape(b, h, dh), r).reshape(b, 4 * d)
        g = gx[:, i].to(torch.float32) + rec
        gi, gf, gz, go = torch.chunk(g, 4, dim=-1)
        lsf = cm.log_sigmoid(gf)
        m_t = torch.maximum(lsf + m, gi)
        fw = torch.exp(lsf + m - m_t)
        iw = torch.exp(gi - m_t)
        c = fw * c + iw * torch.tanh(gz)
        n = fw * n + iw
        hprev = torch.sigmoid(go) * c / torch.maximum(n, n_floor)
        m = m_t
        hs.append(hprev)
    return torch.stack(hs, dim=1), (c, n, m, hprev)


def _slstm_init_state(b, d, device):
    """Reference: ``repro.models.xlstm:_slstm_init_state``."""
    z = torch.zeros((b, d), dtype=torch.float32, device=device)
    return (z, z, torch.full((b, d), NEG, dtype=torch.float32, device=device), z)


def _slstm(params, x, cfg: ModelConfig, state):
    xn = cm.rmsnorm(params["ln"], x, cfg.norm_eps)
    gx = dense(params["wx"], xn, cfg, site="wx")
    hs, (c, n, m, h) = _slstm_scan(params, gx, cfg, state)
    y = cm.rmsnorm(params["out_norm"], hs.to(x.dtype), cfg.norm_eps)
    return x + dense(params["down"], y, cfg, site="down"), {"c": c, "n": n, "m": m, "h": h}


def slstm_prefill(params, x, cfg: ModelConfig):
    """Reference: ``repro.models.xlstm:slstm_prefill``."""
    return _slstm(params, x, cfg, _slstm_init_state(x.shape[0], cfg.d_model, x.device))


def slstm_block(params, x, cfg: ModelConfig) -> torch.Tensor:
    """Reference: ``repro.models.xlstm:slstm_block``."""
    return slstm_prefill(params, x, cfg)[0]


def slstm_decode(params, x, state, cfg: ModelConfig):
    """Reference: ``repro.models.xlstm:slstm_decode``."""
    return _slstm(params, x, cfg, (state["c"], state["n"], state["m"], state["h"]))


# ---------------------------------------------------------------------------
# The LM: groups of slstm_every - 1 mLSTM layers and one sLSTM layer
# ---------------------------------------------------------------------------
def xlstm_def(cfg: ModelConfig) -> Dict[str, Any]:
    """Reference: ``repro.models.xlstm:xlstm_def`` (lists where it stacks)."""
    n_groups, per = _groups(cfg)
    return {
        "embed": cm.embed_def(cfg.n_vocab, cfg.d_model),
        "mlstm": [[mlstm_def(cfg) for _ in range(per)] for _ in range(n_groups)],
        "slstm": [slstm_def(cfg) for _ in range(n_groups)],
        "final_norm": cm.rmsnorm_def(cfg.d_model),
        "lm_head": cm.qdense_def(cfg, cfg.d_model, cfg.n_vocab, (None, "vocab")),
    }


def _head(params, x, cfg: ModelConfig) -> torch.Tensor:
    x = cm.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return cm.dense(params["lm_head"], x, cfg, site="lm_head")


def xlstm_logits(params, tokens: torch.Tensor, cfg: ModelConfig):
    """Logits of every position ``(B, T, V)`` and a zero aux loss; each
    mLSTM block under ``apply_remat``, as the reference's group scan has
    it.  Reference: ``repro.models.xlstm:xlstm_logits``."""
    x = cm.embed(params["embed"], tokens, cfg)
    x = cm.with_logical(x, ("batch", None, None))
    blk = cm.apply_remat(lambda p, x: mlstm_block(p, x, cfg), cfg)
    for mparams, sparams in zip(params["mlstm"], params["slstm"]):
        for p in mparams:
            x = cm.with_logical(blk(p, x), ("batch", None, None))
        x = slstm_block(sparams, x, cfg)
    logits = _head(params, x, cfg)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def xlstm_loss(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig) -> torch.Tensor:
    """Reference: ``repro.models.xlstm:xlstm_loss``."""
    logits, _ = xlstm_logits(params, batch["tokens"], cfg)
    return cm.softmax_cross_entropy(logits, batch["labels"], cfg.vocab_size)


def xlstm_prefill(params, tokens: torch.Tensor, cfg: ModelConfig, max_seq: int = 0):
    """Run the prompt ``(B, T)``; returns ``(last-position logits (B, 1,
    V), cache)``, the cache ``{"mlstm": {"C", "n", "m"} each (n_groups,
    per, B, ...), "slstm": {"c", "n", "m", "h"} each (n_groups, B, D),
    "pos": T}``.  ``max_seq`` is unused: the state is O(1).  Reference:
    ``repro.models.xlstm:xlstm_prefill``."""
    x = cm.embed(params["embed"], tokens, cfg)
    msts, ssts = [], []
    for mparams, sparams in zip(params["mlstm"], params["slstm"]):
        group = []
        for p in mparams:
            x, st = mlstm_prefill(p, x, cfg)
            group.append(st)
        msts.append(cm.stack_states(group))
        x, st = slstm_prefill(sparams, x, cfg)
        ssts.append(st)
    if ssts:
        cache = {"mlstm": cm.stack_states(msts), "slstm": cm.stack_states(ssts)}
    else:  # no groups: the reference's zero-length scans
        empty = xlstm_cache_def(cfg, tokens.shape[0], 0, x.dtype)
        cache = {k: cm.zeros_of(empty[k], x.device) for k in ("mlstm", "slstm")}
    cache["pos"] = tokens.shape[1]
    return _head(params, x[:, -1:], cfg), cache


def xlstm_decode(params, token: torch.Tensor, cache, cfg: ModelConfig):
    """One step for ``token`` ``(B, 1)``; returns ``(logits (B, 1, V),
    cache)`` with ``pos`` advanced.  The state tensors are updated in
    place; the returned dict is new, holding the same tensors.  Reference:
    ``repro.models.xlstm:xlstm_decode``."""
    x = cm.embed(params["embed"], token, cfg)
    mc, sc = cache["mlstm"], cache["slstm"]
    for g, (mparams, sparams) in enumerate(zip(params["mlstm"], params["slstm"])):
        for i, p in enumerate(mparams):
            x, st = mlstm_decode(p, x, {k: v[g, i] for k, v in mc.items()}, cfg)
            for k, v in st.items():
                mc[k][g, i].copy_(v)
        x, st = slstm_decode(sparams, x, {k: v[g] for k, v in sc.items()}, cfg)
        for k, v in st.items():
            sc[k][g].copy_(v)
    return _head(params, x, cfg), {**cache, "pos": cache["pos"] + 1}


def xlstm_cache_def(cfg: ModelConfig, batch: int, max_seq: int, dtype) -> Dict[str, Any]:
    """Reference: ``repro.models.xlstm:xlstm_cache_def``."""
    n_groups, per = _groups(cfg)
    h, dh, d = cfg.num_heads, _dh(cfg), cfg.d_model
    f32 = torch.float32
    return {
        "mlstm": {
            "C": ((n_groups, per, batch, h, dh, dh), (None, None, "batch", None, "inner", None), f32),
            "n": ((n_groups, per, batch, h, dh), (None, None, "batch", None, "inner"), f32),
            "m": ((n_groups, per, batch, h), (None, None, "batch", None), f32),
        },
        "slstm": {k: ((n_groups, batch, d), (None, "batch", None), f32) for k in ("c", "n", "m", "h")},
        "pos": ((), (), torch.int32),
    }
