"""Mamba2 (SSD) blocks, in PyTorch: the chunkwise-parallel scan for the
full sequence and prefill, the O(1) recurrent step for decode.  Used
inside the zamba2 hybrid.

Port of ``repro.models.ssm``.  SSD recurrence per head (scalar decay
``a_t = exp(-exp(A_log) * dt_t)``)::

    S_t = a_t * S_{t-1} + dt_t * x_t (outer) B_t        # (head_dim, state)
    y_t = S_t @ C_t + D * x_t

Within a chunk the quadratic masked form ``L[t,s] = (C_t . B_s) *
exp(b_t - b_s) * dt_s`` (s <= t) gives the intra-chunk terms; a loop over
chunks carries the state (a ``lax.scan`` there).  The scan is plain
``torch.einsum`` / ``torch.cumsum``, as it is ``jnp`` outside any Pallas
kernel in the reference, except that the intra-chunk ``exp`` is masked
before it is taken (:func:`_live_exp`), which keeps the reference's
forward and makes its NaN gradient at ``ssm_chunk = 256`` finite.  The
causal conv keeps both of the reference's spellings: prefill sums the W
shifted products from the int 0, decode is an ``einsum`` over the window.
No GEMM here passes ``layer=``, as in the reference.

Under a placement of ``inner`` and ``mamba_heads`` over ``model``
(placed parameters, ``runtime.sharding.place_params``) a rank runs its
block of the heads, as the reference's ``param_axes`` and state axes hold
them: ``in_proj`` is column-parallel by its parts ``[z | x | B C | dt]``
(a block of each), the depthwise conv runs on the rank's channels of ``[x
| B C]``, ``B`` and ``C`` (read by every head, one group) are gathered
whole after it, the SSD runs on the rank's heads with its blocks of
``a_log`` / ``dt_bias`` / ``d_skip``, and the gated norm's input is
gathered whole (``out_norm`` normalizes over all of ``inner``: the
gather keeps the replicated program's sums, where an all-reduced sum of
squares would not) before ``out_proj`` runs row-parallel on the rank's
block.  The decode state holds the rank's heads of ``ssm`` and its
channels of ``conv``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm
from repro_torch.models.common import P, ModelConfig, dense, qdense_def
from repro_torch.runtime import sharding as shd


def _inner(cfg: ModelConfig) -> int:
    return cfg.ssm_expand * cfg.d_model


def _nheads(cfg: ModelConfig) -> int:
    return _inner(cfg) // cfg.ssm_head_dim


def _in_parts(cfg: ModelConfig) -> Tuple[Tuple[str, int], ...]:
    """``in_proj``'s output columns, ``[z | x | B C | dt]``, as ``(logical
    name, global width)`` parts."""
    inner, st = _inner(cfg), cfg.ssm_state_size
    return (("inner", inner), ("inner", inner), ("inner", 2 * st), ("mamba_heads", _nheads(cfg)))


def _conv_parts(cfg: ModelConfig) -> Tuple[int, int]:
    """The conv channels' parts ``[x | B C]`` (global widths)."""
    return _inner(cfg), 2 * cfg.ssm_state_size


def mamba_def(cfg: ModelConfig) -> Dict[str, Any]:
    """Reference: ``repro.models.ssm:mamba_def`` (the port declares the
    column parts of ``in_proj`` and the conv)."""
    d, inner, st, h = cfg.d_model, _inner(cfg), cfg.ssm_state_size, _nheads(cfg)
    conv_ch = inner + 2 * st
    return {
        "ln": cm.rmsnorm_def(d),
        "in_proj": qdense_def(cfg, d, 2 * inner + 2 * st + h, (None, "inner"),
                              parts=tuple(w for _, w in _in_parts(cfg))),
        "conv_w": P((cfg.ssm_conv_width, conv_ch), (None, "inner"), parts=_conv_parts(cfg)),
        "conv_b": P((conv_ch,), ("inner",), init="zeros", parts=_conv_parts(cfg)),
        "a_log": P((h,), ("mamba_heads",), init="zeros"),
        "dt_bias": P((h,), ("mamba_heads",), init="zeros"),
        "d_skip": P((h,), ("mamba_heads",), init="ones"),
        "out_norm": cm.rmsnorm_def(inner),
        "out_proj": qdense_def(cfg, inner, d, ("inner", None)),
    }


def _blocks() -> int:
    """How many blocks of the heads the placement cuts (1: whole)."""
    b = shd.block("inner")
    return 1 if b is None else b.count


def _split_in(params, x, cfg: ModelConfig):
    """``(z, xbc, dt)``: this rank's block of each under a placement of
    ``inner``.  Reference: ``repro.models.ssm:_split_in``."""
    n = _blocks()
    inner, st = _inner(cfg) // n, 2 * cfg.ssm_state_size // n
    u = dense(params["in_proj"], x, cfg, site="in_proj", columns=_in_parts(cfg))
    return u[..., :inner], u[..., inner : 2 * inner + st], u[..., 2 * inner + st :]


def _split_conv(xbc: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The conv's output as ``(x, B, C)``: ``x`` this rank's channels, ``B``
    and ``C`` whole (gathered, then :func:`~repro_torch.runtime.sharding.
    copy_to_model`, since every rank's heads read them)."""
    n, st = _blocks(), cfg.ssm_state_size
    xi, bc = xbc[..., : _inner(cfg) // n], xbc[..., _inner(cfg) // n :]
    if n > 1:
        bc = shd.copy_to_model(shd.gather_block(bc, "inner", bc.dim() - 1, "parts"), shd.block("inner").part,
                               "split_input")
    return xi, bc[..., :st], bc[..., st:]


def _gated_out(params, y: torch.Tensor, z: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``out_proj(rmsnorm(y * silu(z)))``: under a placement the norm's
    input gathered whole, its output split to this rank's block for the
    row-parallel ``out_proj``."""
    g = y * F.silu(z)
    if _blocks() == 1:
        g = cm.rmsnorm(params["out_norm"], g, cfg.norm_eps)
    else:
        g = shd.split_block(cm.rmsnorm(params["out_norm"], shd.gather_block(g, "inner", g.dim() - 1, "norm"),
                                       cfg.norm_eps), "inner")
    return dense(params["out_proj"], g, cfg, site="out_proj", k_local="inner")


def _causal_conv(params, xbc: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time, ``xbc`` ``(B, T, C)``: the Python
    sum of the W shifted products from the int 0, in ``xbc``'s dtype.
    Reference: ``repro.models.ssm:_causal_conv``."""
    w = params["conv_w"].to(xbc.dtype)  # (W, C)
    width = w.shape[0]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    t = xbc.shape[1]
    out = sum(pad[:, i : i + t, :] * w[i][None, None, :] for i in range(width))
    return F.silu(out + params["conv_b"].to(xbc.dtype))


def _live_exp(gap: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """``exp(gap)`` on the live entries (s <= t), ``exp(0)`` above the
    diagonal, which the caller drops.  The reference exponentiates every
    entry (``ssm.py:114-117``): above the diagonal ``gap = b_t - b_s > 0``
    reaches about ``0.7 x (chunk - 1)``, past f32's ``exp`` limit (88.7) at
    its published chunk of 256, and although the forward drops the
    ``inf``, the backward multiplies it by a zero cotangent and gets NaN.
    Masking first leaves the forward bitwise the same."""
    return torch.exp(torch.where(live, gap, 0.0))


def _ssd_chunked(
    xh: torch.Tensor,  # (B, T, H, dh)
    b_mat: torch.Tensor,  # (B, T, st)
    c_mat: torch.Tensor,  # (B, T, st)
    dt: torch.Tensor,  # (B, T, H)  (softplus'd)
    a_log: torch.Tensor,  # (H,)
    chunk: int,
    s0: Optional[torch.Tensor] = None,  # (B, H, dh, st) initial state
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunkwise SSD: ``(y (B, T, H, dh) f32, final state (B, H, dh, st)
    f32)``.  ``chunk = min(chunk, T)``; T is zero-padded to a multiple of
    it.  Reference: ``repro.models.ssm:_ssd_chunked``."""
    bsz, t, h, dh = xh.shape
    st = b_mat.shape[-1]
    chunk = min(chunk, t)
    pad = (-t) % chunk
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    tp = t + pad
    f32 = torch.float32
    decay = -torch.exp(a_log.to(f32))  # (H,) negative rates
    state = torch.zeros((bsz, h, dh, st), dtype=f32, device=xh.device) if s0 is None else s0
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=xh.device))
    ys = []
    for c0 in range(0, tp, chunk):
        sl = slice(c0, c0 + chunk)
        xc, bc, cc, dtc = (a[:, sl].to(f32) for a in (xh, b_mat, c_mat, dt))
        loga = dtc * decay[None, None, :]  # (B, L, H) log a_t
        b_cum = torch.cumsum(loga, dim=1)  # (B, L, H)
        # intra-chunk: L[t,s] = (C_t.B_s) exp(b_t - b_s) dt_s  (s <= t)
        cb = torch.einsum("bts,bls->btl", cc, bc)
        gap = b_cum[:, :, None, :] - b_cum[:, None, :, :]  # (B, L_t, L_s, H)
        live = tri[None, :, :, None]
        lmat = torch.where(live, cb[..., None] * _live_exp(gap, live), 0.0) * dtc[:, None, :, :]
        y_intra = torch.einsum("btsh,bshd->bthd", lmat, xc)
        # inter-chunk: y_t += C_t @ (exp(b_t) * S_prev)
        y_inter = torch.einsum("bts,bhds,bth->bthd", cc, state, torch.exp(b_cum))
        # state update
        b_tot = b_cum[:, -1, :]  # (B, H)
        w = torch.exp(b_tot[:, None, :] - b_cum) * dtc  # (B, L, H)
        s_new = torch.einsum("blh,bls,blhd->bhds", w, bc, xc)
        state = state * torch.exp(b_tot)[:, :, None, None] + s_new
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1)[:, :t], state


def _mamba_core(params, x: torch.Tensor, cfg: ModelConfig):
    """The full-sequence block up to its output: ``(x + out, final SSD
    state, pre-conv xbc)``.  ``mamba_block`` and ``mamba_prefill`` are
    this computation in the reference, spelled out twice there."""
    dh = cfg.ssm_head_dim
    f32 = torch.float32
    xn = cm.rmsnorm(params["ln"], x, cfg.norm_eps)
    z, xbc_in, dt = _split_in(params, xn, cfg)
    xi, b_mat, c_mat = _split_conv(_causal_conv(params, xbc_in), cfg)
    xi = xi.reshape(*x.shape[:2], -1, dh)
    dt = cm.softplus(dt.to(f32) + params["dt_bias"].to(f32))
    y, s = _ssd_chunked(xi, b_mat, c_mat, dt, params["a_log"], cfg.ssm_chunk)
    y = y + params["d_skip"].to(f32)[None, None, :, None] * xi.to(f32)
    y = y.reshape(*x.shape[:2], -1).to(x.dtype)
    return x + _gated_out(params, y, z, cfg), s, xbc_in


def mamba_block(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence (train/prefill) Mamba2 block with residual.
    Reference: ``repro.models.ssm:mamba_block``."""
    return _mamba_core(params, x, cfg)[0]


def mamba_state_def(cfg: ModelConfig, batch: int, dtype) -> Dict[str, Any]:
    """Reference: ``repro.models.ssm:mamba_state_def`` (the port declares
    the conv state's channel parts ``[x | B C]``)."""
    inner, st, h, dh = _inner(cfg), cfg.ssm_state_size, _nheads(cfg), cfg.ssm_head_dim
    conv_ch = inner + 2 * st
    return {
        "ssm": ((batch, h, dh, st), ("batch", "mamba_heads", None, None), torch.float32),
        "conv": ((batch, cfg.ssm_conv_width - 1, conv_ch), shd.parted(("batch", None, "inner"), _conv_parts(cfg)),
                 dtype),
    }


def mamba_prefill(params, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Like :func:`mamba_block`, and the decode state: the final SSD state
    and the last ``W - 1`` pre-conv inputs.  Reference:
    ``repro.models.ssm:mamba_prefill``."""
    out, s, xbc = _mamba_core(params, x, cfg)
    return out, {"ssm": s, "conv": xbc[:, -(cfg.ssm_conv_width - 1) :, :]}


def mamba_decode(
    params, x: torch.Tensor, state: Dict[str, torch.Tensor], cfg: ModelConfig
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token step, ``x`` ``(B, 1, D)``; returns the output and the new
    state (fresh tensors; the caller keeps them).  Reference:
    ``repro.models.ssm:mamba_decode``."""
    dh = cfg.ssm_head_dim
    f32 = torch.float32
    xn = cm.rmsnorm(params["ln"], x, cfg.norm_eps)
    z, xbc, dt = _split_in(params, xn, cfg)  # (B, 1, ...)
    conv_in = torch.cat([state["conv"].to(xbc.dtype), xbc], dim=1)
    new_conv = conv_in[:, 1:, :]
    w = params["conv_w"].to(xbc.dtype)
    width = w.shape[0]
    conv_out = torch.einsum("bwc,wc->bc", conv_in[:, -width:, :], w)
    xi, b_v, c_v = _split_conv(F.silu(conv_out + params["conv_b"].to(xbc.dtype)), cfg)  # (B, C)
    xi = xi.reshape(xi.shape[0], -1, dh).to(f32)
    b_v, c_v = b_v.to(f32), c_v.to(f32)
    dt1 = cm.softplus(dt[:, 0, :].to(f32) + params["dt_bias"].to(f32))  # (B, H)
    a = torch.exp(dt1 * -torch.exp(params["a_log"].to(f32)))  # (B, H)
    s = state["ssm"] * a[:, :, None, None] + torch.einsum("bh,bhd,bs->bhds", dt1, xi, b_v)
    y = torch.einsum("bhds,bs->bhd", s, c_v)
    y = y + params["d_skip"].to(f32)[None, :, None] * xi
    y = y.reshape(-1, 1, xi.shape[1] * dh).to(x.dtype)
    return x + _gated_out(params, y, z, cfg), {"ssm": s, "conv": new_conv}


def ssd_reference(xh, b_mat, c_mat, dt, a_log):
    """Step-by-step recurrence, the oracle of :func:`_ssd_chunked`.
    Reference: ``repro.models.ssm:ssd_reference``."""
    bsz, t, h, dh = xh.shape
    st = b_mat.shape[-1]
    f32 = torch.float32
    decay = -torch.exp(a_log.to(f32))
    s = torch.zeros((bsz, h, dh, st), dtype=f32, device=xh.device)
    ys = []
    for i in range(t):
        a = torch.exp(dt[:, i, :] * decay[None, :])  # (B, H)
        s = s * a[:, :, None, None] + torch.einsum(
            "bh,bhd,bs->bhds", dt[:, i, :], xh[:, i].to(f32), b_mat[:, i].to(f32)
        )
        ys.append(torch.einsum("bhds,bs->bhd", s, c_mat[:, i].to(f32)))
    return torch.stack(ys, dim=1), s
