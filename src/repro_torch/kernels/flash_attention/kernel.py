"""The flash-attention forward kernel: CUDA C++ for Hopper, its plain twin, the loader.

Port of the reference's Pallas TPU kernel
``repro.kernels.flash_attention.kernel:flash_attention_pallas``; the CUDA
source is ``csrc/flash_attention.cu``, whose note says what it computes,
what bounds it on the card and how it is laid out: bf16 on the tensor
cores, held to the f64 bound of ``ref.oracle_and_bound``; f32 on CUDA
cores, held to the twin.

* :func:`flash_attention_fwd` is the wrapper.  It takes ``q`` as ``(B, Tq,
  H, hd)`` and ``k``, ``v`` as ``(B, Tk, KV, hd)``, the reference's public
  layout, unpadded: the kernel reads them through their strides and masks
  the ragged edge itself, so the padding and the ``(B, H, T, hd)``
  transpose the reference makes for the TPU are not copied here.  A head
  dim between the kernel's templates (zamba2's 80) is zero-padded to the
  next one (:func:`template_head_dim`) and the output sliced back: the
  zero columns add exact zeros to every score and give zero output
  columns, and the caller's ``scale`` (of the true head dim) is kept.  A CPU
  tensor takes the twin; a CUDA tensor launches the kernel or raises, with
  no fallback.  Each launch adds one to ``LAUNCHES["flash_attention"]``.
  It has no backward (the reference's kernel has none either), so it
  raises when autograd would have to differentiate it.
* :func:`flash_attention_fwd_twin` is the plain PyTorch version: the
  reference's online softmax in f32 over the same logical ``bk`` key
  blocks, one block at a time, every ``bq`` query block at once (query
  rows never interact, so the ``bq`` partition does not change a row's
  arithmetic).  It pads the keys with zeros as the reference does.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import CudaLibrary

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (64, 128)  # the kernel's templates
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_BK = 128  # longest logical key block the kernel stages
NEG = -1e30

# Launches since the last reset_launches(); only the CUDA path counts.
LAUNCHES = {"flash_attention": 0}
# Callables ``rec(name, q, k, v, out)`` told of every launch (the contract
# checker's launch record); empty unless a checker is recording.
LAUNCH_RECORDERS: list = []


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def template_head_dim(hd: int) -> int:
    """The narrowest of the kernel's head-dim templates that holds ``hd``
    (the width the wrapper zero-pads q, k and v to)."""
    for width in HEAD_DIMS:
        if hd <= width:
            return width
    raise ValueError(f"the CUDA kernel takes head dims up to {HEAD_DIMS[-1]}, got {hd}")


# ---------------------------------------------------------------------------
# The plain twin
# ---------------------------------------------------------------------------
def flash_attention_fwd_twin(
    q: torch.Tensor,  # (B, Tq, H, hd)
    k: torch.Tensor,  # (B, Tk, KV, hd)
    v: torch.Tensor,  # (B, Tk, KV, hd)
    *,
    scale: float,
    causal: bool,
    q_offset: int,
    kv_valid: int,
    n_rep: int,
    bq: int,
    bk: int,
    round_p: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_attention_fwd`; ``(B, Tq, H,
    hd)`` in ``q.dtype``.  Reference:
    ``repro.kernels.flash_attention.kernel:_kernel`` over its grid.
    ``round_p`` rounds P to one bf16 term before P.V: the negative control
    of the bf16 gate (``ref.oracle_and_bound``), not a served path."""
    b, tq, h, hd = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    _check_args(h, kvh, n_rep, bq, bk)
    tq_p, tk_p = _round_up(tq, bq), _round_up(tk, bk)
    dev = q.device
    f32 = torch.float32
    qf = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, tq_p - tq)).transpose(1, 2).to(f32) * scale
    kf = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, tk_p - tk)).transpose(1, 2).to(f32)
    vf = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, tk_p - tk)).transpose(1, 2).to(f32)
    if n_rep > 1:  # query head h reads KV head h // n_rep
        kf = torch.repeat_interleave(kf, n_rep, dim=1)
        vf = torch.repeat_interleave(vf, n_rep, dim=1)
    q_pos = q_offset + torch.arange(tq_p, device=dev)
    m = torch.full((b, h, tq_p), NEG, dtype=f32, device=dev)
    l_sum = torch.zeros((b, h, tq_p), dtype=f32, device=dev)
    acc = torch.zeros((b, h, tq_p, hd), dtype=f32, device=dev)
    for kk in range(tk_p // bk):
        sl = slice(kk * bk, (kk + 1) * bk)
        s = torch.matmul(qf, kf[:, :, sl].transpose(-1, -2))  # (B, H, Tq_p, bk)
        kv_pos = kk * bk + torch.arange(bk, device=dev)
        valid = (kv_pos < kv_valid)[None, :].expand(tq_p, bk)
        if causal:
            valid = valid & (kv_pos[None, :] <= q_pos[:, None])
        s = s.masked_fill(~valid, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_sum = l_sum * corr + p.sum(dim=-1)
        pv = p.to(torch.bfloat16).to(f32) if round_p else p
        acc = acc * corr[..., None] + torch.matmul(pv, vf[:, :, sl])
        m = m_new
    out = (acc / torch.clamp(l_sum, min=1e-30)[..., None]).to(q.dtype)
    return out[:, :, :tq].transpose(1, 2)


def _check_args(h, kvh, n_rep, bq, bk) -> None:
    if h != kvh * n_rep:
        raise ValueError(f"H={h} query heads do not split into KV={kvh} heads x n_rep={n_rep}")
    if bq < 1 or bk < 1:
        raise ValueError(f"block sizes must be positive, got bq={bq}, bk={bk}")


# ---------------------------------------------------------------------------
# Build and bind the CUDA source
# ---------------------------------------------------------------------------
def _bind(lib) -> None:
    fn = lib.flash_attention_launch
    vp, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    fn.argtypes = [
        vp, vp, vp, vp, i, i,  # q, k, v, out, dtype, hd
        ll, ll, ll, ll, ll, ll, ll, ll, ll, ll, ll, ll,  # (b, t, h) strides of q, k, v, out
        i, i, i, i, i,  # B, H, KV, Tq, Tk
        f, i, i, i, i, vp,  # scale, causal, q_offset, kv_valid, bk, stream
    ]
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary(SOURCE, _bind)


# ---------------------------------------------------------------------------
# The wrapper: twin on CPU tensors, kernel on CUDA tensors, nothing else
# ---------------------------------------------------------------------------
def flash_attention_fwd(
    q: torch.Tensor,  # (B, Tq, H, hd)
    k: torch.Tensor,  # (B, Tk, KV, hd)
    v: torch.Tensor,  # (B, Tk, KV, hd)
    *,
    scale: float,
    causal: bool,
    q_offset: int,
    kv_valid: int,
    n_rep: int,
    bq: int,
    bk: int,
) -> torch.Tensor:
    """Attention forward, ``(B, Tq, H, hd)`` in ``q.dtype``.  Reference:
    ``repro.kernels.flash_attention.kernel:flash_attention_pallas`` (which
    takes the padded ``(B, H, T, hd)`` layout; here the kernel masks the
    ragged edge; a head dim between the templates is zero-padded, module
    docstring).  ``bq`` is the logical query block: rows do not interact,
    so the kernels' CTAs cover their own row tiles (32 query rows of one
    head in f32; 64 rows of one KV head's packed query heads in bf16).
    The bf16 kernel reads k and v by TMA, so their views must be 16-byte
    aligned with 16-byte strides (the C entry point's code -7 otherwise)."""
    args = dict(scale=scale, causal=causal, q_offset=q_offset, kv_valid=kv_valid,
                n_rep=n_rep, bq=bq, bk=bk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention has no backward (neither has the reference's "
            "kernel); train with attn_impl='chunked' or run under torch.no_grad()"
        )
    if q.device.type == "cpu":
        return flash_attention_fwd_twin(q, k, v, **args)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd runs on CPU (twin) or CUDA, not {q.device}")
    b, tq, h, hd = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    _check_args(h, kvh, n_rep, bq, bk)
    width = template_head_dim(hd)
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"the CUDA kernel takes {tuple(DTYPE_CODES)}, got {q.dtype}")
    if bk > MAX_BK:
        raise ValueError(f"the CUDA kernel takes bk <= {MAX_BK}, got {bk}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    for t, name, shape in ((q, "q", (b, tq, h, hd)), (k, "k", (b, tk, kvh, hd)), (v, "v", (b, tk, kvh, hd))):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, expected {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {q.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have a contiguous head dim (stride 1), got {t.stride()}")
    if width != hd:
        q, k, v = (torch.nn.functional.pad(t, (0, width - hd)) for t in (q, k, v))
    out = torch.empty((b, tq, h, width), dtype=q.dtype, device=q.device)
    rc = LIBRARY.load().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), DTYPE_CODES[q.dtype], width,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        b, h, kvh, tq, tk,
        float(scale), int(causal), int(q_offset), int(kv_valid), int(bk),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed with code {rc}")
    LAUNCHES["flash_attention"] += 1
    for rec in LAUNCH_RECORDERS:
        rec("flash_attention", q, k, v, out)
    return out if width == hd else out[..., :hd]
