"""Untiled oracle of the photonic GEMM, in PyTorch (the port's ``ref`` and
``exact`` backends).

Port of ``repro.kernels.photonic_gemm.ref``: signed-magnitude bit slices,
DPE-size psum chunks, the analog channel per slice-pair pass with the
oracle's flat noise stream (``fold_seed(seed, pass)`` over the whole
``(R, G, C)`` psum array), shift-add recombination.  Integer products run
through :func:`repro_torch.noise.channel.int_dot` (float64, exact), so the
oracle runs on CUDA tensors too.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.noise.channel import ChannelModel, analog_pass_psums, int_dot
from repro_torch.noise.stages import UInt, fold_seed


def slice_decompose(q: torch.Tensor, slice_bits: int, num_slices: int) -> List[torch.Tensor]:
    """Signed-magnitude slices (int32): ``sum_s out[s] << (slice_bits*s) == q``.
    Reference: ``repro.kernels.photonic_gemm.ref:slice_decompose``."""
    qi = q.to(torch.int32)
    sgn = torch.sign(qi)
    mag = torch.abs(qi)
    mask = (1 << slice_bits) - 1
    return [sgn * ((mag >> (slice_bits * s)) & mask) for s in range(num_slices)]


def photonic_gemm_ref(
    xq: torch.Tensor,  # (R, K) int
    wq: torch.Tensor,  # (K, C) int
    *,
    slice_bits: int = 4,
    num_slices: int = 2,
    n_chunk: int = 128,
    adc_bits: Optional[int] = None,
    channel: Optional[ChannelModel] = None,
    seed: Optional[UInt] = None,
    columns: Optional[Tuple[int, int]] = None,
    rows: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Reference int32 GEMM through the DPU datapath.  Reference:
    ``repro.kernels.photonic_gemm.ref:photonic_gemm_ref``.  ``columns =
    (origin, total)``: ``wq`` is the columns from ``origin`` of a
    ``total``-column weight, whose noise stream its columns keep; ``rows =
    (origin, total)`` likewise makes ``xq`` a block of a ``total``-row
    operand's rows."""
    r, k = xq.shape
    _, c = wq.shape
    analog = channel is not None and channel.analog
    if analog and channel.detector_sigma_lsb > 0.0 and seed is None:
        raise ValueError("channel with detector noise requires a seed")
    if channel is not None and channel.adc_bits is not None:
        adc_bits = channel.adc_bits
    pad = (-k) % n_chunk
    if pad:
        xq = torch.nn.functional.pad(xq, (0, pad))
        wq = torch.nn.functional.pad(wq, (0, 0, 0, pad))
    kp = k + pad
    chunks = kp // n_chunk

    x_sl = slice_decompose(xq, slice_bits, num_slices)
    w_sl = slice_decompose(wq, slice_bits, num_slices)

    out = torch.zeros((r, c), dtype=torch.int64, device=xq.device)
    for si in range(num_slices):
        xs = x_sl[si].reshape(r, chunks, n_chunk)
        for ti in range(num_slices):
            ws = w_sl[ti].reshape(chunks, n_chunk, c)
            shift = slice_bits * (si + ti)
            if analog:
                pass_seed = fold_seed(seed if seed is not None else 0, si * num_slices + ti)
                psum = analog_pass_psums(xs, ws, channel, pass_seed, columns, rows)
                out = out + (psum.to(torch.int64).sum(dim=1) << shift)
            else:
                out = out + (_digital_pass(xs, ws, adc_bits) << shift)
    return out.to(torch.int32)


# Elements of one (G, rows, C) psum block of the digital pass: rows are
# taken in blocks so a wide GEMM (a 102,400-column LM head over hundreds
# of rows) never holds its whole float64 psum array at once.
_PSUM_BLOCK = 1 << 28


def _digital_pass(xs: torch.Tensor, ws: torch.Tensor, adc_bits: Optional[int]) -> torch.Tensor:
    """One slice-pair pass without an analog stage: the per-chunk psums
    (saturated to ``adc_bits``), summed over chunks, int64 ``(R, C)``.
    Row blocks change no value: each row's psums are its own."""
    r, g, _ = xs.shape
    c = ws.shape[-1]
    w64 = ws.to(torch.float64)
    rb = max(1, _PSUM_BLOCK // max(1, g * c))
    parts = []
    for r0 in range(0, r, rb):
        psum = torch.matmul(xs[r0 : r0 + rb].permute(1, 0, 2).to(torch.float64), w64).to(torch.int64)
        if adc_bits is not None:
            lim = 2 ** (adc_bits - 1) - 1
            psum = torch.clamp(psum, -lim, lim)
        parts.append(psum.sum(dim=0))
    return torch.cat(parts, dim=0)


def exact_int_gemm(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The ideal integer GEMM.  Reference:
    ``repro.kernels.photonic_gemm.ref:exact_int_gemm``."""
    return int_dot(xq, wq).to(torch.int32)
