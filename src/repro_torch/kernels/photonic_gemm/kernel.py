"""The photonic GEMM kernels: CUDA C++ for Hopper, their plain twin, the loader.

Ports of the reference's two Pallas TPU kernels,
``repro.kernels.photonic_gemm.kernel:photonic_gemm_fused_pallas`` (the fused
hot path: optional f32 quantize prologue, bit-sliced psum-chunked analog
datapath, rescale/bias/activation epilogue) and
``repro.kernels.photonic_gemm.kernel:photonic_gemm_pallas`` (the int8 ->
int32 core).  Both run one CUDA template, ``csrc/photonic_gemm.cu``; its
source note says what bounds it on the card.

* :func:`photonic_gemm_fused` / :func:`photonic_gemm` are the wrappers.  A
  CPU tensor takes the plain twin; a CUDA tensor launches the kernel or
  raises — there is no fallback.  Each launch adds one to
  :data:`LAUNCHES` under the kernel's name.  ``rows`` is the live row
  count: the kernel computes and writes rows ``[0, rows)`` and leaves the
  padding rows of its output unwritten (the twin computes every row).
* :func:`plan_launch` is the host-side launch plan: the CTA's row count
  and how many CTAs split each output tile's contraction, so that the
  grid covers the card's SMs when there are that many chunk-tiles.  The
  split CTAs meet in a cached int32 workspace that the kernel leaves
  zeroed (:func:`_workspace`).
* :func:`photonic_gemm_fused_twin` / :func:`photonic_gemm_twin` are the
  plain PyTorch versions.  They mirror the reference's *logical* Pallas
  tiling and noise-stream ids (tile seed ``fold_seed(seed, i, j, kk)``,
  chunk seed ``fold_seed(tile_seed, pass, g)``, element counter
  ``row_in_tile * tile_c + col_in_tile``, ``valid_chunks`` masking), as
  Pallas interpret mode does for the reference, vectorized over tiles.
* :data:`LIBRARY` builds the CUDA source with ``nvcc`` at first use into
  ``build/repro_torch/`` (keyed by a hash of the source and flags) and
  binds its plain C entry point with ``ctypes``
  (:mod:`repro_torch.kernels._build`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels._build import CudaLibrary
from repro_torch.kernels.photonic_gemm.epilogue import (
    EpilogueSpec,
    apply_epilogue,
    quantize_tile,
)
from repro_torch.kernels.photonic_gemm.ref import slice_decompose
from repro_torch.noise.channel import int_dot
from repro_torch.noise.stages import (
    UInt,
    f32,
    fold_seed,
    gaussian_from_ctr,
    neighbor_sum,
)

SOURCE = Path(__file__).resolve().parent / "csrc" / "photonic_gemm.cu"
ACTIVATION_CODES = {None: 0, "gelu": 1, "silu": 2}
TILE_C = 128  # a CTA's columns; the CUDA kernel takes a logical tile_c that is a multiple of it
CTA_ROWS = (8, 64)  # the kernel's CTA row counts; tile_r must be a multiple of 8
MAX_CHUNK = 256  # longest n_chunk the kernel stages in shared memory
K_STEP = 64  # the ideal path's K step, its unit of the contraction split
SMEM_LIMIT = 227 * 1024 - 128  # dynamic shared memory a CTA may take (H100)

# Launches per kernel since the last reset_launches(); only the CUDA path
# counts (the twin is not a launch).
LAUNCHES = {"photonic_gemm_fused": 0, "photonic_gemm": 0}
# Callables ``rec(name, x, wq, out, rows)`` told of every launch (the
# contract checker's launch record); empty unless a checker is recording.
LAUNCH_RECORDERS: list = []


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _analog(noise_sigma, filter_alpha, intermod_eps, crossweight_eps) -> bool:
    return (
        noise_sigma > 0.0
        or filter_alpha > 0.0
        or intermod_eps > 0.0
        or crossweight_eps > 0.0
    )


# ---------------------------------------------------------------------------
# The plain twin
# ---------------------------------------------------------------------------
# Elements of the twin's per-chunk psum array (G, R, C) above which it
# works in column blocks, so a wide analog GEMM (a 102,400-column LM head)
# stays within the card's memory.
_TWIN_BLOCK = 1 << 28

def _accumulate_twin(
    x: torch.Tensor,  # (R, K) int
    w: torch.Tensor,  # (K, C) int
    seed: Optional[UInt],
    *,
    slice_bits: int,
    num_slices: int,
    n_chunk: int,
    adc_bits: Optional[int],
    noise_sigma: float,
    filter_alpha: float,
    intermod_eps: float,
    crossweight_eps: float,
    valid_chunks: Optional[int],
    tile_r: int,
    tile_c: int,
    tile_k: int,
    col0: int = 0,
) -> torch.Tensor:
    """The reference ``_accumulate`` summed over the whole K grid axis, for
    every logical tile at once; int64 ``(R, C)``.  ``w`` may be the columns
    from ``col0`` (a multiple of ``tile_c``) of a wider weight: the noise
    stream ids are those of the whole.  A call whose per-chunk psum array
    would pass ``_TWIN_BLOCK`` elements runs in column blocks of whole
    tiles (columns are independent, so the values are the same)."""
    analog = _analog(noise_sigma, filter_alpha, intermod_eps, crossweight_eps)
    if not analog and adc_bits is None:
        # Ideal ADC: the shift-added slice passes equal the exact product.
        return int_dot(x, w)
    r, k = x.shape
    c = w.shape[1]
    dev = x.device
    chunks = tile_k // n_chunk
    g_tot = k // n_chunk
    cb = max(1, _TWIN_BLOCK // (g_tot * r * tile_c)) * tile_c
    if cb < c:
        kw = dict(slice_bits=slice_bits, num_slices=num_slices, n_chunk=n_chunk, adc_bits=adc_bits,
                  noise_sigma=noise_sigma, filter_alpha=filter_alpha, intermod_eps=intermod_eps,
                  crossweight_eps=crossweight_eps, valid_chunks=valid_chunks, tile_r=tile_r,
                  tile_c=tile_c, tile_k=tile_k)
        return torch.cat([_accumulate_twin(x, w[:, c0 : c0 + cb], seed, col0=col0 + c0, **kw)
                          for c0 in range(0, c, cb)], dim=1)
    lim = 2 ** (adc_bits - 1) - 1 if adc_bits is not None else None
    x_sl = slice_decompose(x, slice_bits, num_slices)
    w_sl = slice_decompose(w, slice_bits, num_slices)

    if noise_sigma > 0.0:
        rows = torch.arange(r, device=dev)
        cols = torch.arange(c, device=dev)
        g = torch.arange(g_tot, device=dev)
        ii = torch.arange(r // tile_r, device=dev)[:, None, None]
        jj = (torch.arange(c // tile_c, device=dev) + col0 // tile_c)[None, :, None]
        kk = torch.arange(k // tile_k, device=dev)[None, None, :]
        tile_seed = fold_seed(seed, ii, jj, kk)  # (I, J, KK)
        # Each global chunk g sits in K-tile g // chunks, at g % chunks there.
        chunk_tile = tile_seed[:, :, g // chunks].permute(2, 0, 1)  # (G, I, J)
        g_local = (g % chunks)[:, None, None]
        ctr = ((rows % tile_r)[:, None] * tile_c + (cols % tile_c)[None, :])[None]
        live = None
        if valid_chunks is not None:
            live = (g < valid_chunks).to(torch.float32)[:, None, None]
        sigma = f32(noise_sigma, dev)

    acc = torch.zeros((r, c), dtype=torch.int64, device=dev)
    for si in range(num_slices):
        xs = x_sl[si].reshape(r, g_tot, n_chunk).permute(1, 0, 2)  # (G, R, N)
        for t in range(num_slices):
            ws = w_sl[t].reshape(g_tot, n_chunk, c)  # (G, N, C)
            psum = int_dot(xs, ws)  # (G, R, C)
            if analog:
                a = psum.to(torch.float32)
                if intermod_eps > 0.0:
                    im = int_dot(neighbor_sum(xs, axis=2), ws).to(torch.float32)
                    a = a + f32(intermod_eps, dev) * im
                if crossweight_eps > 0.0:
                    cw = int_dot(xs, neighbor_sum(ws, axis=1)).to(torch.float32)
                    a = a + f32(crossweight_eps, dev) * cw
                if filter_alpha > 0.0:
                    a = a * f32(1.0 - filter_alpha, dev)
                if noise_sigma > 0.0:
                    base = fold_seed(chunk_tile, si * num_slices + t, g_local)
                    base = base.index_select(1, rows // tile_r)  # (G, R, J)
                    base = base.index_select(2, cols // tile_c)  # (G, R, C)
                    z = gaussian_from_ctr(base, ctr)
                    if live is not None:
                        z = z * live
                    a = a + sigma * z
                psum = torch.round(a).to(torch.int64)
            if lim is not None:
                psum = torch.clamp(psum, -lim, lim)
            acc = acc + (psum.sum(dim=0) << (slice_bits * (si + t)))
    return acc


def _check_tiles(r, k, c, tile_r, tile_c, tile_k, n_chunk):
    if r % tile_r or c % tile_c or k % tile_k:
        raise ValueError(
            f"shapes (R, K, C)=({r}, {k}, {c}) are not multiples of the tiles "
            f"(tile_r, tile_k, tile_c)=({tile_r}, {tile_k}, {tile_c})"
        )
    if tile_k % n_chunk:
        raise ValueError(f"tile_k={tile_k} is not a multiple of n_chunk={n_chunk}")


def photonic_gemm_twin(
    xq: torch.Tensor,
    wq: torch.Tensor,
    seed: Optional[UInt] = None,
    *,
    slice_bits: int = 4,
    num_slices: int = 2,
    n_chunk: int = 128,
    adc_bits: Optional[int] = None,
    noise_sigma: float = 0.0,
    filter_alpha: float = 0.0,
    intermod_eps: float = 0.0,
    crossweight_eps: float = 0.0,
    valid_chunks: Optional[int] = None,
    tile_r: int = 128,
    tile_c: int = 128,
    tile_k: int = 512,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`photonic_gemm`; int32 ``(R, C)``.
    Reference: ``repro.kernels.photonic_gemm.kernel:photonic_gemm_pallas``."""
    r, k = xq.shape
    c = wq.shape[1]
    _check_tiles(r, k, c, tile_r, tile_c, tile_k, n_chunk)
    if noise_sigma > 0.0 and seed is None:
        raise ValueError("noise_sigma > 0 requires a seed")
    acc = _accumulate_twin(
        xq, wq, seed, slice_bits=slice_bits, num_slices=num_slices,
        n_chunk=n_chunk, adc_bits=adc_bits, noise_sigma=noise_sigma,
        filter_alpha=filter_alpha, intermod_eps=intermod_eps,
        crossweight_eps=crossweight_eps, valid_chunks=valid_chunks,
        tile_r=tile_r, tile_c=tile_c, tile_k=tile_k,
    )
    return acc.to(torch.int32)


def photonic_gemm_fused_twin(
    x: torch.Tensor,
    wq: torch.Tensor,
    x_scale: torch.Tensor,
    w_scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    seed: Optional[UInt] = None,
    *,
    operand_bits: int = 8,
    activation: Optional[str] = None,
    slice_bits: int = 4,
    num_slices: int = 2,
    n_chunk: int = 128,
    adc_bits: Optional[int] = None,
    noise_sigma: float = 0.0,
    filter_alpha: float = 0.0,
    intermod_eps: float = 0.0,
    crossweight_eps: float = 0.0,
    valid_chunks: Optional[int] = None,
    tile_r: int = 128,
    tile_c: int = 128,
    tile_k: int = 512,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`photonic_gemm_fused`; f32 ``(R, C)``.
    Reference: ``repro.kernels.photonic_gemm.kernel:photonic_gemm_fused_pallas``."""
    r, k = x.shape
    c = wq.shape[1]
    _check_tiles(r, k, c, tile_r, tile_c, tile_k, n_chunk)
    if noise_sigma > 0.0 and seed is None:
        raise ValueError("noise_sigma > 0 requires a seed")
    xs = x_scale.to(torch.float32).reshape(())
    if x.is_floating_point():
        xi = quantize_tile(x, xs, float(2 ** (operand_bits - 1) - 1))
    else:
        xi = x
    acc = _accumulate_twin(
        xi, wq, seed, slice_bits=slice_bits, num_slices=num_slices,
        n_chunk=n_chunk, adc_bits=adc_bits, noise_sigma=noise_sigma,
        filter_alpha=filter_alpha, intermod_eps=intermod_eps,
        crossweight_eps=crossweight_eps, valid_chunks=valid_chunks,
        tile_r=tile_r, tile_c=tile_c, tile_k=tile_k,
    ).to(torch.int32)
    spec = EpilogueSpec(bias=bias is not None, activation=activation)
    return apply_epilogue(acc, xs, w_scale.reshape(-1), bias, spec)


# ---------------------------------------------------------------------------
# The launch plan (host side; the kernel mirrors unit_range)
# ---------------------------------------------------------------------------
SPLIT_WAVES = {True: 1, False: 8}  # CTAs per SM the split aims for: ideal path, slice path


def neighbour_tiles(xtalk: bool, slice_bits: int) -> int:
    """The slice path's crosstalk neighbour tiles (``neighbour_tiles`` in
    the CUDA source): none without crosstalk, the int8 neighbour sum for
    slices of at most 6 bits, else the two neighbours apart (their sum
    would overflow int8), whose two products the kernel adds in int32."""
    return (2 if slice_bits > 6 else 1) if xtalk else 0


def slice_smem_bytes(bn: int, n_chunk: int, num_slices: int, nb: int) -> int:
    """Shared memory of the kernel's slice path (``slice_smem_bytes`` in the
    CUDA source): the raw weight ring, the weight slice and its ``nb``
    neighbour tiles and the x slices; 8-row CTAs add the int32 psum tiles,
    64-row CTAs need room for their int32 sums at the end."""
    npad = -(-n_chunk // 32) * 32
    base = 2 * n_chunk * TILE_C + (1 + nb) * TILE_C * (npad + 4) + num_slices * bn * (npad + 16)
    acc = bn * (TILE_C + 4) * 4
    return base + (1 + (nb > 0)) * acc if bn == 8 else max(base, acc)


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one call is cut into CTAs.  A CTA covers ``bn`` rows by one
    128-column tile and the units ``unit_range(s)`` of the contraction:
    64-wide K steps on the ideal path, the logical ``(kk, g)`` chunks (in K
    order, ``kk * chunks + g``) on the slice path."""

    ideal: bool
    bn: int
    units: int
    row_tiles: int
    col_tiles: int
    n_split: int

    @property
    def ctas(self) -> int:
        return self.row_tiles * self.col_tiles * self.n_split

    def unit_range(self, s: int) -> range:
        return range(s * self.units // self.n_split, (s + 1) * self.units // self.n_split)


def plan_launch(
    rows: int,
    rp: int,
    kp: int,
    cp: int,
    *,
    tile_r: int,
    n_chunk: int,
    num_slices: int,
    ideal: bool,
    nb: int = 0,
    sms: int = 132,
) -> LaunchPlan:
    """The launch plan of a ``(rp, kp) x (kp, cp)`` call with ``rows`` live
    rows.  64-row CTAs where the rows allow (more than 8 live, and on the
    slice path a logical row tile they divide and shared memory to hold
    them), else 8.  When the output tiles are fewer than ``waves * sms``
    (``SPLIT_WAVES``: one CTA per SM on the byte-bound ideal path, eight
    on the draw-bound slice path), each is split along the contraction into
    ``ceil(waves * sms / tiles)`` CTAs (at most one per unit), so the grid
    covers the SMs wherever there are that many unit-tiles."""
    units = kp // K_STEP if ideal else kp // n_chunk
    wide = rows > 8 and rp % 64 == 0 and (
        ideal or (tile_r % 64 == 0 and slice_smem_bytes(64, n_chunk, num_slices, nb) <= SMEM_LIMIT))
    bn = 64 if wide else 8
    row_tiles = -(-rows // bn)
    col_tiles = cp // TILE_C
    tiles = row_tiles * col_tiles
    target = SPLIT_WAVES[ideal] * sms
    n_split = 1 if tiles >= target else min(units, -(-target // tiles))
    return LaunchPlan(ideal, bn, units, row_tiles, col_tiles, n_split)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_WORKSPACES: dict = {}


def _workspace(device: torch.device, sms: int):
    """The split-K workspace (int32, 64 x 128 per output tile for up to
    ``waves * sms`` tiles: the plan splits only when there are fewer) and tickets of
    one device.  Zeroed once here; the kernel leaves them zero, so replays of
    a captured CUDA graph find them clean.  Calls that share them must not
    run at the same time: the port issues its GEMMs on one stream (or one
    graph) in order."""
    key = device.index
    ws = _WORKSPACES.get(key)
    if ws is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("photonic_gemm: call once on this device before capturing a CUDA graph "
                               "(the split workspace is allocated at first use)")
        tiles = max(SPLIT_WAVES.values()) * sms
        ws = (torch.zeros(tiles * 64 * TILE_C, dtype=torch.int32, device=device),
              torch.zeros(tiles, dtype=torch.int32, device=device))
        _WORKSPACES[key] = ws
    return ws


# ---------------------------------------------------------------------------
# Build and bind the CUDA source
# ---------------------------------------------------------------------------
def _bind(lib) -> None:
    fn = lib.photonic_gemm_launch
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [
        vp, i, vp, vp, vp, vp, vp, vp, i,  # x, x_f32, w, x_scale, w_scale, bias, seed, out, fused
        i, i, i, i, i, i, i, i,  # R, K, C, live_rows, tile_r, tile_c, tile_k, n_chunk
        i, i, i, i,  # slice_bits, num_slices, operand_bits, adc_bits
        f, i, f, f, f,  # sigma, use_filter, filter_scale, eps_im, eps_cw
        i, i, i, i, i,  # valid_chunks, activation, bn, ideal, n_split
        vp, vp, vp,  # ws_acc, tickets, stream
    ]
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary(SOURCE, _bind)


# ---------------------------------------------------------------------------
# Wrappers: twin on CPU tensors, kernel on CUDA tensors, nothing else
# ---------------------------------------------------------------------------
def seed_words(seeds: torch.Tensor) -> torch.Tensor:
    """uint32 seeds (int64 images) as int32 words of the same bit pattern,
    the form the kernel reads; both wrappers take a one-element slice of
    the result as a seed as it is (the twin reads it through ``_u32``)."""
    s = seeds.to(torch.int64) & 0xFFFFFFFF
    return torch.where(s >= 2**31, s - 2**32, s).to(torch.int32)


def _seed_tensor(seed: UInt, device) -> torch.Tensor:
    """A uint32 seed as the kernel's one-element int32 device buffer (the
    bit pattern is what the kernel reads)."""
    if isinstance(seed, torch.Tensor):
        if seed.dtype == torch.int32 and seed.numel() == 1 and seed.device == device:
            return seed.reshape(1)
        return seed_words(seed.to(device).reshape(1))
    return seed_words(torch.full((1,), int(seed) & 0xFFFFFFFF, dtype=torch.int64, device=device))


def _data_ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _require(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(name, fused, x, wq, x_scale, w_scale, bias, seed, out, rows, *, operand_bits,
            activation, slice_bits, num_slices, n_chunk, adc_bits, noise_sigma,
            filter_alpha, intermod_eps, crossweight_eps, valid_chunks, tile_r,
            tile_c, tile_k):
    r, k = x.shape
    c = wq.shape[1]
    rows = r if rows is None else int(rows)
    if tile_c % TILE_C:
        raise ValueError(f"the CUDA kernel takes tile_c a multiple of {TILE_C}, got {tile_c}")
    if tile_r % CTA_ROWS[0]:
        raise ValueError(f"the CUDA kernel takes tile_r a multiple of {CTA_ROWS[0]}, got {tile_r}")
    if n_chunk > MAX_CHUNK:
        raise ValueError(f"the CUDA kernel takes n_chunk <= {MAX_CHUNK}, got {n_chunk}")
    if not 1 <= rows <= r:
        raise ValueError(f"rows={rows} live rows outside [1, {r}]")
    for t, nm in ((x, "x"), (wq, "wq"), (out, "out")):
        if t.data_ptr() % 16:
            raise ValueError(f"{nm} must be 16-byte aligned")
    xtalk = intermod_eps > 0.0 or crossweight_eps > 0.0
    ideal = (not _analog(noise_sigma, filter_alpha, intermod_eps, crossweight_eps)
             and adc_bits is None and k % K_STEP == 0)
    if not ideal and slice_bits > 8:
        raise ValueError(f"the CUDA kernel's slice path takes slice_bits <= 8, got {slice_bits}: "
                         f"its slices are int8")
    dev = x.device if x.device.index is not None else torch.device("cuda", torch.cuda.current_device())
    sms = _sm_count(dev.index)
    plan = plan_launch(rows, r, k, c, tile_r=tile_r, n_chunk=n_chunk, num_slices=num_slices,
                       ideal=ideal, nb=neighbour_tiles(xtalk, slice_bits), sms=sms)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws_acc = tickets = None
    if plan.n_split > 1:
        ws_acc, tickets = _workspace(dev, sms)
    seed_t = None if seed is None else _seed_tensor(seed, dev)
    rc = LIBRARY.load().photonic_gemm_launch(
        _data_ptr(x), int(x.is_floating_point()), _data_ptr(wq), _data_ptr(x_scale),
        _data_ptr(w_scale), _data_ptr(bias), _data_ptr(seed_t), _data_ptr(out), int(fused),
        r, k, c, rows, tile_r, tile_c, tile_k, n_chunk,
        slice_bits, num_slices, operand_bits, -1 if adc_bits is None else adc_bits,
        float(noise_sigma), int(filter_alpha > 0.0), float(1.0 - filter_alpha),
        float(intermod_eps), float(crossweight_eps),
        -1 if valid_chunks is None else valid_chunks, ACTIVATION_CODES[activation],
        plan.bn, int(plan.ideal), plan.n_split, _data_ptr(ws_acc), _data_ptr(tickets), stream,
    )
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with code {rc}")
    LAUNCHES[name] += 1
    for rec in LAUNCH_RECORDERS:
        rec(name, x, wq, out, rows)
    return out


def photonic_gemm(
    xq: torch.Tensor,  # (R, K) int8
    wq: torch.Tensor,  # (K, C) int8
    seed: Optional[UInt] = None,
    *,
    slice_bits: int = 4,
    num_slices: int = 2,
    n_chunk: int = 128,
    adc_bits: Optional[int] = None,
    noise_sigma: float = 0.0,
    filter_alpha: float = 0.0,
    intermod_eps: float = 0.0,
    crossweight_eps: float = 0.0,
    valid_chunks: Optional[int] = None,
    tile_r: int = 128,
    tile_c: int = 128,
    tile_k: int = 512,
    rows: Optional[int] = None,
) -> torch.Tensor:
    """Integer photonic GEMM, int8 x int8 -> int32 ``(R, C)``.  Reference:
    ``repro.kernels.photonic_gemm.kernel:photonic_gemm_pallas``.  ``rows``:
    the live rows the CUDA kernel computes (default all)."""
    stages = dict(
        slice_bits=slice_bits, num_slices=num_slices, n_chunk=n_chunk,
        adc_bits=adc_bits, noise_sigma=noise_sigma, filter_alpha=filter_alpha,
        intermod_eps=intermod_eps, crossweight_eps=crossweight_eps,
        valid_chunks=valid_chunks, tile_r=tile_r, tile_c=tile_c, tile_k=tile_k,
    )
    if xq.device.type == "cpu":
        return photonic_gemm_twin(xq, wq, seed, **stages)
    if xq.device.type != "cuda":
        raise ValueError(f"photonic_gemm runs on CPU (twin) or CUDA, not {xq.device}")
    r, k = xq.shape
    c = wq.shape[1]
    _check_tiles(r, k, c, tile_r, tile_c, tile_k, n_chunk)
    if noise_sigma > 0.0 and seed is None:
        raise ValueError("noise_sigma > 0 requires a seed")
    _require(xq, "xq", torch.int8, (r, k), xq.device)
    _require(wq, "wq", torch.int8, (k, c), xq.device)
    out = torch.empty((r, c), dtype=torch.int32, device=xq.device)
    return _launch("photonic_gemm", False, xq, wq, None, None, None, seed, out, rows,
                   operand_bits=8, activation=None, **stages)


def photonic_gemm_fused(
    x: torch.Tensor,  # (R, K) f32 activations, or pre-quantized int8
    wq: torch.Tensor,  # (K, C) int8
    x_scale: torch.Tensor,  # (1,) or () f32
    w_scale: torch.Tensor,  # (C,) f32
    bias: Optional[torch.Tensor] = None,  # (C,) f32
    seed: Optional[UInt] = None,
    *,
    operand_bits: int = 8,
    activation: Optional[str] = None,
    slice_bits: int = 4,
    num_slices: int = 2,
    n_chunk: int = 128,
    adc_bits: Optional[int] = None,
    noise_sigma: float = 0.0,
    filter_alpha: float = 0.0,
    intermod_eps: float = 0.0,
    crossweight_eps: float = 0.0,
    valid_chunks: Optional[int] = None,
    tile_r: int = 128,
    tile_c: int = 128,
    tile_k: int = 512,
    rows: Optional[int] = None,
) -> torch.Tensor:
    """The fused hot path, [quantize] -> integer GEMM -> epilogue, f32
    ``(R, C)``.  Reference:
    ``repro.kernels.photonic_gemm.kernel:photonic_gemm_fused_pallas``.
    ``rows``: the live rows the CUDA kernel computes (default all)."""
    stages = dict(
        slice_bits=slice_bits, num_slices=num_slices, n_chunk=n_chunk,
        adc_bits=adc_bits, noise_sigma=noise_sigma, filter_alpha=filter_alpha,
        intermod_eps=intermod_eps, crossweight_eps=crossweight_eps,
        valid_chunks=valid_chunks, tile_r=tile_r, tile_c=tile_c, tile_k=tile_k,
    )
    if x.device.type == "cpu":
        return photonic_gemm_fused_twin(
            x, wq, x_scale, w_scale, bias, seed,
            operand_bits=operand_bits, activation=activation, **stages,
        )
    if x.device.type != "cuda":
        raise ValueError(f"photonic_gemm_fused runs on CPU (twin) or CUDA, not {x.device}")
    r, k = x.shape
    c = wq.shape[1]
    _check_tiles(r, k, c, tile_r, tile_c, tile_k, n_chunk)
    if noise_sigma > 0.0 and seed is None:
        raise ValueError("noise_sigma > 0 requires a seed")
    if activation not in ACTIVATION_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    if operand_bits > 8:
        raise ValueError("the CUDA kernel takes operand_bits <= 8")
    dev = x.device
    _require(x, "x", (torch.float32, torch.int8), (r, k), dev)
    _require(wq, "wq", torch.int8, (k, c), dev)
    _require(x_scale.reshape(-1), "x_scale", torch.float32, (1,), dev)
    _require(w_scale, "w_scale", torch.float32, (c,), dev)
    if bias is not None:
        _require(bias, "bias", torch.float32, (c,), dev)
    out = torch.empty((r, c), dtype=torch.float32, device=dev)
    return _launch("photonic_gemm_fused", True, x, wq, x_scale, w_scale, bias, seed,
                   out, rows, operand_bits=operand_bits, activation=activation, **stages)
