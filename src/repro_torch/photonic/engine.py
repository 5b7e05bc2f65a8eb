"""The photonic execution engine: one dispatcher for every DPU GEMM.

Port of ``repro.photonic.engine``.  A frozen :class:`PhotonicEngine` holds
the operating point (:class:`~repro_torch.core.dpu.DPUConfig`), a backend
and a :class:`SitePolicy`; :meth:`PhotonicEngine.matmul` is the
weight-stationary hot path (float activation against a prepacked int8
weight), :meth:`PhotonicEngine.int_gemm` the integer datapath every caller
shares.

Backends: ``kernel``, the default (the photonic GEMM kernels: the CUDA
kernel on CUDA tensors, its plain twin on CPU tensors — the port's
counterpart of the reference's ``pallas`` backend, whose interpret mode
plays the twin's role on CPU), ``ref`` (the untiled oracle) and ``exact``
(the ideal integer GEMM).

The float entry points train: :meth:`PhotonicEngine.matmul_float` and
:meth:`PhotonicEngine.matmul` are ``torch.autograd.Function``s around the
whole forward (quantization and the kernel inside), with the reference's
straight-through backward: dense f32 products of the float operands, the
activation's derivative taken at the dense pre-activation.

Contracts carried over: with an ideal channel every backend equals
``exact_int_gemm`` bitwise; deterministic analog stages are bitwise across
backends; noisy calls derive their stream from ``DPUConfig.noise_seed``
folded with the site name, the layer index and a content word of each
operand.  The weight's word is constant for a prepacked weight, so
:class:`~repro_torch.photonic.packing.PackedDense` carries it (computed once
at pack time, bitwise the per-call value) and decode never re-hashes the
int8 weight bank.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.dpu import (
    NOT_PORTED_KEYS,
    DPUConfig,
    quant_scale,
    quantize_symmetric,
    quantize_with_scale,
)
from repro_torch.kernels.photonic_gemm.epilogue import (
    ACTIVATIONS,
    EpilogueArgs,
    EpilogueSpec,
    apply_epilogue,
    as_epilogue,
)
from repro_torch.kernels.photonic_gemm.kernel import (
    photonic_gemm,
    photonic_gemm_fused,
)
from repro_torch.kernels.photonic_gemm.ref import exact_int_gemm, photonic_gemm_ref
from repro_torch.noise.stages import fold_seed, fold_words, tweak_word

BACKENDS = ("ref", "kernel", "exact")

NOT_PORTED_SLICING = (
    "bit-sliced execution (repro.photonic.slicing, _sliced_int_gemm) is not "
    "ported yet: ROADMAP.md Queue 1, 'Engine, epilogue, packing and slicing'"
)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _digital_reference(x, wf, bias, spec: EpilogueSpec) -> torch.Tensor:
    """Non-routed fallback in the historical digital op order.  Reference:
    ``repro.photonic.engine:_digital_reference``."""
    y = x @ wf
    if bias is not None:
        y = y + bias.to(y.dtype)
    if spec.activation is not None:
        y = ACTIVATIONS[spec.activation](y)
    return y


def site_hash(site: str) -> int:
    """Stable 32-bit FNV-1a of a site name.  Reference:
    ``repro.photonic.engine:site_hash``."""
    h = 2166136261
    for ch in site.encode():
        h = (h ^ ch) * 16777619 & 0xFFFFFFFF
    return h


def pallas_tiling(cfg: DPUConfig, k: int, c: int) -> Tuple[int, int, int]:
    """The *logical* tiling ``(n_chunk, tile_k, tile_c)`` for a (K, C) weight,
    which the noise-stream ids derive from.  Reference:
    ``repro.photonic.engine:pallas_tiling``."""
    channel = cfg.effective_channel()
    analog = channel is not None and channel.analog
    adc_bits = channel.adc_bits if channel is not None else cfg.adc_bits
    if adc_bits is None and not analog:
        tile_k = 512 if k >= 512 else _round_up(max(k, 128), 128)
        n_chunk = min(128, tile_k)
    else:
        n = cfg.n
        n_chunk = n
        tile_k = n * max(1, 512 // n)
    tile_c = min(128, _round_up(c, 128))
    return n_chunk, tile_k, tile_c


def kernel_stages(
    cfg: DPUConfig,
    r: int,
    k: int,
    c: int,
    tiling: Optional[Tuple[int, int, int]] = None,
    *,
    tile_r: int = 128,
    tile_c: int = 128,
) -> Tuple[dict, Tuple[int, int, int]]:
    """The photonic GEMM kernels' stage arguments for a logical
    ``(r, k) x (k, c)`` GEMM at operating point ``cfg``, and the padded
    operand shape ``(Rp, Kp, Cp)`` they take.  ``tiling`` is a prepacked
    weight's ``(n_chunk, tile_k, tile_c)``; without it the logical tiling
    comes from :func:`pallas_tiling`.  Reference: the kernel branch of
    ``repro.photonic.engine:PhotonicEngine.int_gemm``."""
    ch = cfg.effective_channel()
    analog = ch is not None and ch.analog
    noisy = analog and ch.detector_sigma_lsb > 0.0
    if tiling is not None:
        n_chunk, tile_k, tc = tiling
    else:
        n_chunk, tile_k, _ = pallas_tiling(cfg, k, c)
        tc = min(tile_c, _round_up(c, 128))
    tr = min(tile_r, _round_up(r, 8))
    stages = dict(
        slice_bits=cfg.bits,
        num_slices=cfg.num_slices,
        n_chunk=n_chunk,
        adc_bits=ch.adc_bits if ch is not None else cfg.adc_bits,
        noise_sigma=ch.detector_sigma_lsb if analog else 0.0,
        filter_alpha=ch.filter_alpha if analog else 0.0,
        intermod_eps=ch.intermod_eps if analog else 0.0,
        crossweight_eps=ch.crossweight_eps if analog else 0.0,
        valid_chunks=-(-k // n_chunk) if noisy else None,
        tile_r=tr,
        tile_c=tc,
        tile_k=tile_k,
    )
    return stages, (_round_up(r, tr), _round_up(k, tile_k), _round_up(c, tc))


@dataclasses.dataclass(frozen=True)
class SitePolicy:
    """Which named GEMM sites execute on the photonic DPU.  Reference:
    ``repro.photonic.engine:SitePolicy``."""

    include: Tuple[str, ...] = ("*",)
    exclude: Tuple[str, ...] = ("router",)

    def routes(self, site: Optional[str]) -> bool:
        if site is None:
            return True
        return self._match(self.include, site) and not self._match(self.exclude, site)

    @staticmethod
    def _match(patterns: Tuple[str, ...], site: str) -> bool:
        leaf = site.rsplit(".", 1)[-1]
        return any(
            fnmatch.fnmatchcase(site, p) or fnmatch.fnmatchcase(leaf, p)
            for p in patterns
        )


@dataclasses.dataclass(frozen=True)
class EngineInfo:
    """Structured ``PhotonicEngine.describe()`` result.  Reference:
    ``repro.photonic.engine:EngineInfo``."""

    backend: str
    organization: str
    platform: str
    blocks: Tuple[str, ...]
    through_devices: str
    bits: int
    n: int
    datarate_gs: float
    channel: str
    slicing: Optional[int]
    include: Tuple[str, ...]
    exclude: Tuple[str, ...]

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        extra = "" if self.platform == "SOI" else f"platform={self.platform}, "
        if self.slicing is not None:
            extra += f"slicing={self.slicing}b planes, "
        return (
            f"{self.backend} backend, {self.organization} "
            f"(blocks {'->'.join(self.blocks)}, through {self.through_devices}) "
            f"B={self.bits} N={self.n} @ {self.datarate_gs} GS/s, "
            f"channel={self.channel}, {extra}"
            f"sites include={list(self.include)} "
            f"exclude={list(self.exclude)}"
        )


@dataclasses.dataclass(frozen=True)
class PhotonicEngine:
    """Frozen photonic operating point + routing policy.  Reference:
    ``repro.photonic.engine:PhotonicEngine``."""

    dpu: DPUConfig = DPUConfig()
    backend: str = "kernel"
    policy: SitePolicy = SitePolicy()
    slicing: Optional[object] = None

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown photonic backend {self.backend!r}; expected one of "
                f"{BACKENDS}"
            )
        if self.slicing is not None:
            raise NotImplementedError(NOT_PORTED_SLICING)

    def routes(self, site: Optional[str]) -> bool:
        return self.policy.routes(site)

    @property
    def noisy(self) -> bool:
        ch = self.dpu.effective_channel()
        return ch is not None and ch.analog and ch.detector_sigma_lsb > 0.0

    def describe(self) -> EngineInfo:
        d = self.dpu
        ch = d.effective_channel()
        spec = d.org_spec
        return EngineInfo(
            backend=self.backend,
            organization=d.organization,
            platform=ch.platform if ch is not None else d.platform,
            blocks=tuple(spec.blocks),
            through_devices=spec.through_devices,
            bits=d.bits,
            n=d.n,
            datarate_gs=d.datarate_gs,
            channel="analog" if ch is not None and ch.analog else "ideal",
            slicing=None,
            include=tuple(self.policy.include),
            exclude=tuple(self.policy.exclude),
        )

    # -- seed derivation -----------------------------------------------------
    def stream_seed(
        self,
        site: Optional[str],
        fold: Optional[int],
        xq: torch.Tensor,
        wq: torch.Tensor,
        *,
        w_word: Optional[torch.Tensor] = None,
        prng_key=None,
    ) -> torch.Tensor:
        """uint32 noise-stream seed for one GEMM call (0-dim int64 on the
        operands' device).  Reference: ``repro.photonic.engine:
        PhotonicEngine.stream_seed`` on its ``noise_seed`` branch: site hash
        and layer index folded on the host, then the operands' content
        words (``w_word`` is the prepacked weight's, if known)."""
        if prng_key is not None:
            raise NotImplementedError(NOT_PORTED_KEYS)
        seed = self.dpu.noise_seed_value()
        if site is not None:
            seed = fold_seed(seed, site_hash(site))
        if fold is not None:
            seed = fold_seed(seed, int(fold))
        return fold_words(seed, tweak_word(xq), tweak_word(wq) if w_word is None else w_word)

    # -- integer datapath ----------------------------------------------------
    def int_gemm(
        self,
        xq: torch.Tensor,
        wq: torch.Tensor,
        *,
        site: Optional[str] = None,
        fold: Optional[int] = None,
        logical_kc: Optional[Tuple[int, int]] = None,
        tiling: Optional[Tuple[int, int, int]] = None,
        w_word: Optional[torch.Tensor] = None,
        tile_r: int = 128,
        tile_c: int = 128,
        epilogue: Optional[EpilogueArgs] = None,
        prng_key=None,
    ) -> torch.Tensor:
        """Integer GEMM through the DPU datapath; int32 ``(R, C)``, or f32
        with ``epilogue`` (the fused hot path; ``xq`` may then be a float
        activation, quantized in the kernel prologue on the ``kernel``
        backend and digitally elsewhere).  Reference:
        ``repro.photonic.engine:PhotonicEngine.int_gemm``."""
        k, c = logical_kc if logical_kc is not None else tuple(wq.shape[-2:])
        cfg = self.dpu
        channel = cfg.effective_channel()
        adc_bits = channel.adc_bits if channel is not None else cfg.adc_bits
        noisy = self.noisy

        if xq.is_floating_point():
            if epilogue is None:
                raise TypeError(
                    "int_gemm got float activations without an EpilogueArgs; "
                    "quantize explicitly or pass epilogue= (fused hot path)"
                )
            if noisy or self.backend != "kernel":
                xq = quantize_with_scale(xq, epilogue.x_scale, cfg.operand_bits)

        if self.backend == "exact":
            acc = exact_int_gemm(xq, wq[:k, :c])
            return acc if epilogue is None else _finish(acc, epilogue)

        seed = (
            self.stream_seed(site, fold, xq, wq, w_word=w_word, prng_key=prng_key)
            if noisy
            else None
        )

        if self.backend == "ref":
            acc = photonic_gemm_ref(
                xq,
                wq[:k, :c],
                slice_bits=cfg.bits,
                num_slices=cfg.num_slices,
                n_chunk=cfg.n,
                adc_bits=adc_bits,
                channel=channel,
                seed=seed,
            )
            return acc if epilogue is None else _finish(acc, epilogue)

        r = xq.shape[0]
        stages, (rp, kp, cp) = kernel_stages(
            cfg, r, k, c, tiling, tile_r=tile_r, tile_c=tile_c
        )
        xp = F.pad(xq, (0, kp - k, 0, rp - r)).contiguous()
        if tuple(wq.shape) != (kp, cp):
            wq = F.pad(wq[:k, :c], (0, cp - c, 0, kp - k)).contiguous()
        if epilogue is None:
            return photonic_gemm(xp, wq, seed, rows=r, **stages)[:r, :c]
        ws = F.pad(epilogue.w_scale.to(torch.float32).reshape(-1), (0, cp - c))
        bias = epilogue.bias
        if bias is not None:
            bias = F.pad(bias.to(torch.float32).reshape(-1), (0, cp - c))
        out = photonic_gemm_fused(
            xp,
            wq,
            epilogue.x_scale.to(torch.float32).reshape(1),
            ws,
            bias,
            seed,
            operand_bits=cfg.operand_bits,
            activation=epilogue.spec.activation,
            rows=r,
            **stages,
        )
        return out[:r, :c]

    # -- float entry points --------------------------------------------------
    def matmul_float(
        self,
        x: torch.Tensor,
        w: torch.Tensor,
        *,
        site: Optional[str] = None,
        fold: Optional[int] = None,
        epilogue=None,
        bias: Optional[torch.Tensor] = None,
        activation: Optional[str] = None,
    ) -> torch.Tensor:
        """Float GEMM quantizing both operands per call (the training
        path; differentiable by the straight-through estimator).
        Reference: ``repro.photonic.engine:PhotonicEngine.matmul_float``."""
        spec, bias = as_epilogue(epilogue, bias=bias, activation=activation)
        if not self.routes(site):
            return _digital_reference(x, w.to(x.dtype), bias, spec)
        return _FloatMatmul.apply(self, site, spec, fold, x, w, bias)

    def matmul(
        self,
        x: torch.Tensor,
        packed,  # PackedDense
        *,
        site: Optional[str] = None,
        fold: Optional[int] = None,
        epilogue=None,
        bias: Optional[torch.Tensor] = None,
        activation: Optional[str] = None,
    ) -> torch.Tensor:
        """Float GEMM against a prepacked weight — the weight-stationary hot
        path; differentiable in ``x`` and the bias (the int8 bank is frozen
        and its scale gets a zero gradient).  Reference:
        ``repro.photonic.engine:PhotonicEngine.matmul``."""
        spec, bias = as_epilogue(epilogue, bias=bias, activation=activation)
        if not self.routes(site):
            return _digital_reference(x, packed.dequant().to(x.dtype), bias, spec)
        return _PackedMatmul.apply(self, site, spec, fold, packed, x, packed.w_scale, bias)


@functools.lru_cache(maxsize=None)
def engine_for(
    dpu: DPUConfig,
    backend: str,
    include: Tuple[str, ...] = ("*",),
    exclude: Tuple[str, ...] = ("router",),
    slicing=None,
) -> PhotonicEngine:
    """Cached engine construction.  Reference:
    ``repro.photonic.engine:engine_for``."""
    return PhotonicEngine(
        dpu=dpu, backend=backend, policy=SitePolicy(include, exclude), slicing=slicing
    )


def _finish(acc: torch.Tensor, e: EpilogueArgs) -> torch.Tensor:
    """The fused epilogue applied to a digital int32 accumulator."""
    return apply_epilogue(acc, e.x_scale, e.w_scale.to(torch.float32), e.bias, e.spec)


def _stream_gemm(
    eng: PhotonicEngine,
    site,
    spec: EpilogueSpec,
    x,
    wq,
    w_scale,
    bias,
    fold,
    *,
    logical_kc=None,
    tiling=None,
    w_word=None,
):
    """One forward through the fused hot path.  Reference:
    ``repro.photonic.engine:_stream_gemm``: f32 activations defer their
    rounding (scale computed here), other dtypes quantize up front."""
    lead = x.shape[:-1]
    xr = x.reshape(-1, x.shape[-1])
    if xr.dtype == torch.float32:
        xs, sx = xr, quant_scale(xr, eng.dpu.operand_bits)
    else:
        xs, sx = quantize_symmetric(xr, eng.dpu.operand_bits)
    cols = logical_kc[1] if logical_kc is not None else wq.shape[1]
    y = eng.int_gemm(
        xs,
        wq,
        site=site,
        fold=fold,
        logical_kc=logical_kc,
        tiling=tiling,
        w_word=w_word,
        epilogue=EpilogueArgs(spec, sx, w_scale, bias),
    )
    return y.reshape(*lead, cols).to(x.dtype)


def _epilogue_bwd(spec: EpilogueSpec, g2, x2, wf, bias):
    """Backward of the epilogue under the STE convention: straight through
    the quantized GEMM, exact through bias and activation, the activation's
    derivative taken at the dense f32 pre-activation ``x2 @ wf (+ bias)``.
    Returns the gradient at the GEMM output and the bias gradient (``None``
    without a bias).  Reference: ``repro.photonic.engine:_epilogue_bwd``."""
    if spec.activation is not None:
        pre = x2 @ wf
        if bias is not None:
            pre = pre + bias.to(torch.float32)
        with torch.enable_grad():
            pre = pre.detach().requires_grad_(True)
            (g2,) = torch.autograd.grad(ACTIVATIONS[spec.activation](pre), pre, g2)
    db = None if bias is None else g2.sum(dim=0).to(bias.dtype)
    return g2, db


def _ste_grads(spec, g, x, wf, bias):
    """``(dx, g2, x2, db)`` of one straight-through backward in f32."""
    g2 = g.reshape(-1, g.shape[-1]).to(torch.float32)
    x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
    g2, db = _epilogue_bwd(spec, g2, x2, wf, bias)
    dx = (g2 @ wf.T).reshape(x.shape).to(x.dtype)
    return dx, g2, x2, db


class _FloatMatmul(torch.autograd.Function):
    """Reference: ``repro.photonic.engine:_float_matmul`` (custom VJP): the
    weight is quantized per call inside the forward; ``dx``, ``dw`` and
    ``db`` are f32 products cast back to the operand dtypes."""

    @staticmethod
    def forward(ctx, eng, site, spec, fold, x, w, bias):
        ctx.spec = spec
        ctx.save_for_backward(x, w, bias)
        wq, sw = quantize_symmetric(w, eng.dpu.operand_bits, axis=0)
        return _stream_gemm(eng, site, spec, x, wq, sw, bias, fold)

    @staticmethod
    def backward(ctx, g):
        x, w, bias = ctx.saved_tensors
        wf = w.to(torch.float32)
        dx, g2, x2, db = _ste_grads(ctx.spec, g, x, wf, bias)
        dw = (x2.T @ g2).to(w.dtype)
        return None, None, None, None, dx, dw, db


class _PackedMatmul(torch.autograd.Function):
    """Reference: ``repro.photonic.engine:_packed_matmul`` (custom VJP):
    ``dx`` against the dequantized bank and ``db``; the int8 bank is
    frozen serving state and ``w_scale`` gets zeros."""

    @staticmethod
    def forward(ctx, eng, site, spec, fold, packed, x, w_scale, bias):
        ctx.spec, ctx.packed = spec, packed
        ctx.save_for_backward(x, w_scale, bias)
        return _stream_gemm(
            eng, site, spec, x, packed.wq, w_scale, bias, fold,
            logical_kc=(packed.k, packed.c), tiling=packed.tiling, w_word=packed.w_word,
        )

    @staticmethod
    def backward(ctx, g):
        x, w_scale, bias = ctx.saved_tensors
        p = ctx.packed
        wf = p.wq[: p.k, : p.c].to(torch.float32) * w_scale.to(torch.float32)[None, :]
        dx, _, _, db = _ste_grads(ctx.spec, g, x, wf, bias)
        return None, None, None, None, None, dx, torch.zeros_like(w_scale), db
