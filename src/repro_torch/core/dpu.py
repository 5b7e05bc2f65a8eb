"""Operating point and quantization of the photonic DPU, in PyTorch.

Port of ``repro.core.dpu``: the config, the quantizers, the oracle
datapath ``dpu_int_gemm``, the straight-through estimator (STE) used to
train through it, and :func:`bit_slices`, the operand planes of the
bit-sliced execution mode.  The quantizers keep the reference's
reciprocal-multiply spelling exactly:
``scale = max(amax, 1e-12) * (1/qmax)`` computed in the input dtype (each
constant cast to that dtype first, as JAX's weak-typed scalars are), then
true division ``x / scale``, round half-to-even, clip, cast.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch import platforms as _platforms
from repro_torch.core import scalability
from repro_torch.kernels.photonic_gemm.ref import photonic_gemm_ref
from repro_torch.noise.channel import ChannelModel, shard_local_channel
from repro_torch.noise.stages import data_tweak, seed_from_key
from repro_torch.orgs import OrgSpec, resolve

@dataclasses.dataclass(frozen=True)
class DPUConfig:
    """Operating point of a photonic DPU.  Reference:
    ``repro.core.dpu:DPUConfig`` (same fields, validation and defaults)."""

    organization: "str | OrgSpec" = "SMWA"
    bits: int = 4
    operand_bits: int = 8
    datarate_gs: float = 5.0
    dpe_size: Optional[int] = None
    dpu_fanout: Optional[int] = None
    noise_sigma_lsb: float = 0.0
    adc_bits: Optional[int] = None
    channel: Optional[ChannelModel] = None
    noise_seed: Optional[int] = None
    platform: "str | _platforms.PlatformSpec" = "SOI"

    def __post_init__(self):
        object.__setattr__(self, "organization", resolve(self.organization).name)
        object.__setattr__(self, "platform", _platforms.resolve(self.platform).name)

    @property
    def org_spec(self) -> OrgSpec:
        return resolve(self.organization)

    @property
    def platform_spec(self) -> _platforms.PlatformSpec:
        return _platforms.resolve(self.platform)

    @property
    def n(self) -> int:
        if self.dpe_size is not None:
            return self.dpe_size
        n = scalability.calibrated_max_n(
            self.organization, self.bits, self.datarate_gs, platform=self.platform
        )
        if n <= 0:
            raise ValueError(
                f"infeasible operating point: {self.organization} B={self.bits} "
                f"DR={self.datarate_gs} GS/s"
            )
        return n

    @property
    def m(self) -> int:
        return self.dpu_fanout if self.dpu_fanout is not None else self.n

    @property
    def num_slices(self) -> int:
        return -(-self.operand_bits // self.bits)

    @property
    def passes(self) -> int:
        return self.num_slices * self.num_slices

    def num_chunks(self, k: int) -> int:
        return -(-k // self.n)

    def effective_channel(self) -> Optional[ChannelModel]:
        """The channel model this config implies (None = ideal datapath).
        Reference: ``repro.core.dpu:DPUConfig.effective_channel``."""
        if self.channel is not None:
            ch = self.channel
            if ch.adc_bits is None and self.adc_bits is not None:
                ch = dataclasses.replace(ch, adc_bits=self.adc_bits)
            return ch
        if self.noise_sigma_lsb > 0.0:
            return ChannelModel(
                organization=self.organization,
                bits=self.bits,
                datarate_gs=self.datarate_gs,
                detector_sigma_lsb=self.noise_sigma_lsb,
                adc_bits=self.adc_bits,
                platform=self.platform,
            )
        return None

    def shard_local(self, k_local: int) -> "DPUConfig":
        """The operating point of one shard of a K-sharded GEMM: the DPE
        fan-in clamped to ``N_local = min(N, K_local)`` and the channel
        rebuilt there (:func:`~repro_torch.noise.channel.shard_local_channel`).
        An ideal config only clamps the chunk size, which is numerically
        inert.  Reference: ``repro.core.dpu:DPUConfig.shard_local``."""
        n_local = min(self.n, max(int(k_local), 1))
        updates: dict = {}
        if self.dpe_size != n_local:
            updates["dpe_size"] = n_local
        if self.channel is not None:
            ch = shard_local_channel(self.channel, n_local)
            if ch is not self.channel:
                updates["channel"] = ch
        return dataclasses.replace(self, **updates) if updates else self

    def noise_seed_array(self, prng_key=None, *, what: str = "noise") -> int:
        """uint32 stream seed (a Python int) from ``prng_key`` or
        ``noise_seed``, in that order, raising the documented error when
        neither is given.  ``prng_key`` is a :mod:`repro_torch.prng` key
        (or a raw JAX key's words).  Reference:
        ``repro.core.dpu:DPUConfig.noise_seed_array``."""
        if prng_key is not None:
            return seed_from_key(prng_key)
        if self.noise_seed is not None:
            return self.noise_seed & 0xFFFFFFFF
        raise ValueError(
            f"{what} requires a randomness source: pass prng_key or set "
            "DPUConfig.noise_seed (deterministic; same seed => bitwise-equal "
            "results)"
        )


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    """A Python constant in ``like``'s dtype (JAX's weak-type rule), made by
    a fill kernel rather than a synchronizing host-to-device copy."""
    return torch.full((), v, dtype=like.dtype, device=like.device)


def _amax(x: torch.Tensor, axis: Optional[int]) -> torch.Tensor:
    if axis is None:
        return torch.max(torch.abs(x))
    return torch.amax(torch.abs(x), dim=axis, keepdim=True)


def quant_scale(
    x: torch.Tensor,
    bits: int,
    axis: Optional[int] = None,
    *,
    amax: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The symmetric quantization scale alone (f32).  Reference:
    ``repro.core.dpu:quant_scale``."""
    qmax = float(2 ** (bits - 1) - 1)
    if amax is None:
        amax = _amax(x, axis)
    scale = torch.maximum(amax, _const(1e-12, amax)) * _const(1.0 / qmax, amax)
    return scale.to(torch.float32)


def quantize_with_scale(x: torch.Tensor, scale: torch.Tensor, bits: int) -> torch.Tensor:
    """Round/clip ``x`` against a precomputed scale.  Reference:
    ``repro.core.dpu:quantize_with_scale``."""
    qmax = float(2 ** (bits - 1) - 1)
    q = torch.clamp(torch.round(x / scale), -qmax, qmax)
    return q.to(torch.int8 if bits <= 8 else torch.int32)


def quantize_symmetric(
    x: torch.Tensor,
    bits: int,
    axis: Optional[int] = None,
    *,
    amax: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric linear quantization to signed ``bits`` integers; returns
    ``(q, scale_f32)``.  Reference: ``repro.core.dpu:quantize_symmetric``.
    The division runs in ``x``'s own dtype against the raw-dtype scale,
    which is why bf16 activations quantize up front (not in-kernel)."""
    qmax = float(2 ** (bits - 1) - 1)
    if amax is None:
        amax = _amax(x, axis)
    scale = torch.maximum(amax, _const(1e-12, amax)) * _const(1.0 / qmax, amax)
    q = torch.clamp(torch.round(x / scale), -qmax, qmax)
    return q.to(torch.int8 if bits <= 8 else torch.int32), scale.to(torch.float32)


def bit_slices(q: torch.Tensor, slice_bits: int, num_slices: int) -> torch.Tensor:
    """Signed-magnitude bit-slice decomposition, stacked on a new leading
    axis as int8: ``q == sum_s slices[s] * 2**(slice_bits * s)`` exactly,
    ``slices[s]`` in ``[-(2^slice_bits - 1), 2^slice_bits - 1]``.
    Reference: ``repro.core.dpu:bit_slices``."""
    qi = q.to(torch.int32)
    sgn = torch.sign(qi)
    mag = torch.abs(qi)
    mask = (1 << slice_bits) - 1
    return torch.stack(
        [(sgn * ((mag >> (slice_bits * s)) & mask)).to(torch.int8) for s in range(num_slices)]
    )


# ---------------------------------------------------------------------------
# The DPU integer GEMM and the float entry points through it
# ---------------------------------------------------------------------------
def dpu_int_gemm(
    xq: torch.Tensor,  # (R, K) int8
    wq: torch.Tensor,  # (K, C) int8
    cfg: DPUConfig,
    *,
    prng_key=None,
) -> torch.Tensor:
    """Integer GEMM through the DPU datapath; int32 ``(R, C)``.  Reference:
    ``repro.core.dpu:dpu_int_gemm``: exact when the channel is ideal; an
    analog channel runs every slice-pair pass through the signal chain,
    its noise stream ``data_tweak(seed, xq, wq)`` folded per pass, the seed
    from ``prng_key`` or else ``cfg.noise_seed``."""
    channel = cfg.effective_channel()
    seed = None
    if channel is not None and channel.analog and channel.detector_sigma_lsb > 0.0:
        seed = data_tweak(cfg.noise_seed_array(prng_key, what="detector noise"), xq, wq)
    return photonic_gemm_ref(
        xq,
        wq,
        slice_bits=cfg.bits,
        num_slices=cfg.num_slices,
        n_chunk=cfg.n,
        adc_bits=channel.adc_bits if channel is not None else cfg.adc_bits,
        channel=channel,
        seed=seed,
    )


def photonic_matmul(
    x: torch.Tensor,  # (..., K) float
    w: torch.Tensor,  # (K, C) float
    cfg: DPUConfig = DPUConfig(),
    *,
    prng_key=None,
    w_scale_axis: Optional[int] = 0,
    channel: Optional[ChannelModel] = None,
) -> torch.Tensor:
    """Float-in / float-out GEMM through the DPU model (forward only; see
    :func:`photonic_matmul_ste` to train through it).  ``channel``
    overrides ``cfg.channel`` for this call.  Reference:
    ``repro.core.dpu:photonic_matmul``."""
    if channel is not None:
        cfg = dataclasses.replace(cfg, channel=channel)
    lead = x.shape[:-1]
    xr = x.reshape(-1, x.shape[-1])
    xq, sx = quantize_symmetric(xr, cfg.operand_bits)
    wq, sw = quantize_symmetric(w, cfg.operand_bits, axis=w_scale_axis)
    out = dpu_int_gemm(xq, wq, cfg, prng_key=prng_key)
    y = out.to(torch.float32) * sx * sw
    return y.reshape(*lead, w.shape[1]).to(x.dtype)


class _PhotonicMatmulSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, cfg, prng_key):
        ctx.save_for_backward(x, w)
        return photonic_matmul(x, w, cfg, prng_key=prng_key)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        x2 = x.reshape(-1, x.shape[-1])
        dx = (g2 @ w.T.to(g2.dtype)).reshape(x.shape).to(x.dtype)
        dw = (x2.T.to(g2.dtype) @ g2).to(w.dtype)
        return dx, dw, None, None


def photonic_matmul_ste(
    x: torch.Tensor, w: torch.Tensor, cfg: DPUConfig, prng_key=None
) -> torch.Tensor:
    """QAT forward through the (optionally noisy) photonic datapath; the
    backward is the straight-through dense-matmul gradient
    ``dx = g @ w.T``, ``dw = x.T @ g`` (the key gets none).  Reference:
    ``repro.core.dpu:photonic_matmul_ste``."""
    return _PhotonicMatmulSTE.apply(x, w, cfg, prng_key)


def noise_sigma_from_snr(cfg: DPUConfig, params=None) -> float:
    """Analog noise std (psum LSBs) implied by operating at ENOB = B:
    half-LSB symbol noise accumulated in quadrature over the chunk,
    ``sqrt(N) / 2``.  ``params`` is accepted for the reference's
    signature and unused there too.  Reference:
    ``repro.core.dpu:noise_sigma_from_snr``."""
    return math.sqrt(cfg.n) * 0.5
