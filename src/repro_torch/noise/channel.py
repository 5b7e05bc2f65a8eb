"""Organization-aware analog channel model (paper Tables II–IV).

Port of ``repro.noise.channel``.  :class:`ChannelModel` and
:func:`build_channel_model` are pure Python and reproduce the reference
field for field; :func:`analog_pass_psums` is the oracle-side analog pass
in PyTorch; :func:`sliced_channel` is the channel one plane pass of the
bit-sliced mode sees, :func:`shard_local_channel` the channel one shard of
a K-sharded (tensor-parallel) GEMM sees.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch import platforms as _platforms
from repro_torch.core import scalability
from repro_torch.core.params import (
    K_BOLTZMANN,
    Q_ELECTRON,
    PhotonicParams,
    dbm_to_watts,
)
from repro_torch.noise import stages
from repro_torch.orgs import EFFECT_BUDGET_DB, OrgSpec, resolve


@dataclasses.dataclass(frozen=True)
class ChannelModel:
    """Signal-chain model of one DPU channel.  Reference:
    ``repro.noise.channel:ChannelModel`` (same fields, same defaults)."""

    organization: str = "SMWA"
    n: int = 1
    m: int = 1
    bits: int = 4
    num_wavelengths: int = 1
    datarate_gs: float = 5.0

    intermod_eps: float = 0.0
    crossweight_eps: float = 0.0
    filter_alpha: float = 0.0
    detector_sigma_lsb: float = 0.0
    adc_bits: Optional[int] = None

    through_loss_db: float = 0.0
    propagation_loss_db: float = 0.0
    splitter_loss_db: float = 0.0
    insertion_loss_db: float = 0.0
    fanout_split_db: float = 0.0
    penalty_db: float = 0.0
    delivered_dbm: float = 0.0
    snr_db: float = math.inf

    platform: str = "SOI"
    builder: Optional[tuple] = None

    @property
    def analog(self) -> bool:
        return (
            self.intermod_eps > 0.0
            or self.crossweight_eps > 0.0
            or self.filter_alpha > 0.0
            or self.detector_sigma_lsb > 0.0
        )

    @property
    def is_ideal(self) -> bool:
        return not self.analog and self.adc_bits is None

    def total_loss_db(self) -> float:
        return (
            self.through_loss_db
            + self.propagation_loss_db
            + self.splitter_loss_db
            + self.insertion_loss_db
            + self.fanout_split_db
            + self.penalty_db
        )

    def disable(self, *stage_names: str) -> "ChannelModel":
        """A copy with the named stages off (``intermod``, ``crossweight``,
        ``filter``, ``detector``, ``adc``, ``crosstalk``, ``all``)."""
        off = {
            "intermod": {"intermod_eps": 0.0},
            "crossweight": {"crossweight_eps": 0.0},
            "filter": {"filter_alpha": 0.0},
            "detector": {"detector_sigma_lsb": 0.0},
            "adc": {"adc_bits": None},
        }
        groups = {
            "crosstalk": ("intermod", "crossweight", "filter"),
            "all": tuple(off),
        }
        updates: Dict[str, object] = {}
        for s in stage_names:
            for name in groups.get(s, (s,)):
                if name not in off:
                    raise ValueError(f"unknown stage {s!r}")
                updates.update(off[name])
        return dataclasses.replace(self, **updates)


def _budget_to_coupling(budget_db: float) -> float:
    return (1.0 - 10.0 ** (-budget_db / 20.0)) / 2.0


def build_channel_model(
    organization: "str | OrgSpec",
    params: Optional[PhotonicParams] = None,
    *,
    n: Optional[int] = None,
    m: Optional[int] = None,
    bits: int = 4,
    datarate_gs: float = 5.0,
    adc_bits: Optional[int] = None,
    enable_loss: bool = True,
    enable_crosstalk: bool = True,
    enable_detector_noise: bool = True,
    enable_adc: bool = True,
    platform: "str | _platforms.PlatformSpec" = "SOI",
) -> ChannelModel:
    """Derive the quantitative channel model for one organization.
    Reference: ``repro.noise.channel:build_channel_model`` (same arguments,
    same arithmetic in the same order, so every field matches)."""
    spec = resolve(organization)
    org = spec.name
    m_given = m
    platform_spec = _platforms.resolve(platform)
    params_given = params
    params = platform_spec.apply(params or scalability.CALIBRATED)
    if n is None:
        n = scalability.calibrated_max_n(
            spec, bits, datarate_gs, platform=platform_spec
        )
        if n <= 0:
            raise ValueError(
                f"infeasible operating point {org} B={bits} DR={datarate_gs}"
            )
    if m is None:
        m = n

    through_db = spec.through_device_count(n) * params.p_mrm_obl_db
    prop_db = (
        params.p_si_att_db_per_mm
        * spec.waveguide_length_factor
        * n
        * params.d_mrr_mm
        + params.p_smf_att_db
    )
    split_db = params.p_splitter_il_db * math.log2(max(m, 2))
    il_db = params.p_ec_il_db + params.p_mrm_il_db + params.p_mrr_w_il_db
    fanout_db = 10.0 * math.log10(max(m, 1))
    penalty_db = params.penalty_db(spec)

    if enable_loss:
        delivered_dbm = scalability.output_power_dbm(n, m, spec, params)
    else:
        delivered_dbm = params.p_laser_dbm
    p_ch = dbm_to_watts(delivered_dbm)
    bw = datarate_gs * 1e9 / params.bw_divisor
    snr_amp = params.responsivity * p_ch / (
        scalability.noise_beta(p_ch, params) * math.sqrt(bw)
    )
    snr_db = 20.0 * math.log10(snr_amp) if snr_amp > 0 else -math.inf

    sigma = 0.0
    if enable_detector_noise:
        r_s = params.responsivity
        shot = 2.0 * Q_ELECTRON * (r_s * n * p_ch + params.i_dark)
        thermal = 4.0 * K_BOLTZMANN * params.temperature / params.r_load
        rin = n * (r_s * p_ch) ** 2 * params.rin_linear_per_hz
        dark_branch = 2.0 * Q_ELECTRON * params.i_dark + thermal
        noise_amp = (
            math.sqrt(shot + thermal + rin) + math.sqrt(dark_branch)
        ) * math.sqrt(bw)
        fullscale = float((2**bits - 1) ** 2)
        sigma = fullscale * noise_amp / max(r_s * p_ch, 1e-30)

    eps_im = eps_cw = alpha = 0.0
    if enable_crosstalk:
        if spec.inter_modulation:
            eps_im = _budget_to_coupling(EFFECT_BUDGET_DB["inter_modulation"])
        if spec.cross_weight:
            eps_cw = _budget_to_coupling(EFFECT_BUDGET_DB["cross_weight"])
        if spec.filter_truncation:
            alpha = 1.0 - 10.0 ** (-EFFECT_BUDGET_DB["filter_truncation"] / 20.0)

    builder = (
        org,
        params_given,
        m_given,
        bits,
        datarate_gs,
        adc_bits,
        enable_loss,
        enable_crosstalk,
        enable_detector_noise,
        enable_adc,
        platform_spec.name,
    )
    return ChannelModel(
        organization=org,
        platform=platform_spec.name,
        n=n,
        m=m,
        bits=bits,
        num_wavelengths=n,
        datarate_gs=datarate_gs,
        intermod_eps=eps_im,
        crossweight_eps=eps_cw,
        filter_alpha=alpha,
        detector_sigma_lsb=sigma,
        adc_bits=adc_bits if enable_adc else None,
        through_loss_db=through_db,
        propagation_loss_db=prop_db,
        splitter_loss_db=split_db,
        insertion_loss_db=il_db,
        fanout_split_db=fanout_db,
        penalty_db=penalty_db,
        delivered_dbm=delivered_dbm,
        snr_db=snr_db,
        builder=builder,
    )


def _rebuilder(builder: tuple):
    """``rebuild(n, bits=None)``: the model a recorded builder would have
    produced at fan-in ``n`` (and, optionally, another analog precision),
    every other argument replayed as given.  Reference:
    ``repro.noise.channel:_rebuilder``."""
    (
        org,
        params,
        m_given,
        bits_given,
        datarate_gs,
        adc_bits,
        enable_loss,
        enable_crosstalk,
        enable_detector_noise,
        enable_adc,
        platform,
    ) = builder

    def rebuild(n: int, bits: Optional[int] = None) -> ChannelModel:
        return build_channel_model(
            org,
            params,
            n=n,
            m=m_given,
            bits=bits_given if bits is None else bits,
            datarate_gs=datarate_gs,
            adc_bits=adc_bits,
            enable_loss=enable_loss,
            enable_crosstalk=enable_crosstalk,
            enable_detector_noise=enable_detector_noise,
            enable_adc=enable_adc,
            platform=platform,
        )

    return rebuild


def shard_local_channel(channel: ChannelModel, n_local: int) -> ChannelModel:
    """The channel model one shard of a K-sharded GEMM sees: the fan-in
    shrinks to ``N_local = min(N, K/shards)``, and with it the through
    loss, the propagation length, the delivered power and so the detector
    sigma, while the crosstalk couplings and the ADC carry over.

    A no-op at ``n_local >= channel.n``.  A model made by
    :func:`build_channel_model` is rebuilt from its recorded arguments at
    ``n_local``, then the caller's couplings, filter alpha and ADC bits are
    put back (so disabled stages stay disabled) and a sigma the caller
    replaced survives; a hand-made model keeps its magnitudes and only
    shrinks its geometry.  Reference:
    ``repro.noise.channel:shard_local_channel``."""
    n_local = max(int(n_local), 1)
    if n_local >= channel.n:
        return channel
    if channel.builder is None:
        return dataclasses.replace(
            channel,
            n=n_local,
            num_wavelengths=min(channel.num_wavelengths, n_local),
        )
    rebuild = _rebuilder(channel.builder)
    rebuilt = rebuild(n_local)
    sigma = rebuilt.detector_sigma_lsb
    if channel.detector_sigma_lsb != rebuild(channel.n).detector_sigma_lsb:
        sigma = channel.detector_sigma_lsb
    return dataclasses.replace(
        rebuilt,
        intermod_eps=channel.intermod_eps,
        crossweight_eps=channel.crossweight_eps,
        filter_alpha=channel.filter_alpha,
        adc_bits=channel.adc_bits,
        detector_sigma_lsb=sigma,
    )


def sliced_channel(channel: ChannelModel, plane_bits: int) -> ChannelModel:
    """The channel one bit-plane pass of the sliced mode sees: the same
    hardware (fan-in N, power, loss chain), a ``plane_bits``-bit operand
    plane per pass, so the product full-scale and the detector sigma
    referred to it shrink from ``(2^B - 1)^2`` to ``(2^p - 1)^2`` psum LSBs;
    the crosstalk couplings are relative amplitudes and carry over.

    A model made by :func:`build_channel_model` is rebuilt from its
    recorded arguments at ``bits=plane_bits`` (same N); a hand-made one
    scales its sigma by the full-scale ratio.  Couplings, filter alpha and
    ADC bits the caller set survive, and so does a sigma override (scaled).
    Reference: ``repro.noise.channel:sliced_channel``."""
    plane_bits = int(plane_bits)
    if plane_bits == channel.bits:
        return channel
    scale = float((2**plane_bits - 1) ** 2) / float((2**channel.bits - 1) ** 2)
    if channel.builder is None:
        return dataclasses.replace(
            channel,
            bits=plane_bits,
            detector_sigma_lsb=channel.detector_sigma_lsb * scale,
        )
    rebuild = _rebuilder(channel.builder)
    rebuilt = rebuild(channel.n, plane_bits)
    sigma = rebuilt.detector_sigma_lsb
    if channel.detector_sigma_lsb != rebuild(channel.n).detector_sigma_lsb:
        sigma = channel.detector_sigma_lsb * scale
    return dataclasses.replace(
        rebuilt,
        intermod_eps=channel.intermod_eps,
        crossweight_eps=channel.crossweight_eps,
        filter_alpha=channel.filter_alpha,
        adc_bits=channel.adc_bits,
        detector_sigma_lsb=sigma,
    )


def int_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact product of integer-valued operands, as int64.

    Runs in float64, which is exact while every partial sum stays below
    2^53 (int8 operands need K < 2^38) and works on both CPU and CUDA
    (CUDA has no integer matmul)."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.int64)


def analog_pass_psums(
    x_chunks: torch.Tensor,  # (R, G, N) int — one operand slice, chunked
    w_chunks: torch.Tensor,  # (G, N, C) int — one weight slice, chunked
    channel: ChannelModel,
    seed: stages.UInt,  # uint32 stream seed (stages.fold_seed output)
    columns: Optional[Tuple[int, int]] = None,
    rows: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """One slice-pair optical pass through the full signal chain; int32
    per-chunk psums ``(R, G, C)``.  Reference:
    ``repro.noise.channel:analog_pass_psums`` (crosstalk -> filter ->
    detector noise -> ADC, each stage one f32 op as there).  ``columns =
    (origin, total)``: ``w_chunks`` is the columns from ``origin`` of a
    ``total``-column weight; ``rows = (origin, total)``: ``x_chunks`` is
    the rows from ``origin`` of a ``total``-row operand; the noise counters
    are then the whole ``(R_total, G, C_total)`` array's."""
    dev = x_chunks.device
    xs = x_chunks.permute(1, 0, 2)  # (G, R, N)
    psum = int_dot(xs, w_chunks).permute(1, 0, 2)  # (R, G, C)
    a = psum.to(torch.float32)
    if channel.intermod_eps > 0.0:
        x_nb = stages.neighbor_sum(xs, axis=-1)
        im = int_dot(x_nb, w_chunks).permute(1, 0, 2).to(torch.float32)
        a = a + stages.f32(channel.intermod_eps, dev) * im
    if channel.crossweight_eps > 0.0:
        w_nb = stages.neighbor_sum(w_chunks, axis=1)
        cw = int_dot(xs, w_nb).permute(1, 0, 2).to(torch.float32)
        a = a + stages.f32(channel.crossweight_eps, dev) * cw
    ctr = None
    if columns is not None or rows is not None:
        r, g, c = a.shape
        origin, total = (0, c) if columns is None else columns
        r0 = 0 if rows is None else int(rows[0])
        rg = torch.arange(r0 * g, (r0 + r) * g, dtype=torch.int64, device=dev).reshape(r, g, 1)
        ctr = rg * total + origin + torch.arange(c, dtype=torch.int64, device=dev)
    return apply_channel_psum(a, channel, seed, differentiable=False, ctr=ctr)


def apply_channel_psum(
    a: torch.Tensor,
    channel: ChannelModel,
    seed: stages.UInt,
    *,
    differentiable: bool = True,
    ctr: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The post-accumulation stages alone (filter -> detector noise -> ADC)
    on a float psum array: differentiable by default (the ADC rounds
    straight through), the int32 ADC output with ``differentiable=False``;
    ``ctr``: the noise's element counters (default the row-major index).
    Reference: ``repro.noise.channel:apply_channel_psum``."""
    if channel.filter_alpha > 0.0:
        a = stages.filter_truncation(a, channel.filter_alpha)
    if channel.detector_sigma_lsb > 0.0:
        a = stages.detector_noise(a, channel.detector_sigma_lsb, seed, ctr)
    return stages.adc_quantize(a, channel.adc_bits, differentiable=differentiable)
