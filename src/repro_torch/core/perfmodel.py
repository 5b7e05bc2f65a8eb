"""Private copy of ``repro.core.perfmodel`` for the PyTorch port (``import
repro_torch`` loads nothing of ``repro``); only intra-package imports
differ; ``weight_reprogram_cost`` imports ``repro_torch.photonic.packing``
lazily, as the reference imports its packing module.

Analytical cost model of the photonic GEMM accelerator (paper §V).

Latency/energy/area per component follow Table VI; organization-dependent
ring counts follow the Fig. 2 structures.  The system-level configuration
(DPU size N and area-proportionate DPU count per organization x datarate)
comes from Table V — the paper's own area matching; our independent area
model is reported alongside as a cross-check (benchmarks/table5_dpu.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

from repro_torch import platforms as _platforms
from repro_torch.core import scalability
from repro_torch.core.params import DEFAULT_PERIPHERALS, PeripheralParams, dbm_to_watts
from repro_torch.orgs import OrgSpec, resolve


@dataclasses.dataclass(frozen=True)
class AcceleratorConfig:
    organization: str = "SMWA"
    datarate_gs: float = 1.0
    bits: int = 4             # analog precision B
    operand_bits: int = 8     # CNN quantization
    n: int = 83               # DPE size (fan-in)
    m: int = 83               # DPEs per DPU (fan-out)
    dpu_count: int = 50
    dpus_per_tile: int = 4
    peripherals: PeripheralParams = DEFAULT_PERIPHERALS
    # Material platform (repro.platforms): owns the laser wall-plug
    # efficiency and the ring tuning powers of the power model.
    platform: "str | _platforms.PlatformSpec" = "SOI"

    def __post_init__(self):
        # Eager organization validation + case normalization: accept
        # str | OrgSpec, store the canonical name (unknown orders raise
        # ValueError naming the valid choices — repro.orgs.resolve).
        object.__setattr__(self, "organization", resolve(self.organization).name)
        # Same pattern for the platform (repro.platforms.resolve).
        object.__setattr__(self, "platform", _platforms.resolve(self.platform).name)

    @property
    def org_spec(self) -> OrgSpec:
        """The typed organization spec this config runs (repro.orgs)."""
        return resolve(self.organization)

    @property
    def platform_spec(self) -> _platforms.PlatformSpec:
        """The typed platform spec this config runs on (repro.platforms)."""
        return _platforms.resolve(self.platform)

    @property
    def symbol_s(self) -> float:
        return 1e-9 / self.datarate_gs

    @property
    def passes(self) -> int:
        s = -(-self.operand_bits // self.bits)
        return s * s

    @property
    def tiles(self) -> int:
        return -(-self.dpu_count // self.dpus_per_tile)

    # ---- weight-update tuning ----------------------------------------------
    # Weight updates use EO tuning (Table VI: 20 ns, 80 uW/FSR) for ALL
    # organizations; TO tuning is the slow thermal bias path.  (We tested an
    # org-dependent "hitless SMWA = EO, others = TO" model — it overshoots
    # the paper's ratios by more than an order of magnitude; recorded as a
    # refuted hypothesis in EXPERIMENTS.md §Paper-validation.)
    @property
    def tune_latency_s(self) -> float:
        return self.peripherals.eo_tuning_latency_s

    @property
    def tune_power_w_per_ring(self) -> float:
        # The per-FSR tuning power is platform-owned (Table VI tabulates
        # the SOI value; repro.platforms.SOI carries it verbatim, so the
        # default is unchanged — SiN's weaker EO effect costs more drive).
        return self.platform_spec.eo_tuning_w_per_fsr * 0.5

    # ---- organization-dependent ring counts per DPU (Fig. 2) --------------
    @property
    def rings_per_dpu(self) -> int:
        # Derived from the block order (repro.orgs rule set; reproduces the
        # legacy Fig. 2 counts — ASMW: M waveguides x (N MRM + N MRR) = 2NM,
        # MASW: shared N-MRM input array + M x N weight MRRs = N + NM,
        # SMWA: N*M MRM + N*M MRR + M x (N-ring mux) = 3NM).
        return self.org_spec.rings_per_dpu(self.n, self.m)

    @property
    def dacs_per_dpu(self) -> int:
        # Input drivers are shared across the M fan-out copies.
        return self.n

    @property
    def adcs_per_dpu(self) -> int:
        return self.m  # one per DPE/BPD

    # ---- area --------------------------------------------------------------
    def dpu_area_mm2(self) -> float:
        p = self.peripherals
        adc = p.adc(self.datarate_gs).area_mm2
        return (
            self.rings_per_dpu * p.mrr_area_mm2
            + self.adcs_per_dpu * (adc + p.pd_area_mm2)
            + self.dacs_per_dpu * p.dac.area_mm2
        )

    def tile_overhead_mm2(self) -> float:
        p = self.peripherals
        return (
            p.reduction_network.area_mm2
            + p.activation_unit.area_mm2
            + p.pooling_unit.area_mm2
            + p.edram.area_mm2
            + p.bus.area_mm2
            + p.router.area_mm2
        )

    def total_area_mm2(self) -> float:
        return (
            self.dpu_count * self.dpu_area_mm2()
            + self.tiles * self.tile_overhead_mm2()
            + self.peripherals.io_interface.area_mm2
        )

    # ---- power -------------------------------------------------------------
    def laser_power_w(self) -> float:
        """Laser wall power: N wavelengths per DPU (10 dBm each, shared
        across the M DPEs by the splitting block), at the platform's
        wall-plug efficiency (Sec. V-B assumes 20%; SOI carries that)."""
        eff = self.platform_spec.laser_wallplug_eff
        return self.dpu_count * self.n * dbm_to_watts(10.0) / eff

    def static_power_w(self) -> float:
        p = self.peripherals
        per_tile = (
            p.reduction_network.power_w
            + p.activation_unit.power_w
            + p.pooling_unit.power_w
            + p.edram.power_w
            + p.bus.power_w
            + p.router.power_w
        )
        return (self.tiles * per_tile + p.io_interface.power_w + self.laser_power_w())

    def streaming_power_w(self) -> float:
        """DAC+ADC power while a DPU streams symbols."""
        p = self.peripherals
        adc = p.adc(self.datarate_gs).power_w
        return self.dacs_per_dpu * p.dac.power_w + self.adcs_per_dpu * adc

    def weight_reprogram_cost(self, groups: int = 1):
        """Latency/energy to (re)program one weight tile's rings — the
        weight-stationary cost the prepacking layer models
        (:func:`repro_torch.photonic.packing.reprogram_cost`).  Dense tiles
        program all ``N x M`` weight rings; depthwise tiles hold one
        k-dot per DPE, so only the ``M`` active rings are driven."""
        from repro_torch.photonic.packing import reprogram_cost

        rings = self.n * self.m if groups == 1 else self.m
        return reprogram_cost(
            rings,
            tune_latency_s=self.tune_latency_s,
            tune_power_w_per_ring=self.tune_power_w_per_ring,
        )

    # ---- convenience -------------------------------------------------------
    @staticmethod
    def from_paper(
        organization: "str | OrgSpec", datarate_gs: float
    ) -> "AcceleratorConfig":
        """Operating point from Table V (B=4; paper-studied orders only)."""
        spec = resolve(organization)
        key = (spec.name, int(datarate_gs))
        if key not in scalability.TABLE_V_N:
            raise ValueError(
                f"no Table V operating point for {spec.name!r} at "
                f"{datarate_gs} GS/s — the paper tabulates "
                f"{sorted({k[0] for k in scalability.TABLE_V_N})} at DR in "
                f"{sorted({k[1] for k in scalability.TABLE_V_N})}; use "
                "from_scalability() for unstudied orderings"
            )
        n = scalability.TABLE_V_N[key]
        count = scalability.TABLE_V_COUNT[key]
        return AcceleratorConfig(
            organization=spec.name,
            datarate_gs=datarate_gs,
            n=n,
            m=n,
            dpu_count=count,
        )

    @staticmethod
    def from_scalability(
        organization: "str | OrgSpec",
        datarate_gs: float,
        bits: int = 4,
        dpu_count: int = 50,
        *,
        platform: "str | _platforms.PlatformSpec" = "SOI",
    ) -> "AcceleratorConfig":
        """Operating point from OUR calibrated solver (works for any valid
        ordering, studied or not — the design-space benchmark's path).
        ``platform`` sizes N on that platform's loss chain and rides into
        the config's power model; ``from_paper`` stays SOI-only (Table V
        *is* the SOI calibration target)."""
        spec = resolve(organization)
        platform_spec = _platforms.resolve(platform)
        n = scalability.calibrated_max_n(
            spec, bits, datarate_gs, platform=platform_spec
        )
        return AcceleratorConfig(
            organization=spec.name,
            datarate_gs=datarate_gs,
            bits=bits,
            n=n,
            m=n,
            dpu_count=dpu_count,
            platform=platform_spec.name,
        )


def area_matched_count(cfg: AcceleratorConfig, target_area_mm2: float) -> int:
    """Largest ``dpu_count`` keeping ``cfg`` within ``target_area_mm2``
    (the paper's area-proportionate matching, generalized to any ordering
    for the design-space sweep)."""
    lo, hi = 1, 100000
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if dataclasses.replace(cfg, dpu_count=mid).total_area_mm2() <= target_area_mm2:
            lo = mid
        else:
            hi = mid - 1
    return lo


def area_matched_counts(
    datarate_gs: float,
    base: AcceleratorConfig | None = None,
    *,
    organizations: "Sequence[str | OrgSpec] | None" = None,
    bits: int = 4,
    platform: "str | _platforms.PlatformSpec" = "SOI",
) -> Dict[str, int]:
    """Our area model's DPU counts matching SMWA's area (cross-check of the
    paper's area-proportionate analysis, Table V bottom rows).

    Default (``organizations=None``): the paper's three studied orders at
    their Table V operating points — unchanged legacy behavior.  With an
    explicit ``organizations`` list, each order is sized by the calibrated
    solver (``from_scalability``, any valid ordering, either platform) and
    area-matched to ``base``'s silicon — the mapper's equal-area pool
    construction (``DpuPool.area_matched``)."""
    base = base or AcceleratorConfig.from_paper("SMWA", datarate_gs)
    target = base.total_area_mm2()
    if organizations is None:
        out = {"SMWA": base.dpu_count}
        for org in ("ASMW", "MASW"):
            cfg = AcceleratorConfig.from_paper(org, datarate_gs)
            out[org] = area_matched_count(cfg, target)
        return out
    out: Dict[str, int] = {}
    for org in organizations:
        cfg = AcceleratorConfig.from_scalability(
            org, datarate_gs, bits=bits, platform=platform
        )
        out[cfg.organization] = area_matched_count(cfg, target)
    return out
