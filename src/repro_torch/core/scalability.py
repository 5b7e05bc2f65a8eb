"""Private copy of ``repro.core.scalability`` for the PyTorch port (``import repro_torch``
loads nothing of ``repro``); only intra-package imports differ.

Scalability analysis — paper Eq. 1, Eq. 2, Eq. 3 (§IV-C, Fig. 5, Table V).

Given a bit precision ``B`` and datarate ``DR``, Eq. 1–2 yield the minimum
optical power ``P_PD-opt`` that the balanced photodetector must receive to
resolve ``B`` bits (ENOB relation with shot + thermal + RIN noise).  Eq. 3
computes the optical power ``P_O/p`` that actually reaches the photodetector
after all losses/penalties for a DPU of size ``N`` (fan-in) and fan-out ``M``.
The achievable DPU size is the largest ``N`` (= ``M``, following the paper)
with ``P_O/p >= P_PD-opt``, capped by the FSR-limited WDM channel count.

Three parameters of Eq. 3 are not tabulated in the paper (``P_SMF-att``,
``d_MRR`` and the exact noise-bandwidth convention); :func:`calibrate` freezes
them with a one-time grid search against the nine Table V entries.  The
calibrated defaults below reproduce Table V closely (see
``benchmarks/table5_dpu.py`` and EXPERIMENTS.md §Paper-validation).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, Iterable, Tuple

from repro_torch import platforms as _platforms
from repro_torch.core.params import K_BOLTZMANN, Q_ELECTRON, PhotonicParams, watts_to_dbm
from repro_torch.orgs import ORGANIZATIONS, OrgSpec, resolve

# Paper Table V — DPU size N at 4-bit precision (targets for calibration /
# validation).  Keys: (organization, datarate in GS/s) -> N.
TABLE_V_N: Dict[Tuple[str, int], int] = {
    ("ASMW", 1): 36, ("ASMW", 5): 17, ("ASMW", 10): 12,
    ("MASW", 1): 43, ("MASW", 5): 21, ("MASW", 10): 15,
    ("SMWA", 1): 83, ("SMWA", 5): 42, ("SMWA", 10): 30,
}

# Paper Table V — area-proportionate DPU counts (validated in perfmodel).
TABLE_V_COUNT: Dict[Tuple[str, int], int] = {
    ("ASMW", 1): 160, ("ASMW", 5): 265, ("ASMW", 10): 291,
    ("MASW", 1): 186, ("MASW", 5): 275, ("MASW", 10): 295,
    ("SMWA", 1): 50, ("SMWA", 5): 147, ("SMWA", 10): 198,
}


# ---------------------------------------------------------------------------
# Eq. 2 — input-referred noise amplitude beta(P_PD) [A / sqrt(Hz)]
# ---------------------------------------------------------------------------
def noise_beta(p_pd_watts: float, params: PhotonicParams) -> float:
    r = params.responsivity
    shot_signal = 2.0 * Q_ELECTRON * (r * p_pd_watts + params.i_dark)
    thermal = 4.0 * K_BOLTZMANN * params.temperature / params.r_load
    rin = (r * p_pd_watts) ** 2 * params.rin_linear_per_hz
    dark_branch = 2.0 * Q_ELECTRON * params.i_dark + thermal
    return math.sqrt(shot_signal + thermal + rin) + math.sqrt(dark_branch)


# ---------------------------------------------------------------------------
# Eq. 1 — minimum PD power for B bits at datarate DR (fixed point on Eq. 2)
# ---------------------------------------------------------------------------
def pd_sensitivity_watts(
    bits: float,
    datarate_hz: float,
    params: PhotonicParams,
    *,
    snr_margin_db: float = 0.0,
    tol: float = 1e-12,
) -> float:
    """Solve Eq. 1 for P_PD-opt: B = (20 log10(R P / (beta sqrt(BW))) - 1.76)/6.02.

    The achievable SNR saturates at 1/sqrt(RIN*BW) as P grows (the RIN term of
    Eq. 2 scales with P^2), so high (B, DR) corners can be *infeasible* — we
    return ``math.inf`` there (and :func:`max_dpu_size` returns N=0, matching
    the empty corners of Fig. 5).
    """
    snr_db = 6.02 * bits + 1.76 + snr_margin_db
    snr_amp = 10.0 ** (snr_db / 20.0)
    bw = datarate_hz / params.bw_divisor
    sqrt_bw = math.sqrt(bw)

    def snr(p: float) -> float:
        return params.responsivity * p / (noise_beta(p, params) * sqrt_bw)

    # RIN-imposed SNR ceiling (amplitude).
    snr_ceiling = 1.0 / math.sqrt(params.rin_linear_per_hz * bw)
    if snr_amp >= snr_ceiling:
        return math.inf
    lo, hi = 1e-15, 1e-9
    while snr(hi) < snr_amp:
        hi *= 2.0
        if hi > 10.0:  # > 10 W at the PD: treat as infeasible
            return math.inf
    # snr(p) is monotonically increasing -> bisection.
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if snr(mid) < snr_amp:
            lo = mid
        else:
            hi = mid
        if hi - lo <= tol * hi:
            break
    return hi


def bits_supported(
    p_pd_watts: float, datarate_hz: float, params: PhotonicParams
) -> float:
    """Forward Eq. 1: ENOB supported by a received power (for property tests)."""
    bw = datarate_hz / params.bw_divisor
    snr = (
        params.responsivity
        * p_pd_watts
        / (noise_beta(p_pd_watts, params) * math.sqrt(bw))
    )
    if snr <= 0:
        return 0.0
    return (20.0 * math.log10(snr) - 1.76) / 6.02


# ---------------------------------------------------------------------------
# Eq. 3 — optical power reaching the photodetector, in dBm
# ---------------------------------------------------------------------------
def output_power_dbm(
    n: int,
    m: int,
    organization: "str | OrgSpec",
    params: PhotonicParams,
    *,
    org_aware_through: bool = True,
) -> float:
    spec = resolve(organization)
    p = params.p_laser_dbm
    p -= params.p_smf_att_db
    p -= params.p_ec_il_db
    p -= params.p_si_att_db_per_mm * n * params.d_mrr_mm
    p -= params.p_mrm_il_db
    p -= params.p_splitter_il_db * math.log2(max(m, 2))
    p -= params.p_mrr_w_il_db
    if org_aware_through:
        # Structural through loss (paper §IV-B1 / Table III, derived from
        # the block order): a channel passes 2(N-1) out-of-resonance rings
        # in ASMW, N in MASW, only 2 in SMWA.
        p -= spec.through_device_count(n) * params.p_mrm_obl_db
    else:
        # Eq. 3 exactly as printed (organization differences lumped in
        # P_penalty only).
        p -= (n - 1) * params.p_mrm_obl_db
        p -= (n - 1) * params.p_mrr_w_obl_db
    p -= params.penalty_db(spec)
    p -= 10.0 * math.log10(n)  # 1:M fan-out power split (M = N)
    return p


# ---------------------------------------------------------------------------
# Achievable DPU size N (Fig. 5 / Table V)
# ---------------------------------------------------------------------------
def max_dpu_size(
    organization: "str | OrgSpec",
    bits: float,
    datarate_gs: float,
    params: PhotonicParams,
    *,
    snr_margin_db: float = 0.0,
    org_aware_through: bool = True,
) -> int:
    """Largest N (= M) whose delivered power meets the PD sensitivity."""
    organization = resolve(organization)
    p_pd = pd_sensitivity_watts(
        bits, datarate_gs * 1e9, params, snr_margin_db=snr_margin_db
    )
    if math.isinf(p_pd):
        return 0
    p_pd_dbm = watts_to_dbm(p_pd)
    best = 0
    for n in range(1, params.fsr_limited_n + 1):
        if (
            output_power_dbm(
                n, n, organization, params, org_aware_through=org_aware_through
            )
            >= p_pd_dbm
        ):
            best = n
        else:
            # P_O/p is monotonically decreasing in N -> can stop early.
            break
    return best


def scalability_table(
    params: PhotonicParams,
    *,
    bits: Iterable[int] = range(1, 9),
    datarates_gs: Iterable[float] = (1, 5, 10),
    organizations: "Iterable[str | OrgSpec]" = ORGANIZATIONS,
    snr_margin_db: float = 0.0,
) -> Dict[Tuple[str, float, int], int]:
    """Fig. 5 — N for every (organization, DR, B); keyed by canonical name."""
    out = {}
    for org, dr, b in itertools.product(organizations, datarates_gs, bits):
        out[(resolve(org).name, dr, b)] = max_dpu_size(
            org, b, dr, params, snr_margin_db=snr_margin_db
        )
    return out


# ---------------------------------------------------------------------------
# Calibration of under-specified parameters against Table V
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CalibrationResult:
    params: PhotonicParams
    snr_margin_db: float
    mean_abs_rel_err: float
    per_cell: Dict[Tuple[str, int], Tuple[int, int]]  # (ours, paper)
    org_aware_through: bool = True


def calibrate(
    base: PhotonicParams | None = None,
    *,
    d_mrr_grid: Tuple[float, ...] = (0.005, 0.01, 0.02, 0.05),
    bw_divisor_grid: Tuple[float, ...] = (1.0, math.sqrt(2.0), 2.0),
    smf_att_grid: Tuple[float, ...] = (0.0, 0.5, 1.0),
    margin_grid: Tuple[float, ...] = (0.0, 1.0, 2.0, 3.0),
    through_grid: Tuple[bool, ...] = (True, False),
) -> CalibrationResult:
    """Grid-search the untabulated parameters to match Table V."""
    base = base or PhotonicParams()
    best: CalibrationResult | None = None
    for d_mrr, bw_div, smf, margin, th in itertools.product(
        d_mrr_grid, bw_divisor_grid, smf_att_grid, margin_grid, through_grid
    ):
        params = dataclasses.replace(
            base, d_mrr_mm=d_mrr, bw_divisor=bw_div, p_smf_att_db=smf
        )
        per_cell = {}
        err = 0.0
        for (org, dr), n_paper in TABLE_V_N.items():
            n_ours = max_dpu_size(
                org, 4, dr, params, snr_margin_db=margin, org_aware_through=th
            )
            per_cell[(org, dr)] = (n_ours, n_paper)
            err += abs(n_ours - n_paper) / n_paper
        err /= len(TABLE_V_N)
        if best is None or err < best.mean_abs_rel_err:
            best = CalibrationResult(params, margin, err, per_cell, th)
    assert best is not None
    return best


# Calibrated operating point, frozen at import (cheap: ~300 grid points of a
# closed-form solve).  tests/test_scalability.py re-derives it and checks the
# Table V match stays within tolerance.
_CALIBRATION = calibrate()
CALIBRATED = _CALIBRATION.params


def calibration() -> CalibrationResult:
    return _CALIBRATION


def calibrated_max_n(
    organization: "str | OrgSpec",
    bits: float,
    datarate_gs: float,
    *,
    platform: "str | _platforms.PlatformSpec" = "SOI",
) -> int:
    """Achievable DPU size N at the calibrated operating point.

    ``platform`` applies a :class:`repro.platforms.PlatformSpec` over the
    calibrated parameters (loss fields only — the Table-V-calibrated
    margins and under-specified fields are platform-independent), so the
    SOI default reproduces the paper's Table V exactly and SiN answers
    "how far does the same calibration scale on a lower-loss platform".
    """
    params = _platforms.resolve(platform).apply(CALIBRATED)
    return max_dpu_size(
        organization,
        bits,
        datarate_gs,
        params,
        snr_margin_db=_CALIBRATION.snr_margin_db,
        org_aware_through=_CALIBRATION.org_aware_through,
    )


def table_v() -> Dict[Tuple[str, int], int]:
    """Our reproduction of Table V's N row (B=4)."""
    return {(org, dr): calibrated_max_n(org, 4, dr) for (org, dr) in TABLE_V_N}
