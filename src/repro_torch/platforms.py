"""Private copy of ``repro.platforms`` for the PyTorch port (``import repro_torch``
loads nothing of ``repro``); only intra-package imports differ.

First-class photonic platform specs (SOI + SiN presets).

The source paper anchors every loss number to a silicon-on-insulator
(SOI) process (Table IV, credited to [27]/[12]); the 4-bit ENOB wall that
saturates LM serving in ``benchmarks/org_accuracy.py`` is an SOI wall,
not a law of incoherent photonics.  Sibling work (arXiv 2402.11047)
builds the same microring GEMM fabric on silicon nitride, whose ~10x
lower propagation loss and far gentler ring insertion loss deliver more
optical power to the detector — a larger achievable N and a lower
detector sigma at the same geometry.

:class:`PlatformSpec` makes the material platform the API, exactly as
:class:`repro.orgs.OrgSpec` does for the block order: a frozen, hashable
spec holding the platform-owned fields of Eq. 1-3 (propagation /
through / coupling / ring insertion losses), the laser wall-plug
efficiency used by the accelerator power model, and the ring tuning
powers.  Everything platform-typed funnels through :func:`resolve` — the
single ``str | PlatformSpec`` resolution point used by
``build_channel_model``, ``DPUConfig``, ``AcceleratorConfig``, and the
scalability solver (RPR009 forbids ad-hoc case normalization of platform
strings anywhere else, mirroring RPR002 for organizations).

A spec is *applied* to a :class:`repro.core.params.PhotonicParams` via
:meth:`PlatformSpec.apply`, which replaces only the platform-owned loss
fields and leaves the Table-V-calibrated fields (``p_smf_att_db``,
``d_mrr_mm``, ``bw_divisor``) untouched.  The SOI preset is field-for-
field identical to the Table IV defaults, so ``SOI.apply(params) ==
params`` and every pre-platform call site is bitwise unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, Union

if TYPE_CHECKING:  # pragma: no cover - import cycle guard (params is a leaf)
    from repro_torch.core.params import PhotonicParams


@dataclasses.dataclass(frozen=True)
class PlatformSpec:
    """A photonic material platform (frozen, hashable).

    Fields mirror the platform-owned subset of ``PhotonicParams`` (same
    units), plus the wall-plug efficiency and ring tuning powers consumed
    by ``repro.core.perfmodel``.  ``name`` is the canonical upper-case
    identity; two specs with the same name must be equal (enforced by
    :func:`register`).
    """

    name: str
    description: str = ""
    citation: str = ""
    # Eq. 1-3 loss fields (platform-owned subset of PhotonicParams) ---------
    propagation_loss_db_per_mm: float = 0.3   # waveguide loss [dB/mm]
    coupling_loss_db: float = 1.44            # fiber->chip coupling IL [dB]
    splitter_loss_db: float = 0.01            # per 1x2 splitter stage [dB]
    mrm_il_db: float = 4.0                    # modulator ring IL [dB]
    mrr_w_il_db: float = 0.01                 # weight ring IL [dB]
    mrm_through_db: float = 0.01              # MRM out-of-band (through) [dB]
    mrr_w_through_db: float = 0.01            # weight-MRR through [dB]
    # Accelerator power model (repro.core.perfmodel) ------------------------
    laser_wallplug_eff: float = 0.2           # electrical->optical efficiency
    eo_tuning_w_per_fsr: float = 80e-6        # EO ring tuning power [W/FSR]
    to_tuning_w_per_fsr: float = 275e-3       # thermal ring tuning [W/FSR]

    def __post_init__(self):
        if self.name != _normalize_platform(self.name):
            raise ValueError(
                f"platform name {self.name!r} is not canonical; use "
                f"{_normalize_platform(self.name)!r}"
            )

    def apply(self, params: "PhotonicParams") -> "PhotonicParams":
        """``params`` with the platform-owned fields replaced.

        Only the loss fields and the wall-plug efficiency change; the
        Table-V-calibrated under-specified fields and every
        non-platform field (detector, RIN, spectral grid, penalties)
        pass through untouched.  Idempotent, and the identity for the
        platform a ``PhotonicParams`` already describes.
        """
        return dataclasses.replace(
            params,
            p_ec_il_db=self.coupling_loss_db,
            p_si_att_db_per_mm=self.propagation_loss_db_per_mm,
            p_splitter_il_db=self.splitter_loss_db,
            p_mrm_il_db=self.mrm_il_db,
            p_mrr_w_il_db=self.mrr_w_il_db,
            p_mrm_obl_db=self.mrm_through_db,
            p_mrr_w_obl_db=self.mrr_w_through_db,
            laser_wallplug_eff=self.laser_wallplug_eff,
        )

    def __str__(self) -> str:
        return self.name


def _normalize_platform(name: str) -> str:
    """Canonicalize a platform string (strip + casefold to upper).

    THE single blessed normalization site for platform-typed strings:
    :func:`resolve` and :class:`PlatformSpec` validation both route
    through it, so case handling cannot drift between entry points
    (RPR009 forbids ad-hoc ``.upper()`` on platform strings anywhere
    else, mirroring RPR002 for organization strings).
    """
    return name.strip().upper()


# ---------------------------------------------------------------------------
# Registry: the named platforms (paper SOI baseline + sibling-work SiN)
# ---------------------------------------------------------------------------
_REGISTRY: Dict[str, PlatformSpec] = {}


def register(spec: PlatformSpec) -> PlatformSpec:
    """Register ``spec`` under its canonical name; returns the spec.

    Re-registering an equal spec is a no-op; registering a *different*
    spec under an existing name raises (platform identity is the name,
    so a silent overwrite would fork the physics behind it).
    """
    existing = _REGISTRY.get(spec.name)
    if existing is not None and existing != spec:
        raise ValueError(
            f"platform {spec.name!r} is already registered with different "
            "fields; pick a new name instead of overwriting"
        )
    _REGISTRY[spec.name] = spec
    return spec


def registered() -> Dict[str, PlatformSpec]:
    """Snapshot of the registered platforms (name -> spec)."""
    return dict(_REGISTRY)


def resolve(platform: Union[str, "PlatformSpec"]) -> PlatformSpec:
    """THE ``str | PlatformSpec`` resolution point (case-insensitive).

    Accepts a spec (returned as-is) or a registered name; anything else
    raises ``ValueError`` naming the valid choices.  Every
    platform-typed entry point (``build_channel_model``, ``DPUConfig``,
    ``AcceleratorConfig``, ``calibrated_max_n``) funnels through here,
    so validation is eager and the error message is uniform.
    """
    if isinstance(platform, PlatformSpec):
        return platform
    if not isinstance(platform, str):
        raise ValueError(
            f"platform must be a str or PlatformSpec, got "
            f"{type(platform).__name__}"
        )
    spec = _REGISTRY.get(_normalize_platform(platform))
    if spec is None:
        raise ValueError(
            f"unknown platform {platform!r}: valid choices are "
            f"{tuple(sorted(_REGISTRY))}"
        )
    return spec


# The paper's SOI baseline: field-for-field identical to the Table IV
# defaults in PhotonicParams, so resolving/applying "SOI" is a no-op and
# the pre-platform behavior of every call site is preserved bitwise.
SOI = register(
    PlatformSpec(
        name="SOI",
        description="Silicon-on-insulator (paper Table IV baseline)",
        citation="arXiv 2402.03149 Table IV ([27] Al-Qadasi, [12] Vatsavai)",
    )
)

# Silicon nitride: the low-loss escape hatch from the SOI ENOB wall.
# Propagation ~0.03 dB/mm (an order below SOI's 0.3), gentler edge
# coupling, and a much lower modulator insertion loss; the cost is the
# weak thermo-optic coefficient — ring tuning takes ~4x the power and
# the EO effect is weaker still.
SIN = register(
    PlatformSpec(
        name="SIN",
        description="Silicon nitride (low-loss microring GEMM platform)",
        citation="arXiv 2402.11047",
        propagation_loss_db_per_mm=0.03,
        coupling_loss_db=1.0,
        splitter_loss_db=0.01,
        mrm_il_db=1.0,
        mrr_w_il_db=0.01,
        mrm_through_db=0.005,
        mrr_w_through_db=0.005,
        laser_wallplug_eff=0.2,
        eo_tuning_w_per_fsr=320e-6,
        to_tuning_w_per_fsr=1.1,
    )
)

# Registered platform names, baseline first.
PLATFORMS = ("SOI", "SIN")
