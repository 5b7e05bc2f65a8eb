"""Private copy of ``repro.core.organizations`` for the PyTorch port (``import
repro_torch`` loads nothing of ``repro``); only intra-package imports
differ; organizations resolve through ``repro_torch.orgs``.

DPU organizations (paper §III) and their circuit-level properties.

The paper classifies incoherent MRR-based DPUs by the order in which the four
optical-channel manipulation blocks appear:

* **ASMW** — Aggregation, Splitting, Modulation, Weighting
  (Crosslight, DEAP-CNN, Robin, RAMM)
* **MASW** — Modulation, Aggregation, Splitting, Weighting
  (Holylight, Yang, Al-Qadasi, PCNNA, RMAM)
* **SMWA** — Splitting, Modulation, Weighting, Aggregation ("hitless")
  (Hitless, ADEPT, Albireo)

Since PR 5 the block order itself is the API: :mod:`repro.orgs` defines the
typed :class:`~repro.orgs.OrgSpec` whose crosstalk (Table II), loss
structure (Table III), and lumped penalty (Table IV) are *derived* from the
order by structural rules (DESIGN.md §11) instead of looked up.  This
module keeps the historical table-shaped views — ``CROSSTALK`` / ``LOSSES``
/ ``BLOCK_ORDERS`` / ``through_device_count`` — as thin projections of the
derived profiles (tested equal to the paper tables in
``tests/test_orgs.py``), plus the structural penalty decomposition used by
the circuit-level analysis benchmark.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Mapping, Union

from repro_torch import orgs
from repro_torch.core.params import PhotonicParams
from repro_torch.orgs import (  # noqa: F401  (re-exported compatibility surface)
    AGG,
    EFFECT_BUDGET_DB,
    MOD,
    ORGANIZATIONS,
    SPLIT,
    SUM,
    WEIGHT,
    CrosstalkProfile,
    LossProfile,
    OrgSpec,
)

class _RegistryView(Mapping):
    """Live name-keyed view over the org registry (one projected field per
    spec).  A mapping rather than a dict snapshot so organizations added
    via :func:`repro.orgs.register` after import appear here too."""

    def __init__(self, project: Callable[[OrgSpec], object]):
        self._project = project

    def __getitem__(self, name: str):
        return self._project(orgs.registered()[name])

    def __iter__(self) -> Iterator[str]:
        return iter(orgs.registered())

    def __len__(self) -> int:
        return len(orgs.registered())

    def __repr__(self) -> str:
        return repr(dict(self))


BLOCK_ORDERS: Mapping[str, tuple] = _RegistryView(lambda s: s.blocks)

# Prior-work classification (paper Table I).
PRIOR_WORK: Mapping[str, tuple] = _RegistryView(orgs.prior_work)

# Table II / Table III, derived from the block orders (asserted equal to the
# paper's hand-tabulated values in tests/test_orgs.py).
CROSSTALK: Mapping[str, CrosstalkProfile] = _RegistryView(lambda s: s.crosstalk)

LOSSES: Mapping[str, LossProfile] = _RegistryView(lambda s: s.losses)


def through_device_count(organization: Union[str, OrgSpec], n: int) -> int:
    """Out-of-resonance devices traversed by one channel (paper §IV-B1)."""
    return orgs.resolve(organization).through_device_count(n)


def structural_penalty_db(
    organization: Union[str, OrgSpec],
    n: int,
    params: PhotonicParams,
) -> Dict[str, float]:
    """Per-effect penalty decomposition (beyond-paper structural model).

    The paper lumps crosstalk + filter + propagation into ``P_penalty``
    (Table IV).  This reconstructs the composition from the per-effect
    budgets of §IV-C and the structural loss model of §IV-B, so the
    circuit-level analysis benchmark can show *where* each organization's
    penalty comes from.  ``sum(values)`` approximates Table IV's lumped value
    at the paper's operating point.
    """
    spec = orgs.resolve(organization)
    parts = {
        "inter_modulation": (
            EFFECT_BUDGET_DB["inter_modulation"] if spec.inter_modulation else 0.0
        ),
        "cross_weight": (
            EFFECT_BUDGET_DB["cross_weight"] if spec.cross_weight else 0.0
        ),
        "filter_truncation": (
            EFFECT_BUDGET_DB["filter_truncation"] if spec.filter_truncation else 0.0
        ),
        # Propagation beyond the per-ring term already in Eq. 3: scaled by the
        # organization's extra waveguide length.
        "propagation": params.p_si_att_db_per_mm
        * spec.waveguide_length_factor
        * n
        * params.d_mrr_mm,
        # Through-loss differential vs the generic (N-1)+(N-1) terms of Eq.3.
        "through_delta": (spec.through_device_count(n) - 2 * (n - 1))
        * params.p_mrm_obl_db,
    }
    return parts


def lumped_penalty_db(
    organization: Union[str, OrgSpec], params: PhotonicParams
) -> float:
    """The paper's Table IV P_penalty — what Eq. 3 / Table V actually use."""
    return params.penalty_db(organization)
