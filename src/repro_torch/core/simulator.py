"""Private copy of ``repro.core.simulator`` for the PyTorch port (``import
repro_torch`` loads nothing of ``repro``); it differs in intra-package
imports and in one respelling: the analysis rule RPR010 exempts only the
reference's paths, so each timing attribute that enters arithmetic is bound
to a local first (same float operations in the same order).

Transaction-level, event-driven simulator of the photonic GEMM
accelerator (paper §V-B: "custom, transaction-level, event-driven
Python-based simulator").

Execution model (output-stationary, batch=1 CNN inference):

* each layer's im2col GEMM is tiled into *weight tiles* — (psum-chunk of the
  k dimension) x (M output columns) — per bit-slice pass;
* a weight tile is programmed onto a DPU's weight MRRs (EO tuning latency),
  then the layer's `rows` input vectors stream through at the symbol rate,
  producing one psum per row per DPE;
* tiles are dispatched to the earliest-free DPU (greedy list scheduling via
  a heap — the transaction/event queue);
* psums funnel through each tile's electronic reduction network
  (Table VI latency/energy); reduction time overlaps streaming and the layer
  completes at max(stream, reduce) + drain;
* layers execute in dependency order (batch=1), energy integrates DAC/ADC
  streaming power, laser + peripheral static power, tuning and reduction
  energy, and eDRAM/NoC transfers for psums.

Depthwise convs map one k=9 dot per DPE (an analog DPE cannot share its
summation across independent dots), so large-N DPUs waste N-9 rings there —
the model charges full-DPE occupancy, matching the paper's observation that
psum/utilization effects, not raw N, drive the final FPS ordering.

Since PR 10 the event loop itself lives in :mod:`repro.mapper`:
``simulate`` *is* the mapper's degenerate schedule
(``MapperOptions.degenerate()`` — batch=1, no replication, no overlap,
layer-at-a-time barriers on one pool) and reproduces the pre-mapper
numbers bit-for-bit (DESIGN.md §16 contract; pinned by
``tests/test_mapper.py``).  Chunked dots pace at the psum-reduction
clock: every symbol's psum must round-trip the 320 MHz accumulation
FIFO (Table VI reduction network) before the next chunk's contribution
can merge, so the effective symbol time is max(1/DR, 3.125 ns) when
chunks > 1 — at high datarates the fixed reduction clock throttles
small-N organizations on every chunked layer, and N shrinks with
datarate (Table V), which is why absolute FPS *decreases* with DR for
all organizations (Fig. 7a).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.core.cnn_workloads import WORKLOADS
from repro_torch.core.perfmodel import AcceleratorConfig
from repro_torch.mapper import DpuPool, MapperOptions, WorkloadGraph, map_workload
from repro_torch.orgs import ORGANIZATIONS, resolve


@dataclasses.dataclass
class LayerStats:
    name: str
    time_s: float
    stream_s: float
    reduce_s: float
    tune_s: float
    energy_j: float
    psums: int
    tiles_dispatched: int


@dataclasses.dataclass
class SimResult:
    model: str
    config: AcceleratorConfig
    total_time_s: float
    dynamic_energy_j: float
    static_power_w: float
    layers: List[LayerStats]

    @property
    def fps(self) -> float:
        total = self.total_time_s
        return 1.0 / total

    @property
    def avg_power_w(self) -> float:
        energy, total = self.dynamic_energy_j, self.total_time_s
        return self.static_power_w + energy / total

    @property
    def fps_per_w(self) -> float:
        return self.fps / self.avg_power_w

    def fps_per_w_per_mm2(self) -> float:
        return self.fps_per_w / self.config.total_area_mm2()


def simulate(model: str, cfg: AcceleratorConfig) -> SimResult:
    """Batch-1 CNN inference = the mapper's degenerate schedule.

    The layer chain lowers to a :class:`~repro.mapper.WorkloadGraph`, the
    pool is ``cfg``'s own ``dpu_count`` DPUs, and the schedule is
    ``MapperOptions.degenerate()`` — which is contractually bit-for-bit
    the pre-PR-10 event loop (output-stationary greedy dispatch, FIFO-
    paced chunked dots, per-layer barriers).
    """
    graph = WorkloadGraph.from_layers(WORKLOADS[model](), name=model)
    timeline = map_workload(
        graph, DpuPool.from_config(cfg), MapperOptions.degenerate()
    )
    layers = [
        LayerStats(
            name=ns.name,
            time_s=ns.time_s,
            stream_s=ns.stream_s,
            reduce_s=ns.reduce_s,
            tune_s=ns.tune_s,
            energy_j=ns.energy_j,
            psums=ns.psums,
            tiles_dispatched=ns.tiles,
        )
        for ns in timeline.nodes
    ]
    return SimResult(
        model=model,
        config=cfg,
        total_time_s=timeline.makespan_s,
        dynamic_energy_j=timeline.dynamic_energy_j,
        static_power_w=timeline.static_power_w,
        layers=layers,
    )


def evaluate_all(
    organizations=ORGANIZATIONS,
    datarates=(1, 5, 10),
    models=tuple(WORKLOADS),
    use_paper_operating_points: bool = True,
    platform="SOI",
) -> Dict:
    """Fig. 7 sweep: (org x DR x CNN) -> SimResult.

    ``organizations`` accepts ``str | OrgSpec`` entries; results are keyed
    by the canonical order name.  Unstudied orderings — and any platform
    other than the SOI baseline (Table V *is* an SOI table) — require
    ``use_paper_operating_points=False`` so the operating point comes
    from the calibrated solver on that platform's loss chain.
    """
    from repro_torch import platforms as _platforms

    platform_name = _platforms.resolve(platform).name
    if use_paper_operating_points and platform_name != "SOI":
        raise ValueError(
            f"paper operating points are SOI-only (Table V); pass "
            f"use_paper_operating_points=False to sweep {platform_name!r}"
        )
    out = {}
    for org in organizations:
        name = resolve(org).name
        for dr in datarates:
            cfg = (
                AcceleratorConfig.from_paper(org, dr)
                if use_paper_operating_points
                else AcceleratorConfig.from_scalability(
                    org, dr, platform=platform_name
                )
            )
            for m in models:
                out[(name, dr, m)] = simulate(m, cfg)
    return out
