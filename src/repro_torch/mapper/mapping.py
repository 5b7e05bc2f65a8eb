"""Private copy of ``repro.mapper.mapping`` for the PyTorch port (``import
repro_torch`` loads nothing of ``repro``); it differs in intra-package
imports and in one respelling: the analysis rule RPR010 exempts only the
reference's paths, so each timing attribute that enters arithmetic is bound
to a local first (same float operations in the same order).

Tile mapper: place a workload graph's GEMM tiles onto a DPU pool.

The mapper owns every *decision* of the schedule; the event engine
(:mod:`repro.mapper.timeline`) merely executes it.  Per node it fixes:

* the weight tiling — ``ceil(k/N)`` psum chunks x ``ceil(cols/M)`` output
  column tiles x ``passes`` bit-slice passes (depthwise: one k-dot per
  DPE, ``M`` channels per tile), identical to the paper's §V-B
  decomposition;
* the *effective symbol time* — chunked dots pace at the 320 MHz psum
  FIFO unless :attr:`MapperOptions.overlap_reduce` double-buffers the
  digital accumulation behind the analog stream;
* the *replication factor* — how many DPUs co-serve one output-column
  tile by splitting the streamed rows.  Each replica re-programs the
  full weight-tile chain, so replication is priced with the
  weight-stationary reprogram cost the engine's prepacking already
  models (:func:`repro.photonic.packing.reprogram_cost`, surfaced as
  :meth:`AcceleratorConfig.weight_reprogram_cost`): a replica is only
  admitted while its streamed time covers
  ``reprogram_amortization x`` its tuning time.

Degenerate contract (DESIGN.md §16): ``MapperOptions.degenerate()`` —
batch=1, no replication, no overlap, per-node barriers on a single
:meth:`DpuPool.from_config` pool — reproduces
:func:`repro.core.simulator.simulate` bit-for-bit; the expressions below
are spelled exactly like the legacy event loop's so every float rounds
identically.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.perfmodel import AcceleratorConfig, area_matched_count
from repro_torch.mapper.workload import GemmNode


@dataclasses.dataclass(frozen=True)
class DpuPool:
    """A pool of identical DPUs executing one accelerator configuration.

    The stored config is normalized so ``cfg.dpu_count == size`` — the
    power/area model and the scheduler always describe the same silicon.
    """

    cfg: AcceleratorConfig

    def __post_init__(self):
        if self.cfg.dpu_count < 1:
            raise ValueError(f"empty DPU pool: dpu_count={self.cfg.dpu_count}")

    @property
    def size(self) -> int:
        return self.cfg.dpu_count

    @classmethod
    def from_config(
        cls, cfg: AcceleratorConfig, size: Optional[int] = None
    ) -> "DpuPool":
        """Pool over ``cfg``'s DPUs (``size`` overrides ``dpu_count``)."""
        if size is not None and size != cfg.dpu_count:
            cfg = dataclasses.replace(cfg, dpu_count=size)
        return cls(cfg)

    @classmethod
    def area_matched(
        cls,
        organization,
        datarate_gs: float,
        *,
        bits: int = 4,
        platform="SOI",
        target_area_mm2: Optional[float] = None,
    ) -> "DpuPool":
        """Pool sized to the paper's silicon budget: the calibrated
        operating point for ``organization`` on ``platform``, with the DPU
        count area-matched to ``target_area_mm2`` (default: the paper's
        SOI SMWA configuration at this datarate — the same equal-area
        construction as Fig. 7 / ``benchmarks/org_design_space.py``)."""
        if target_area_mm2 is None:
            target_area_mm2 = AcceleratorConfig.from_paper(
                "SMWA", datarate_gs
            ).total_area_mm2()
        cfg = AcceleratorConfig.from_scalability(
            organization, datarate_gs, bits=bits, platform=platform
        )
        return cls.from_config(cfg, size=area_matched_count(cfg, target_area_mm2))


@dataclasses.dataclass(frozen=True)
class MapperOptions:
    """Scheduling policy knobs (defaults = the full scheduler).

    ``batch``                  — inferences streamed per programmed tile
                                 (input batching; rows multiply).
    ``replicate``              — split a tile's rows over idle DPUs
                                 (priced by reprogram amortization).
    ``overlap_reduce``         — double-buffer the digital psum
                                 accumulation behind the analog stream
                                 (chunked dots stop pacing at the FIFO).
    ``cross_layer``            — schedule the DAG with dependency edges
                                 instead of per-node barriers.
    ``reprogram_amortization`` — minimum streamed-time : reprogram-time
                                 ratio a replica must sustain (>= 1 keeps
                                 every admitted DPU streaming at least as
                                 long as it tunes).
    """

    batch: int = 1
    replicate: bool = True
    overlap_reduce: bool = True
    cross_layer: bool = True
    reprogram_amortization: float = 1.0

    def __post_init__(self):
        if self.batch < 1:
            raise ValueError(f"batch must be >= 1, got {self.batch}")
        if self.reprogram_amortization <= 0.0:
            raise ValueError(
                f"reprogram_amortization must be > 0, "
                f"got {self.reprogram_amortization}"
            )

    @classmethod
    def degenerate(cls) -> "MapperOptions":
        """The legacy schedule: batch-1, one tile chain per column tile,
        FIFO-paced chunked dots, layer-at-a-time barriers.  Contract:
        bit-for-bit equal to ``repro.core.simulator.simulate``."""
        return cls(
            batch=1, replicate=False, overlap_reduce=False, cross_layer=False
        )


@dataclasses.dataclass(frozen=True)
class NodeTiling:
    """The mapper's placement decision for one GEMM node."""

    node: GemmNode
    chunks: int                  # psum chunks: ceil(k / N)
    col_tiles: int               # output column tiles: ceil(cols / M)
    passes: int                  # bit-slice pass pairs
    replicas: int                # DPUs co-serving one column tile
    row_blocks: Tuple[int, ...]  # streamed rows per replica (sums to rows)
    sym_eff: float               # effective symbol time (FIFO pacing)
    tune_s: float                # reprogram latency per weight tile
    tile_energy_j: float         # reprogram energy per weight tile
    outputs: int                 # output words (incl. batch)
    psums_per_output: int

    @property
    def tiles(self) -> int:
        """Weight tiles programmed (chunks x col_tiles x passes x replicas)."""
        return self.chunks * self.col_tiles * self.passes * self.replicas

    @property
    def chains(self) -> int:
        """Independent serial tile chains dispatched to the pool."""
        return self.col_tiles * self.replicas

    def chain_duration_s(self, rows_block: int) -> float:
        """Serial duration of one column tile's chain on one DPU: program +
        stream, for every chunk of every pass (spelled exactly like the
        legacy simulator's ``serial_dur`` — bitwise contract)."""
        tune_s = self.tune_s
        return self.chunks * self.passes * (tune_s + rows_block * self.sym_eff)


def _split_rows(rows: int, replicas: int) -> Tuple[int, ...]:
    base, rem = divmod(rows, replicas)
    return tuple(base + 1 if i < rem else base for i in range(replicas))


def _choose_replicas(
    rows_total: int,
    col_tiles: int,
    pool_size: int,
    tune_s: float,
    sym_eff: float,
    options: MapperOptions,
) -> int:
    """Row-split replication factor, priced by reprogram amortization.

    Replicas beyond ``pool_size // col_tiles`` would queue behind the
    first wave (no throughput win); replicas whose row block streams for
    less than ``reprogram_amortization x tune_s`` spend more time
    re-programming weights than computing — the weight-stationary cost
    model says they are not worth their laser power.
    """
    if not options.replicate or rows_total <= 1:
        return 1
    cap = max(1, pool_size // max(col_tiles, 1))
    cap = min(cap, rows_total)
    if tune_s > 0.0 and cap > 1:
        amort = int(
            rows_total * sym_eff / (options.reprogram_amortization * tune_s)
        )
        cap = min(cap, max(1, amort))
    return cap


def tile_node(
    node: GemmNode, cfg: AcceleratorConfig, pool_size: int, options: MapperOptions
) -> NodeTiling:
    """Tile one GEMM node for ``cfg`` and fix its placement decision."""
    p = cfg.peripherals
    sym = cfg.symbol_s
    rows_total = node.rows * options.batch

    if node.groups == 1:
        chunks = -(-node.k // cfg.n)
        col_tiles = -(-node.cols // cfg.m)
        psums_per_output = chunks * cfg.passes
        outputs = rows_total * node.cols
    else:
        # Depthwise: each output channel is an independent k-dot; a DPE
        # holds one dot -> M channels per DPU tile-slot (N-9 rings idle).
        chunks = 1
        col_tiles = -(-node.groups // cfg.m)
        psums_per_output = cfg.passes
        outputs = rows_total * node.groups

    # Chunked dots pace at the psum-reduction FIFO clock unless the
    # digital accumulation is double-buffered behind the analog stream.
    if chunks > 1 and not options.overlap_reduce:
        sym_eff = max(sym, p.reduction_network.latency_s)
    else:
        sym_eff = sym

    cost = cfg.weight_reprogram_cost(groups=node.groups)
    replicas = _choose_replicas(
        rows_total, col_tiles, pool_size, cost.latency_s, sym_eff, options
    )
    return NodeTiling(
        node=node,
        chunks=chunks,
        col_tiles=col_tiles,
        passes=cfg.passes,
        replicas=replicas,
        row_blocks=_split_rows(rows_total, replicas),
        sym_eff=sym_eff,
        tune_s=cost.latency_s,
        tile_energy_j=cost.energy_j,
        outputs=outputs,
        psums_per_output=psums_per_output,
    )
