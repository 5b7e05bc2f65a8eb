"""Private copy of ``repro.mapper.timeline`` for the PyTorch port (``import
repro_torch`` loads nothing of ``repro``); it differs in intra-package
imports and in one respelling: the analysis rule RPR010 exempts only the
reference's paths, so each timing attribute that enters arithmetic is bound
to a local first (same float operations in the same order).

Event-timeline simulator: execute a mapped workload on a DPU pool.

Two scheduling regimes share the per-node accounting:

* **barrier** (``options.cross_layer=False``) — nodes run one at a time
  in topological order; each node is scheduled in its own local clock
  (greedy earliest-free-DPU dispatch over the pool, exactly the paper's
  §V-B event loop) and the makespan is the sum of node times.  With
  ``MapperOptions.degenerate()`` this path re-derives
  ``repro.core.simulator.simulate`` bit-for-bit — every expression below
  is spelled like the legacy ``_simulate_layer`` so the floats round
  identically (DESIGN.md §16 contract).
* **dag** (``options.cross_layer=True``) — one global event clock; a
  node's chains become dispatchable when every producer has drained, so
  parallel branches (inception-style columns, attention QKV fan-out,
  shared-expert banks) and successive batches genuinely overlap and the
  extra DPUs of cheap organizations can be fed.

Energy accounting is identical in both regimes (same component formulas,
applied to the same tile counts); only *when* tiles run differs.  Static
power integrates over the makespan, which is how idle silicon — the
batch-1 killer of area-matched many-DPU organizations — prices itself.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Tuple

from repro_torch.core.perfmodel import AcceleratorConfig
from repro_torch.mapper.mapping import DpuPool, MapperOptions, NodeTiling, tile_node
from repro_torch.mapper.workload import WorkloadGraph


@dataclasses.dataclass(frozen=True)
class NodeSchedule:
    """Realized schedule of one GEMM node."""

    name: str
    site: Optional[str]
    start_s: float      # earliest chain dispatch (cumulative offset in barrier mode)
    time_s: float       # stream + drain latency attributed to this node
    stream_s: float     # last chain drain (node-local clock in barrier mode)
    reduce_s: float     # stream throttle attributable to the psum FIFO clock
    tune_s: float       # pool-amortized reprogram latency
    energy_j: float
    psums: int
    tiles: int          # weight tiles programmed
    chains: int         # serial tile chains dispatched
    replicas: int       # row-split DPUs per column tile


@dataclasses.dataclass(frozen=True)
class Timeline:
    """Per-DPU, per-node realized schedule of one workload on one pool."""

    workload: str
    pool: DpuPool
    options: MapperOptions
    nodes: Tuple[NodeSchedule, ...]
    makespan_s: float
    dynamic_energy_j: float
    static_power_w: float
    busy_per_dpu: Tuple[float, ...]

    # -- derived metrics (the ONLY blessed FPS/energy aggregation surface;
    # rule RPR010 keeps ad-hoc re-derivations out of the tree) ------------
    @property
    def batch(self) -> int:
        return self.options.batch

    @property
    def fps(self) -> float:
        """Inferences per second (batch inferences per makespan)."""
        makespan = self.makespan_s
        return self.options.batch / makespan

    @property
    def avg_power_w(self) -> float:
        energy, makespan = self.dynamic_energy_j, self.makespan_s
        return self.static_power_w + energy / makespan

    @property
    def fps_per_w(self) -> float:
        return self.fps / self.avg_power_w

    @property
    def energy_per_inference_j(self) -> float:
        energy = self.dynamic_energy_j
        return energy / self.options.batch

    @property
    def utilization(self) -> Tuple[float, ...]:
        makespan = self.makespan_s
        return tuple(b / makespan for b in self.busy_per_dpu)

    @property
    def mean_utilization(self) -> float:
        makespan = self.makespan_s
        return sum(self.busy_per_dpu) / (makespan * len(self.busy_per_dpu))

    def to_dict(self) -> dict:
        """JSON-serializable record (the benchmark/CI timeline artifact)."""
        util = self.utilization
        return {
            "workload": self.workload,
            "organization": self.pool.cfg.organization,
            "platform": self.pool.cfg.platform,
            "datarate_gs": self.pool.cfg.datarate_gs,
            "n": self.pool.cfg.n,
            "pool_size": self.pool.size,
            "options": dataclasses.asdict(self.options),
            "makespan_s": self.makespan_s,
            "fps": self.fps,
            "fps_per_w": self.fps_per_w,
            "avg_power_w": self.avg_power_w,
            "dynamic_energy_j": self.dynamic_energy_j,
            "static_power_w": self.static_power_w,
            "mean_utilization": self.mean_utilization,
            "utilization": [round(u, 6) for u in util],
            "nodes": [
                {
                    "name": ns.name,
                    "site": ns.site,
                    "start_s": ns.start_s,
                    "time_s": ns.time_s,
                    "energy_j": ns.energy_j,
                    "tiles": ns.tiles,
                    "chains": ns.chains,
                    "replicas": ns.replicas,
                }
                for ns in self.nodes
            ],
        }

    def utilization_table(self, max_rows: int = 16, width: int = 40) -> str:
        """Human-readable per-DPU utilization table (example/driver output)."""
        util = self.utilization
        makespan = self.makespan_s
        lines = [
            f"pool: {self.pool.size} x {self.pool.cfg.organization} "
            f"N={self.pool.cfg.n} ({self.pool.cfg.platform}, "
            f"{self.pool.cfg.datarate_gs:g} GS/s)   batch={self.batch}",
            f"makespan {makespan * 1e3:.3f} ms   fps {self.fps:.1f}   "
            f"fps/W {self.fps_per_w:.3f}   mean util {self.mean_utilization:.1%}",
        ]
        step = max(1, len(util) // max_rows)
        for d0 in range(0, len(util), step):
            group = util[d0 : d0 + step]
            u = sum(group) / len(group)
            bar = "#" * int(u * width)
            d1 = min(d0 + step, len(util)) - 1
            label = f"dpu {d0}" if step == 1 else f"dpu {d0}-{d1}"
            lines.append(f"  {label:>12}  {u:7.1%}  |{bar:<{width}}|")
        return "\n".join(lines)


def map_workload(
    graph: WorkloadGraph,
    pool: DpuPool,
    options: MapperOptions = MapperOptions(),
) -> Timeline:
    """Map ``graph`` onto ``pool`` and simulate the event timeline."""
    cfg = pool.cfg
    order = graph.topological()
    tilings = {node.name: tile_node(node, cfg, pool.size, options) for node in order}
    if options.cross_layer:
        return _run_dag(graph, pool, options, tilings)
    return _run_barrier(graph, pool, options, tilings)


# ---------------------------------------------------------------------------
# Shared per-node accounting (bitwise-pinned against the legacy simulator)
# ---------------------------------------------------------------------------
def _node_energy_j(tl: NodeTiling, cfg: AcceleratorConfig, busy_s: float) -> float:
    """Dynamic energy of one node, spelled exactly like the legacy layer
    accounting (association order matters: bitwise contract)."""
    p = cfg.peripherals
    stream_energy = busy_s * cfg.streaming_power_w()
    tune_energy = tl.tiles * tl.tile_energy_j
    reductions = (
        tl.outputs * (tl.psums_per_output - 1) if tl.psums_per_output > 1 else 0
    )
    red_energy = (
        reductions * p.reduction_network.power_w * p.reduction_network.latency_s
    )
    total_psums = tl.outputs * tl.psums_per_output
    mem_energy = total_psums * (
        p.edram.power_w * p.edram.latency_s + p.bus.power_w * p.bus.latency_s / cfg.m
    )
    act_energy = tl.outputs * p.activation_unit.power_w * p.activation_unit.latency_s
    return stream_energy + tune_energy + red_energy + mem_energy + act_energy


def _node_reduce_s(tl: NodeTiling, cfg: AcceleratorConfig) -> float:
    """Stream throttle attributable to the psum FIFO clock (report-only)."""
    if tl.chunks <= 1:
        return 0.0
    rows_total = sum(tl.row_blocks)
    return (tl.sym_eff - cfg.symbol_s) * rows_total * tl.chunks * tl.passes


# ---------------------------------------------------------------------------
# Barrier regime — node-local clocks, makespan = sum of node times
# ---------------------------------------------------------------------------
def _run_barrier(
    graph: WorkloadGraph,
    pool: DpuPool,
    options: MapperOptions,
    tilings: Dict[str, NodeTiling],
) -> Timeline:
    cfg = pool.cfg
    p = cfg.peripherals
    busy_per_dpu = [0.0] * pool.size
    cursor = 0.0  # sum of node times so far (legacy: sum(l.time_s))
    energy_total = 0.0
    scheds: List[NodeSchedule] = []

    for node in graph.topological():
        tl = tilings[node.name]
        tile_tune_s = tl.tune_s
        heap = [(0.0, d) for d in range(pool.size)]
        heapq.heapify(heap)
        end = 0.0
        busy_s = 0.0
        for rows_block in tl.row_blocks:
            dur = tl.chain_duration_s(rows_block)
            for _ in range(tl.col_tiles):
                free, d = heapq.heappop(heap)
                fin = free + dur
                busy_s += dur
                busy_per_dpu[d] += dur
                end = max(end, fin)
                heapq.heappush(heap, (fin, d))
        stream_s = end
        time_s = stream_s + p.reduction_network.latency_s
        energy = _node_energy_j(tl, cfg, busy_s)
        scheds.append(
            NodeSchedule(
                name=node.name,
                site=node.site,
                start_s=cursor,
                time_s=time_s,
                stream_s=stream_s,
                reduce_s=_node_reduce_s(tl, cfg),
                tune_s=tl.tiles * tile_tune_s / pool.size,
                energy_j=energy,
                psums=tl.outputs * tl.psums_per_output,
                tiles=tl.tiles,
                chains=tl.chains,
                replicas=tl.replicas,
            )
        )
        cursor += time_s
        energy_total += energy

    return Timeline(
        workload=graph.name,
        pool=pool,
        options=options,
        nodes=tuple(scheds),
        makespan_s=cursor,
        dynamic_energy_j=energy_total,
        static_power_w=cfg.static_power_w(),
        busy_per_dpu=tuple(busy_per_dpu),
    )


# ---------------------------------------------------------------------------
# DAG regime — one global event clock, dependency-gated dispatch
# ---------------------------------------------------------------------------
def _run_dag(
    graph: WorkloadGraph,
    pool: DpuPool,
    options: MapperOptions,
    tilings: Dict[str, NodeTiling],
) -> Timeline:
    cfg = pool.cfg
    p = cfg.peripherals
    busy_per_dpu = [0.0] * pool.size
    heap = [(0.0, d) for d in range(pool.size)]
    heapq.heapify(heap)
    finish: Dict[str, float] = {}
    energy_total = 0.0
    makespan = 0.0
    scheds: List[NodeSchedule] = []

    for node in graph.topological():
        tl = tilings[node.name]
        tile_tune_s = tl.tune_s
        ready = max((finish[dep] for dep in node.deps), default=0.0)
        node_start = None
        node_end = 0.0
        busy_s = 0.0
        for rows_block in tl.row_blocks:
            dur = tl.chain_duration_s(rows_block)
            for _ in range(tl.col_tiles):
                free, d = heapq.heappop(heap)
                start = max(free, ready)
                fin = start + dur
                busy_s += dur
                busy_per_dpu[d] += dur
                node_start = start if node_start is None else min(node_start, start)
                node_end = max(node_end, fin)
                heapq.heappush(heap, (fin, d))
        node_finish = node_end + p.reduction_network.latency_s
        finish[node.name] = node_finish
        makespan = max(makespan, node_finish)
        energy = _node_energy_j(tl, cfg, busy_s)
        energy_total += energy
        scheds.append(
            NodeSchedule(
                name=node.name,
                site=node.site,
                start_s=node_start if node_start is not None else ready,
                time_s=node_finish - (node_start if node_start is not None else ready),
                stream_s=node_end,
                reduce_s=_node_reduce_s(tl, cfg),
                tune_s=tl.tiles * tile_tune_s / pool.size,
                energy_j=energy,
                psums=tl.outputs * tl.psums_per_output,
                tiles=tl.tiles,
                chains=tl.chains,
                replicas=tl.replicas,
            )
        )

    return Timeline(
        workload=graph.name,
        pool=pool,
        options=options,
        nodes=tuple(scheds),
        makespan_s=makespan,
        dynamic_energy_j=energy_total,
        static_power_w=cfg.static_power_w(),
        busy_per_dpu=tuple(busy_per_dpu),
    )
