"""Private copy of ``repro.mapper`` for the PyTorch port (``import
repro_torch`` loads nothing of ``repro``); only intra-package imports
differ.

repro.mapper — multi-DPU tile-level workload scheduler (DESIGN.md §16).

Lowers CNN layer lists and LM configs to a tiled-GEMM DAG
(:mod:`repro.mapper.workload`), places tiles onto an area-matched DPU
pool with batching / replication / overlap decisions
(:mod:`repro.mapper.mapping`), and executes the event timeline
(:mod:`repro.mapper.timeline`).  ``MapperOptions.degenerate()``
reproduces ``repro.core.simulator.simulate`` bit-for-bit.
"""

from repro_torch.mapper.mapping import DpuPool, MapperOptions, NodeTiling, tile_node
from repro_torch.mapper.timeline import NodeSchedule, Timeline, map_workload
from repro_torch.mapper.workload import GemmNode, WorkloadGraph

__all__ = [
    "DpuPool",
    "GemmNode",
    "MapperOptions",
    "NodeSchedule",
    "NodeTiling",
    "Timeline",
    "WorkloadGraph",
    "map_workload",
    "tile_node",
]
