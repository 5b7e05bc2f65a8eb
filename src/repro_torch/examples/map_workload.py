"""Map real workloads onto an area-matched DPU pool with repro_torch.mapper.

Two end-to-end mappings, printing the per-DPU utilization table each
time:

1. a CNN (ResNet50's im2col GEMM chain from ``core/cnn_workloads``) on
   the paper's best organization (SMWA) and on the unstudied MWAS pool
   that area matching makes much larger, showing how input batching
   turns MWAS's idle silicon into throughput;
2. an LM (qwen2-0.5b's per-layer GEMM sites, lowered with the real
   attention/FFN dependency structure) on the same SMWA pool.

The mapper is analytic: it runs on the host whatever ``--device`` says.

Run:  PYTHONPATH=src python -m repro_torch.examples.map_workload [--device cpu]

Reference: ``examples/map_workload.py``.
"""

import argparse

from repro_torch._device import resolve_device
from repro_torch.core.cnn_workloads import WORKLOADS
from repro_torch.examples import add_device_arg
from repro_torch.mapper import DpuPool, MapperOptions, WorkloadGraph, map_workload
from repro_torch.models import registry

DATARATE_GS = 5.0


def show(title: str, timeline) -> None:
    print("=" * 72)
    print(title)
    print("=" * 72)
    print(timeline.utilization_table())
    print()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    add_device_arg(ap)
    resolve_device(ap.parse_args(argv).device)
    out = {}

    # -- CNN: the paper's winner vs the unstudied challenger ----------------
    cnn = WorkloadGraph.from_layers(WORKLOADS["resnet50"](), name="resnet50")
    smwa = DpuPool.area_matched("SMWA", DATARATE_GS)
    mwas = DpuPool.area_matched("MWAS", DATARATE_GS)
    runs = [
        ("ResNet50 on SMWA, batch=1 (the paper's regime)", cnn, smwa, 1),
        ("ResNet50 on MWAS, batch=1 (area matching packs in idle DPUs)", cnn, mwas, 1),
        ("ResNet50 on MWAS, batch=64 (batching feeds the extra DPUs)", cnn, mwas, 64),
    ]
    for title, graph, pool, batch in runs:
        out[title] = map_workload(graph, pool, MapperOptions(batch=batch))
        show(title, out[title])

    # -- LM: per-layer GEMM sites with real dependency structure ------------
    lm_cfg = registry.get("qwen2-0.5b").config
    lm = WorkloadGraph.from_model_config(lm_cfg, seq_len=256)
    print(f"lowered {lm!r}")
    title = "qwen2-0.5b prefill (seq 256) on SMWA, batch=8"
    out[title] = map_workload(lm, smwa, MapperOptions(batch=8))
    show(title, out[title])

    # The degenerate schedule is the legacy simulator, bit-for-bit.
    degenerate = map_workload(cnn, smwa, MapperOptions.degenerate())
    out["degenerate"] = degenerate
    print(
        f"degenerate (legacy) schedule on SMWA: {degenerate.fps:.1f} FPS, "
        f"{degenerate.fps_per_w:.3f} FPS/W — the batch-1 baseline the "
        "mapper's schedules are measured against"
    )
    return out


if __name__ == "__main__":
    main()
