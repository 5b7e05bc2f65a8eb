"""The port's analytic tier against the reference's, on the same inputs.

The perf model (``core/perfmodel.py``), the CNN layer tables, the
organization views, the workload mapper (``mapper/*``), the Fig. 7
simulator (``core/simulator.py``) and the config catalog are plain Python
arithmetic, so the port is held to the reference bit for bit: every float
compared as ``float.hex``, every int and name exactly.  The Fig. 7 grid
is also held to the float-hex pins of ``tests/test_mapper.py`` and to the
digest ``chip_smoke.py`` embeds for the card (which has no JAX).
"""

import dataclasses
import importlib.util
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro import mapper as jmap  # noqa: E402
from repro import platforms as jplatforms  # noqa: E402
from repro.core import cnn_workloads as jcnn  # noqa: E402
from repro.core import organizations as jorg  # noqa: E402
from repro.core import perfmodel as jperf  # noqa: E402
from repro.core import scalability as jsc  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro.core.params import PhotonicParams as JParams  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.orgs import valid_orderings as jorderings  # noqa: E402
from repro_torch import mapper as tmap  # noqa: E402
from repro_torch import platforms as tplatforms  # noqa: E402
from repro_torch.core import cnn_workloads as tcnn  # noqa: E402
from repro_torch.core import organizations as torg  # noqa: E402
from repro_torch.core import perfmodel as tperf  # noqa: E402
from repro_torch.core import scalability as tsc  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.core.params import PhotonicParams as TParams  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.orgs import valid_orderings as torderings  # noqa: E402
from test_mapper import PINS  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ORDERS = [s.name for s in jorderings()]
DRS = (1, 5, 10)
PLATFORMS = ("SOI", "SIN")


def _hex(v):
    """A comparable image of ``v``: floats as ``float.hex``, containers
    element by element, everything else as is."""
    if isinstance(v, float):
        return v.hex()
    if isinstance(v, dict):
        return {k: _hex(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_hex(x) for x in v]
    return v


@pytest.fixture(scope="module")
def grids():
    return jsim.evaluate_all(), tsim.evaluate_all()


def _result_image(res):
    cfg = res.config
    return _hex(dict(
        model=res.model, org=cfg.organization, n=cfg.n, dpu_count=cfg.dpu_count,
        total_time_s=res.total_time_s, dynamic_energy_j=res.dynamic_energy_j,
        static_power_w=res.static_power_w, fps=res.fps, avg_power_w=res.avg_power_w,
        fps_per_w=res.fps_per_w, fps_per_w_per_mm2=res.fps_per_w_per_mm2(),
        layers=[dataclasses.astuple(ls) for ls in res.layers],
    ))


@pytest.mark.parametrize("org", ["ASMW", "MASW", "SMWA"])
def test_fig7_grid_equals_reference_and_pins(grids, org):
    want, got = grids
    assert [k for k in got] == [k for k in want]
    assert len(got) == 36
    keys = [k for k in got if k[0] == org]
    assert len(keys) == 12
    for key in keys:
        assert _result_image(got[key]) == _result_image(want[key]), key
        fps_hex, energy_hex = PINS[key]
        assert got[key].fps.hex() == fps_hex and got[key].dynamic_energy_j.hex() == energy_hex, key


def test_fig7_digest_embedded_in_chip_smoke_is_the_reference_s(grids):
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    want, got = grids
    assert mod.fig7_digest(want) == mod.FIG7_DIGEST
    assert mod.fig7_digest(got) == mod.FIG7_DIGEST


def test_evaluate_all_on_the_solver_and_sin(grids):
    kw = dict(organizations=("SMWA", "SAMW"), datarates=(5,), models=("mobilenet_v2",),
              use_paper_operating_points=False, platform="SIN")
    want, got = jsim.evaluate_all(**kw), tsim.evaluate_all(**kw)
    assert list(got) == list(want)
    for key in want:
        assert _result_image(got[key]) == _result_image(want[key]), key
    with pytest.raises(ValueError, match="SOI-only"):
        tsim.evaluate_all(platform="SIN")


@pytest.mark.parametrize("platform", PLATFORMS)
@pytest.mark.parametrize("dr", DRS)
def test_operating_points_and_area_matched_counts(platform, dr):
    jp, tp = jplatforms.resolve(platform), tplatforms.resolve(platform)
    for order in ORDERS:
        assert tsc.calibrated_max_n(order, 4, dr, platform=tp) == jsc.calibrated_max_n(
            order, 4, dr, platform=jp), order
    got = tperf.area_matched_counts(dr, organizations=ORDERS, platform=platform)
    assert got == jperf.area_matched_counts(dr, organizations=ORDERS, platform=platform)
    assert len(got) == 12
    assert tperf.area_matched_counts(dr) == jperf.area_matched_counts(dr)


def _config_image(cfg):
    return _hex(dict(
        fields={f.name: (dataclasses.asdict(getattr(cfg, f.name)) if f.name == "peripherals"
                         else getattr(cfg, f.name)) for f in dataclasses.fields(cfg)},
        org_spec=cfg.org_spec.name, blocks=list(cfg.org_spec.blocks), platform_spec=cfg.platform_spec.name,
        symbol_s=cfg.symbol_s, passes=cfg.passes, tiles=cfg.tiles, tune_latency_s=cfg.tune_latency_s,
        tune_power_w_per_ring=cfg.tune_power_w_per_ring, rings_per_dpu=cfg.rings_per_dpu,
        dacs_per_dpu=cfg.dacs_per_dpu, adcs_per_dpu=cfg.adcs_per_dpu, dpu_area_mm2=cfg.dpu_area_mm2(),
        tile_overhead_mm2=cfg.tile_overhead_mm2(), total_area_mm2=cfg.total_area_mm2(),
        laser_power_w=cfg.laser_power_w(), static_power_w=cfg.static_power_w(),
        streaming_power_w=cfg.streaming_power_w(),
        reprogram=[dataclasses.astuple(cfg.weight_reprogram_cost(groups=g)) for g in (1, 32)],
    ))


@pytest.mark.parametrize("dr", DRS)
def test_accelerator_configs_field_for_field(dr):
    for org in ("ASMW", "MASW", "SMWA"):
        assert _config_image(tperf.AcceleratorConfig.from_paper(org, dr)) == _config_image(
            jperf.AcceleratorConfig.from_paper(org, dr)), org
    for order in ORDERS:
        for platform in PLATFORMS:
            t = tperf.AcceleratorConfig.from_scalability(order, dr, platform=platform)
            j = jperf.AcceleratorConfig.from_scalability(order, dr, platform=platform)
            assert _config_image(t) == _config_image(j), (order, platform)
    with pytest.raises(ValueError, match="from_scalability"):
        tperf.AcceleratorConfig.from_paper("SAMW", dr)
    cfg = tperf.AcceleratorConfig.from_paper("SMWA", dr)
    for area in (cfg.total_area_mm2(), 0.5 * cfg.total_area_mm2()):
        assert tperf.area_matched_count(cfg, area) == jperf.area_matched_count(
            jperf.AcceleratorConfig.from_paper("SMWA", dr), area)


def test_reprogram_cost_spelling():
    from repro.photonic.packing import reprogram_cost as jcost
    from repro_torch.photonic.packing import reprogram_cost as tcost

    for rings, lat, pw in ((6889, 2e-8, 4e-5), (83, 2e-8, 1.234e-5), (1, 3e-9, 7e-3)):
        t = tcost(rings, tune_latency_s=lat, tune_power_w_per_ring=pw)
        j = jcost(rings, tune_latency_s=lat, tune_power_w_per_ring=pw)
        assert _hex(dataclasses.astuple(t)) == _hex(dataclasses.astuple(j))


def test_organization_views_and_penalties():
    jp, tp = JParams(), TParams()
    assert [s.name for s in torderings()] == ORDERS
    for view in ("BLOCK_ORDERS", "PRIOR_WORK", "CROSSTALK", "LOSSES"):
        j, t = getattr(jorg, view), getattr(torg, view)
        assert list(t) == list(j), view
        for name in j:
            a, b = j[name], t[name]
            if dataclasses.is_dataclass(a):
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert _hex(b) == _hex(a), (view, name)
    for order in ORDERS:
        for n in (1, 9, 16, 83, 160):
            assert torg.through_device_count(order, n) == jorg.through_device_count(order, n)
            assert _hex(torg.structural_penalty_db(order, n, tp)) == _hex(jorg.structural_penalty_db(order, n, jp))
        assert torg.lumped_penalty_db(order, tp).hex() == jorg.lumped_penalty_db(order, jp).hex()


@pytest.mark.parametrize("model", list(jcnn.WORKLOADS))
def test_cnn_layer_tables(model):
    assert list(tcnn.WORKLOADS) == list(jcnn.WORKLOADS)
    j, t = jcnn.WORKLOADS[model](), tcnn.WORKLOADS[model]()
    assert [dataclasses.astuple(x) for x in t] == [dataclasses.astuple(x) for x in j]
    assert [(x.dots, x.macs) for x in t] == [(x.dots, x.macs) for x in j]
    assert tcnn.total_macs(model) == jcnn.total_macs(model)


def _graph_image(g):
    return [(n.name, n.rows, n.k, n.cols, n.groups, n.deps, n.site) for n in g.topological()], g.name, g.total_macs


@pytest.mark.parametrize("which", ["config", "smoke_config"])
@pytest.mark.parametrize("name", jreg.names())
def test_lm_graphs_node_for_node(name, which):
    jcfg, tcfg = getattr(jreg.get(name), which), getattr(treg.get(name), which)
    seq = 64 if which == "smoke_config" else 512
    try:
        want = jmap.WorkloadGraph.from_model_config(jcfg, seq_len=seq)
    except NotImplementedError as e:
        with pytest.raises(NotImplementedError) as got:
            tmap.WorkloadGraph.from_model_config(tcfg, seq_len=seq)
        assert str(got.value) == str(e)
        return
    got = tmap.WorkloadGraph.from_model_config(tcfg, seq_len=seq)
    assert _graph_image(got) == _graph_image(want)
    assert repr(got) == repr(want)


def test_graph_validation_errors_match():
    for nodes in (
        [dict(name="a", rows=1, k=1, cols=1), dict(name="a", rows=1, k=1, cols=1)],
        [dict(name="a", rows=1, k=1, cols=1, deps=("b",))],
        [dict(name="a", rows=1, k=1, cols=1, deps=("b",)), dict(name="b", rows=1, k=1, cols=1, deps=("a",))],
        [dict(name="a", rows=0, k=1, cols=1)],
    ):
        with pytest.raises(ValueError) as j:
            jmap.WorkloadGraph("g", [jmap.GemmNode(**n) for n in nodes])
        with pytest.raises(ValueError) as t:
            tmap.WorkloadGraph("g", [tmap.GemmNode(**n) for n in nodes])
        assert str(t.value) == str(j.value)


OPTION_GRID = [
    dict(batch=b, replicate=r, overlap_reduce=o, cross_layer=c)
    for b in (1, 4) for r in (False, True) for o in (False, True) for c in (False, True)
] + [dict(batch=4, reprogram_amortization=0.25)]


@pytest.fixture(scope="module")
def graphs():
    qj, qt = jreg.get("qwen2-0.5b").config, treg.get("qwen2-0.5b").config
    return {
        "resnet50": (jmap.WorkloadGraph.from_layers(jcnn.resnet50(), name="resnet50"),
                     tmap.WorkloadGraph.from_layers(tcnn.resnet50(), name="resnet50")),
        "qwen2-0.5b": (jmap.WorkloadGraph.from_model_config(qj, seq_len=128),
                       tmap.WorkloadGraph.from_model_config(qt, seq_len=128)),
    }


@pytest.mark.parametrize("workload", ["resnet50", "qwen2-0.5b"])
@pytest.mark.parametrize("org", ["SMWA", "MASW"])
def test_timelines_over_the_option_grid(graphs, workload, org):
    jg, tg = graphs[workload]
    jpool, tpool = jmap.DpuPool.area_matched(org, 5), tmap.DpuPool.area_matched(org, 5)
    assert tpool.size == jpool.size
    for opts in OPTION_GRID:
        j = jmap.map_workload(jg, jpool, jmap.MapperOptions(**opts))
        t = tmap.map_workload(tg, tpool, tmap.MapperOptions(**opts))
        assert _hex(t.to_dict()) == _hex(j.to_dict()), opts
        assert [dataclasses.astuple(ns) for ns in t.nodes] == [dataclasses.astuple(ns) for ns in j.nodes]
        assert _hex([t.energy_per_inference_j, t.mean_utilization, list(t.busy_per_dpu)]) == _hex(
            [j.energy_per_inference_j, j.mean_utilization, list(j.busy_per_dpu)])
        assert t.utilization_table() == j.utilization_table()


def test_tiling_and_degenerate_schedule():
    cfg_j, cfg_t = jperf.AcceleratorConfig.from_paper("ASMW", 10), tperf.AcceleratorConfig.from_paper("ASMW", 10)
    assert tmap.MapperOptions.degenerate() == tmap.MapperOptions(
        batch=1, replicate=False, overlap_reduce=False, cross_layer=False)
    for layer in tcnn.mobilenet_v2()[:8] + tcnn.resnet50()[-3:]:
        node_t = tmap.GemmNode(layer.name, layer.rows, layer.k, layer.cols, layer.groups)
        node_j = jmap.GemmNode(layer.name, layer.rows, layer.k, layer.cols, layer.groups)
        for opts in (dict(), dict(batch=3, overlap_reduce=False)):
            t = tmap.tile_node(node_t, cfg_t, 64, tmap.MapperOptions(**opts))
            j = jmap.tile_node(node_j, cfg_j, 64, jmap.MapperOptions(**opts))
            assert _hex(dataclasses.astuple(t)[1:]) == _hex(dataclasses.astuple(j)[1:])
            assert (t.tiles, t.chains, t.chain_duration_s(7).hex()) == (j.tiles, j.chains, j.chain_duration_s(7).hex())
    for bad in (dict(batch=0), dict(reprogram_amortization=0.0)):
        with pytest.raises(ValueError):
            tmap.MapperOptions(**bad)
    with pytest.raises(ValueError, match="empty DPU pool"):
        tmap.DpuPool(dataclasses.replace(cfg_t, dpu_count=0))


def test_catalog_resolves_through_the_port_registry():
    from repro.configs import catalog as jcat
    from repro_torch.configs import catalog as tcat

    assert tcat.ASSIGNED == jcat.ASSIGNED
    for name in tcat.ASSIGNED:
        arch = treg.get(name)
        assert arch.name == name and arch.config.arch_id == jreg.get(name).config.arch_id


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", [
    "qwen2-0.5b", "qwen2-1.5b", "granite-3-8b", "deepseek-67b", "deepseek-v2-lite-16b", "phi3.5-moe-42b-a6.6b",
])
def test_graph_against_the_routed_gemms_of_a_forward(chip_smoke, name):
    """The analytic phase's comparison at smoke size on the CPU: the port's
    ``lm_logits`` (ideal channel, kernel backend, its twin here) against the
    mapper's graph of the same config.  Every node but the three named
    differences (``chip_smoke.GRAPH_DIFFERENCES``) equals one routed GEMM
    in K, C and rows x batch, and no routed GEMM lacks a node."""
    import numpy as np
    import torch

    from repro_torch.core.dpu import DPUConfig
    from repro_torch.models import lm
    from repro_torch.models.common import init_params
    from repro_torch.serving import prepack_serving_params

    arch = treg.get(name)
    cfg = dataclasses.replace(arch.smoke_config, photonic=DPUConfig(organization="SMWA", bits=4),
                              photonic_backend="kernel")
    _, packed = prepack_serving_params(arch, cfg, init_params(arch.smoke_config, 0, device="cpu"))
    batch, t = 2, 12
    tokens = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, (batch, t)))
    with torch.no_grad(), chip_smoke.recorded_gemm_calls() as calls:
        lm.lm_logits(packed, tokens, cfg)
    graph = tmap.WorkloadGraph.from_model_config(cfg, seq_len=t)
    ok, report = chip_smoke.graph_vs_executed(cfg, graph, calls, batch)
    assert ok, report["unexplained"]
    first = bool(cfg.mla and cfg.num_experts)
    moe_layers = cfg.num_layers - first if cfg.num_experts else 0
    assert len(report["tied_head"]) == int(cfg.tie_embeddings)
    assert len(report["first_block"]) == (4 if first else 0)
    assert len(report["expert_rows"]) == 2 * moe_layers
    assert report["matched"] + sum(len(report[k]) for k in chip_smoke.GRAPH_DIFFERENCES) == len(graph)
    assert len(calls) == report["matched"] + 2 * first
