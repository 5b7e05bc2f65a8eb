"""Dry run of the port's SPMD program on a production mesh, nothing
allocated.

Port of ``repro.launch.dryrun`` (deliverable (e)).  For an arch x shape x
mesh cell, rank 0 runs one step of the port's own program on a ``fake``
process group whose world is 256 (``single``, the (data, model) 16 x 16
mesh) or 512 (``multi``, (pod, data, model) 2 x 16 x 16), with fake
tensors at the production shape:

* the step is the one the port runs: ``build_train_step`` under
  ``use_rules(mesh)`` and, with ``--photonic``, ``tensor_parallel(mesh,
  "model")`` (what ``train(mesh=, tp_axis="model")`` runs), or
  ``make_dp_train_step`` with ``--dp-shardmap`` / ``--dp-compress``;
  ``arch.prefill`` for prefill shapes; ``arch.decode`` on the
  ``decode_specs`` cache for decode shapes;
* parameter leaves are fake tensors made from
  ``arch.param_specs(cfg.pad_for_mesh(model), shape, mesh)``; ``--photonic`` routes the
  weight GEMMs through ``DPUConfig(SMWA, bits=4, datarate_gs=5.0)`` on the
  ``ref`` backend (a fake tensor cannot reach a ctypes kernel, whose
  wrapper raises on one);
* :func:`account` runs the step once under ``FlopCounterMode`` and
  :class:`~repro_torch.launch.hlo_analysis.Recorder` and reports what this
  rank holds (``argument_size_in_bytes``, ``output_size_in_bytes``,
  ``temp_size_in_bytes``: the peak of live storage the step allocated over
  its arguments), computes (``flops_per_device``), moves through its GEMMs
  (``matmul_traffic_bytes``) and over the wire (the collective summary);
* then the layer ladder (``Arch.ladder``): each rung runs the same way and
  ``flops_per_device_exact = sum(coeff x flops)`` in integers.  An eager
  run counts every layer, so the identity must hold exactly; a cell whose
  identity fails is not ``ok`` (that family's per-layer work depends on the
  layer's index).

Each rank holds what the reference's per-device program holds along the
logical names the port places (``repro_torch.runtime.sharding.
placement``): its rows of the batch, token and cache over the data axes,
and in prefill and decode its KV heads of GQA attention and of the cache
over ``model`` (the step runs on those blocks, and a decode step gathers
its logits, which the reference's ``out_shardings`` replicate); a train
step's optimizer moments are ZeRO-1 blocks over the data axes (the
reference's ``zero1_axes``, derived from the global shapes), its update
running on those blocks and all-gathering the parameters, unless
``--no-zero1``.  Every family holds its parameters as the reference's
``in_shardings`` place them, each leaf by its ``param_axes``, in prefill,
decode and train steps alike: the dense GQA decoders (qwen2, granite,
deepseek-67b) and the MoE decoders (phi3.5-moe, deepseek-v2-lite) by
``heads`` (MLA's too), ``kv_heads``, ``d_ff``, ``vocab`` and
``experts``; whisper and llama-3.2-vision by their heads (the
cross-attention's too), ``d_ff`` and ``vocab``; xLSTM and Zamba2 by
``inner`` and ``mamba_heads`` (their projections, the mLSTM state's key
dimension, the Mamba2 SSM and conv states) and Zamba2's shared block by
its heads and ``d_ff``, over ``model``.  Every GEMM computes its block
(column-parallel ``wq`` / ``wk`` / ``wv`` / MLA's ``wuk`` / ``wuv`` /
``ffn.wi`` / the shared experts' ``wi`` / Mamba2's ``in_proj`` / the
mLSTM's ``up`` / ``wq`` / ``wk`` / ``wv`` / the sLSTM's ``wx`` /
``lm_head``, row-parallel ``wo`` / ``ffn.wo`` / ``out_proj`` /
``down``), the MoE is expert-parallel (a rank runs its block of the
experts on their slots, the partial combines summed over ``model``),
the embedding and the loss are vocab-parallel, the decode step gathers
its logits over ``model`` too, and the gradient norm sums placed leaves
over ``model``.  The sequence axes are placed as the reference places
them: in prefill and train steps the residual stream between blocks is
the rank's block of the sequence over ``model`` (``seq_sp``; whisper's
``audio_embed`` comes in as that block), and in a decode step whose rows
cannot take "data" (one row at ``long_500k``) every cache leaf is the
rank's block of ``max_seq`` positions over "data" (``kv_seq``), the
decode softmax merged across the blocks; the cell's ``seq_collectives``
counts their gathers, reduce-scatters (a block's row-parallel output,
and in the Megatron entry its input gradient) and merges
(``contracts.SEQ_COLLECTIVES``), ``seq_wire_bytes`` their ring wire
bytes a rank (``contracts.SEQ_WIRE_BYTES``), and the collective summary
every collective's by kind.  Any dimension the reference places
that the port does not would stay whole: the report lists each such leaf
under ``replicated_by_port`` (empty in every cell the port runs) with the
bytes the rank holds and the reference's, and gives ``param_bytes`` (the
rank's).  A column axis laid
out in parts (SwiGLU's ``[u | g]``, Mamba2's ``[z | x | B C | dt]``) is
held as a block of each part, the bytes of the reference's contiguous
block.

The ``fake`` backend comes from ``torch.testing._internal.distributed.
fake_pg`` (the one torch ships; internal API).  ``--device`` defaults to
``cuda`` (fake CUDA tensors, which need a card); the CPU tests pass
``--device cpu``.  Nothing turns fake into real or ``cuda`` into ``cpu``.

Usage::

    python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape decode_32k --mesh single
    python -m repro_torch.launch.dryrun --sweep          # every cell, a subprocess each
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import hashlib
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, Optional

from repro_torch._tree import tree_leaves, tree_map

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
# What one rank may hold: an H100 80GB card's 80 GB.
DEVICE_BYTES = 80 * 10**9


def _cell_path(out_dir: Path, arch: str, shape: str, mesh: str, variant: str = "base") -> Path:
    safe = arch.replace("/", "_").replace(".", "_")
    return Path(out_dir) / f"{safe}__{shape}__{mesh}__{variant}.json"


@contextlib.contextmanager
def fake_world(world: int):
    """A ``fake`` default process group of ``world`` ranks, this process
    rank 0, for the scope (refused while another group is live)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError(f"a {dist.get_backend()} group of {dist.get_world_size()} ranks is live; the dry run "
                           f"makes its own fake group of {world}")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _check_device(device: str) -> None:
    import torch

    if device not in ("cpu", "cuda"):
        raise ValueError(f"--device is cpu or cuda, got {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the dry run's fake tensors are cuda unless asked otherwise, and this machine has no "
                           "CUDA device; pass --device cpu")


def tree_bytes(tree) -> int:
    """Bytes of the tensor leaves of ``tree``, and 4 for each int leaf (a
    position the port reads on the host, an int32 in the spec)."""
    import torch

    total = 0
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        elif isinstance(leaf, int) and not isinstance(leaf, bool):
            total += 4
    return total


def fake_params(defs, cfg, device: str):
    """Fake parameter leaves from a definition tree (call inside a
    ``FakeTensorMode``): each ``P`` at its shape and dtype, whole."""
    import torch

    from repro_torch.models.common import _DTYPES

    return tree_map(lambda p: torch.empty(p.shape, dtype=_DTYPES[p.dtype] if p.dtype else cfg.param_dtype,
                                          device=device), defs)


def materialize(spec_tree, device: str, *, host_position: Optional[int] = None):
    """Fake tensors for a tree of :class:`TensorSpec` (inside a
    ``FakeTensorMode``); a zero-dimensional integer leaf (a cache's ``pos``)
    becomes the host int ``host_position``: the port's decode reads its
    position on the host."""
    import torch

    def make(spec):
        if spec.shape == () and not spec.dtype.is_floating_point and host_position is not None:
            return host_position
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)

    return tree_map(make, spec_tree)


def op_stream_digest(ops) -> str:
    """sha256 over the recorded ops in order: each one's name and its
    inputs' and outputs' shapes and dtypes.  A fake run and a real run of
    one program give the same digest."""
    h = hashlib.sha256()
    for op in ops:
        h.update(repr((op.name, op.inputs, op.outputs)).encode())
    return h.hexdigest()


def account(step: Callable, args: tuple) -> Dict[str, Any]:
    """Run ``step(*args)`` once under ``FlopCounterMode`` and a
    :class:`~repro_torch.launch.hlo_analysis.Recorder` with memory tracking
    (fake or real tensors alike) and return what this rank held, computed
    and moved."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import hlo_analysis

    flops = FlopCounterMode(display=False)
    t0 = time.time()
    with flops, hlo_analysis.Recorder(track_memory=True) as rec:
        result = step(*args)
    arg_bytes = tree_bytes(args)
    out = {
        "trace_s": round(time.time() - t0, 3),
        "argument_size_in_bytes": arg_bytes,
        "output_size_in_bytes": tree_bytes(result),
        "temp_size_in_bytes": rec.memory.peak,
        "peak_size_in_bytes": arg_bytes + rec.memory.peak,
        "flops_per_device": int(flops.get_total_flops()),
        "matmul_traffic_bytes": hlo_analysis.matmul_traffic_bytes(rec.ops, rec.launches),
        "aten_ops": len(rec.ops),
        "aten_op_counts": dict(collections.Counter(op.name for op in rec.ops)),
        "aten_op_stream_sha256": op_stream_digest(rec.ops),
    }
    out.update(hlo_analysis.collective_summary(rec.collectives))
    return out


def cell_config(arch, mesh, *, photonic: bool, photonic_scope: str, photonic_org: str, overrides=None,
                config=None):
    """The cell's model config: padded for the mesh's model axis, with the
    reference's photonic operating point on the ``ref`` backend."""
    from repro_torch.core.dpu import DPUConfig
    from repro_torch.runtime.sharding import mesh_axis_sizes

    cfg = (config or arch.config).pad_for_mesh(mesh_axis_sizes(mesh)["model"])
    if photonic:
        cfg = dataclasses.replace(
            cfg, photonic=DPUConfig(organization=photonic_org, bits=4, datarate_gs=5.0),
            photonic_backend="ref", photonic_scope=photonic_scope,
        )
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def build_step(arch, cfg, shape, mesh, *, dp_shardmap: bool = False, dp_compress: bool = False,
               zero1: bool = True) -> Callable:
    """The step function of one cell at config ``cfg``, as the port runs
    it (built outside the ``FakeTensorMode``: the DP step reads the mesh's
    rank tensor when it is made), under the cell's placement; its inputs
    are :func:`build_args`' blocks.  The train step is the reference dry
    run's: the mean loss and gradients over every rank's rows, then the
    ZeRO-1 update (``adamw.update(shards=)``, its layout from the global
    parameter shapes) unless ``zero1`` is false, the gradient norm summing
    placed parameter leaves over ``model`` (``adamw.Placed``).  The decode
    step gathers its logits over the rows and the vocab, as the
    reference's ``out_shardings=(None, cache_sh)`` replicates them."""
    import torch

    from repro_torch.models.common import axes_tree, engine_from_model_config
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding as shd

    sizes = arch.placement_sizes(cfg, shape)

    def scoped(fn):
        """``fn`` under the cell's placement and, for a photonic cell, the
        TP scope its GEMMs K-shard in."""
        tp = engine_from_model_config(cfg) is not None

        def run(*a):
            with contextlib.ExitStack() as scopes:
                scopes.enter_context(shd.placement(mesh, sizes, cfg.logical_rules))
                if tp:
                    from repro_torch.photonic import sharded

                    scopes.enter_context(sharded.tensor_parallel(mesh, "model"))
                return fn(*a)

        return run

    if shape.kind == "train":
        opt_cfg = adamw.AdamWConfig()

        def loss_fn(p, b):
            return arch.loss(p, b, cfg)

        if dp_shardmap:
            from repro_torch.runtime.dp_step import make_dp_train_step

            return make_dp_train_step(loss_fn, opt_cfg, mesh, compress_grads=dp_compress)
        from repro_torch.runtime.train_loop import build_train_step

        defs = arch.param_defs(cfg)

        def train_step(params, opt_state, batch):
            shards = adamw.zero1(defs, axes_tree(defs), mesh, cfg.logical_rules) if zero1 else None
            placed = adamw.Placed(shd.placed_leaf_parts(defs, axes_tree(defs), cfg.logical_rules), mesh)
            return build_train_step(loss_fn, opt_cfg, zero1=shards, placed=placed)(params, opt_state, batch)

        return scoped(train_step)
    if shape.kind == "prefill":
        def prefill_step(p, b):
            with torch.no_grad():
                return arch.prefill(p, b, cfg, shape.seq_len)

        return scoped(prefill_step)

    def serve_step(p, t, c):
        with torch.no_grad():
            logits, cache = arch.decode(p, t, c, cfg)
            return shd.gather_tree(logits, ("batch", None, "vocab")), cache

    return scoped(serve_step)


def build_args(arch, cfg, shape, mesh, device: str, *, dp_shardmap: bool = False, zero1: bool = True) -> tuple:
    """The fake inputs of one cell's step (call inside a
    ``FakeTensorMode``), this rank's blocks: parameters (placed by their
    ``param_axes``), and the optimizer state
    (ZeRO-1 moments unless ``zero1`` is false) and batch rows, the batch
    rows, or the token and cache rows and KV heads.  The DP step
    (``dp_shardmap``) takes whole parameters, the global batch and
    replicated moments, as the reference's ``shard_map`` step does."""
    from repro_torch.models.common import axes_tree
    from repro_torch.optim import adamw

    placed = None if dp_shardmap and shape.kind == "train" else mesh
    params = materialize(arch.param_specs(cfg, shape, placed)[0], device)
    if shape.kind == "train":
        defs = arch.param_defs(cfg)
        shards = adamw.zero1(defs, axes_tree(defs), mesh, cfg.logical_rules) if zero1 and not dp_shardmap else None
        return (params, adamw.init(params, shards),
                materialize(arch.train_batch_spec(cfg, shape, mesh=placed)[0], device))
    if shape.kind == "prefill":
        return params, materialize(arch.prefill_batch_spec(cfg, shape, mesh=mesh)[0], device)
    (tok, _), (cache, _) = arch.decode_specs(cfg, shape, mesh=mesh)
    max_seq = shape.seq_len // cfg.decoder_ratio if arch.family == "audio" else shape.seq_len
    return params, materialize(tok, device), materialize(cache, device, host_position=max_seq - 1)


def replicated_leaves(arch, cfg, shape, mesh, *, dp_shardmap: bool = False, zero1: bool = True) -> list:
    """``sharding.replicated_by_port`` over the cell's argument leaves: the
    parameters (placed along the cell's placed names), the moments of a
    train step (placed along ``zero1`` and those names), and the batch,
    token and cache (placed along the cell's placed names)."""
    from repro_torch._tree import tree_items
    from repro_torch.models.common import _DTYPES, axes_tree
    from repro_torch.runtime import sharding as shd

    rules = cfg.logical_rules
    defs = arch.param_defs(cfg)
    pdefs = tree_items(defs)
    paxes = shd._axes_items(axes_tree(defs), pdefs)
    dp_step = dp_shardmap and shape.kind == "train"
    names = () if dp_step else tuple(shd.placed_parts(arch.placement_sizes(cfg, shape), mesh, rules))
    groups = [({f"params/{k}": (p.shape, paxes[k], (_DTYPES[p.dtype] if p.dtype else cfg.param_dtype).itemsize)
                for k, p in pdefs.items()}, names)]
    if shape.kind == "train":
        spec, axes = arch.train_batch_spec(cfg, shape)
        if zero1 and not dp_step:
            dp = math.prod(shd.mesh_axis_sizes(mesh).get(a, 1) for a in ("pod", "data"))
            maxes = shd._axes_items(shd.zero1_axes(axes_tree(defs), defs, dp), pdefs)
        else:
            maxes = paxes
        for m in ("mu", "nu"):
            groups.append(({f"opt/{m}/{k}": (p.shape, maxes[k], 4) for k, p in pdefs.items()}, ("zero1",) + names))
    elif shape.kind == "prefill":
        spec, axes = arch.prefill_batch_spec(cfg, shape)
    else:
        (tok, tok_axes), (cache, cache_axes) = arch.decode_specs(cfg, shape)
        spec, axes = {"token": tok, "cache": cache}, {"token": tok_axes, "cache": cache_axes}
    items = tree_items(spec)
    iaxes = shd._axes_items(axes, items)
    groups.append(({f"inputs/{k}": (s.shape, iaxes[k], s.dtype.itemsize) for k, s in items.items()}, names))
    return [gap for leaves, placed in groups for gap in shd.replicated_by_port(leaves, mesh, placed, rules)]


def run_cell(
    arch_name: str,
    shape_name: str,
    mesh_kind: str,
    *,
    device: str = "cuda",
    photonic: bool = False,
    photonic_scope: str = "weights",
    photonic_org: str = "SMWA",
    overrides: Optional[dict] = None,
    variant: str = "base",
    dp_shardmap: bool = False,
    dp_compress: bool = False,
    zero1: bool = True,
    config=None,
    shape=None,
) -> dict:
    """One cell (module docstring).  ``config`` / ``shape`` replace the
    arch's config and the named shape (smaller cells for tests).
    Reference: ``repro.launch.dryrun:run_cell``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis import contracts
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import registry
    from repro_torch.models.common import engine_from_model_config
    from repro_torch.runtime import sharding as shd

    _check_device(device)
    arch = registry.get(arch_name)
    shape = shape or registry.SHAPES[shape_name]
    multi = mesh_kind == "multi"
    with fake_world(512 if multi else 256):
        mesh = make_production_mesh(multi_pod=multi, device=device)
        cfg = cell_config(arch, mesh, photonic=photonic, photonic_scope=photonic_scope, photonic_org=photonic_org,
                          overrides=overrides, config=config)
        eng = engine_from_model_config(cfg)
        out: Dict[str, Any] = {
            "arch": arch_name, "shape": shape.name, "mesh": mesh_kind, "variant": variant, "kind": shape.kind,
            "device": device, "world": mesh.size(), "mesh_shape": dict(shd.mesh_axis_sizes(mesh)),
            "padded_heads": cfg.padded_heads, "padded_vocab": cfg.padded_vocab,
            "num_kv_heads_effective": cfg.num_kv_heads,
            "param_count": sum(math.prod(p.shape) for p in tree_leaves(arch.param_defs(cfg))),
            "photonic_engine": None if eng is None else eng.describe().to_dict(),
            "dp_shardmap": dp_shardmap, "dp_compress": dp_compress, "zero1": zero1 and shape.kind == "train"
            and not dp_shardmap,
        }
        placed = {} if shape.kind == "train" and dp_shardmap else shd.placed_parts(
            arch.placement_sizes(cfg, shape), mesh, cfg.logical_rules)
        out["placed"] = {k: v if isinstance(v, str) else list(v) for k, v in placed.items()}

        def measure(mcfg):
            step = build_step(arch, mcfg, shape, mesh, dp_shardmap=dp_shardmap, dp_compress=dp_compress,
                              zero1=zero1)
            with FakeTensorMode(allow_non_fake_inputs=True):
                args = build_args(arch, mcfg, shape, mesh, device, dp_shardmap=dp_shardmap, zero1=zero1)
                with shd.use_rules(mesh, mcfg.logical_rules):
                    contracts.reset_all_reduces()
                    res = account(step, args)
                    res["seq_collectives"] = dict(contracts.SEQ_COLLECTIVES)
                    res["seq_wire_bytes"] = dict(contracts.SEQ_WIRE_BYTES)
                    fallbacks = shd.fallback_log()
                res["param_bytes"] = tree_bytes(args[0])
                if shape.kind == "train":
                    res["optimizer_state_bytes"] = tree_bytes(args[1])
                elif shape.kind == "decode":
                    res["cache_bytes"] = tree_bytes(args[2])
            return res, fallbacks

        res, fallbacks = measure(cfg)
        out.update(res)
        gap = replicated_leaves(arch, cfg, shape, mesh, dp_shardmap=dp_shardmap, zero1=zero1)
        out["replicated_by_port"] = gap
        by_name = collections.defaultdict(lambda: [0, 0])
        for g in gap:
            by_name[g["logical"]][0] += g["bytes"]
            by_name[g["logical"]][1] += g["reference_bytes"]
        out["replicated_by_port_bytes"] = {k: {"bytes": v[0], "reference_bytes": v[1]} for k, v in by_name.items()}
        out["sharding_fallbacks"] = [
            {"shape": list(s), "logical": n, "mesh_axis": a if isinstance(a, str) else list(a), "dim": d,
             "axis_size": z}
            for (s, n, a, d, z) in fallbacks
        ]
        out["fits_device"] = out["peak_size_in_bytes"] <= DEVICE_BYTES
        out["device_bytes"] = DEVICE_BYTES

        ladder, flops_exact, traffic_exact = {}, 0, 0
        for step_name, ov, coeff in arch.ladder(cfg):
            lres, _ = measure(dataclasses.replace(cfg, **ov))
            c = int(coeff)
            if c != coeff:
                raise ValueError(f"ladder coefficient {coeff} of {step_name} is not an integer")
            ladder[step_name] = {"coeff": c, "flops": lres["flops_per_device"],
                                 "matmul_traffic_bytes": lres["matmul_traffic_bytes"]}
            flops_exact += c * lres["flops_per_device"]
            traffic_exact += c * lres["matmul_traffic_bytes"]
        out["ladder"] = ladder
        out["flops_per_device_exact"] = flops_exact
        out["matmul_traffic_bytes_exact"] = traffic_exact
        out["ladder_identity_holds"] = flops_exact == out["flops_per_device"]
    out["ok"] = bool(out["ladder_identity_holds"])
    return out


# ---------------------------------------------------------------------------
# The sweep: one subprocess per cell
# ---------------------------------------------------------------------------
def all_cells():
    """``(arch, shape, mesh, skipped)`` for every cell.  Reference:
    ``repro.launch.dryrun:all_cells``."""
    from repro_torch.models import registry

    cells = []
    for arch_name in registry.names():
        arch = registry.get(arch_name)
        for shape_name in registry.SHAPES:
            skipped = shape_name in arch.skip_shapes
            for mesh_kind in ("single", "multi"):
                cells.append((arch_name, shape_name, mesh_kind, skipped))
    return cells


def sweep(out_dir: Path, device: str, timeout_s: int = 3600, force: bool = False) -> None:
    """Every cell in a subprocess under ``profile.child_env()``, a JSON
    each; skipped cells get a ``skipped`` JSON.  Reference:
    ``repro.launch.dryrun:sweep``."""
    from repro_torch.launch import profile

    out_dir.mkdir(parents=True, exist_ok=True)
    cells = all_cells()
    todo = []
    for arch, shp, mesh, skipped in cells:
        path = _cell_path(out_dir, arch, shp, mesh)
        if skipped:
            path.write_text(json.dumps({"arch": arch, "shape": shp, "mesh": mesh, "ok": True, "skipped": True,
                                        "reason": "shape inapplicable to arch"}, indent=1))
            continue
        if path.exists() and not force:
            try:
                if json.loads(path.read_text()).get("ok"):
                    continue
            except ValueError:
                pass
        todo.append((arch, shp, mesh))
    print(f"[sweep] {len(todo)} cells to run ({len(cells)} total)", flush=True)
    for i, (arch, shp, mesh) in enumerate(todo):
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shp, "--mesh", mesh,
               "--device", device, "--out", str(out_dir)]
        t0 = time.time()
        print(f"[sweep {i + 1}/{len(todo)}] {arch} x {shp} x {mesh} ...", flush=True)
        try:
            r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout_s, env=profile.child_env())
            if r.returncode != 0 and not _cell_path(out_dir, arch, shp, mesh).exists():
                _cell_path(out_dir, arch, shp, mesh).write_text(json.dumps(
                    {"arch": arch, "shape": shp, "mesh": mesh, "ok": False, "error": (r.stderr or "")[-4000:]},
                    indent=1))
            print(f"  {'ok' if r.returncode == 0 else 'FAILED'} ({time.time() - t0:.0f}s)", flush=True)
        except subprocess.TimeoutExpired:
            _cell_path(out_dir, arch, shp, mesh).write_text(json.dumps(
                {"arch": arch, "shape": shp, "mesh": mesh, "ok": False, "error": f"timeout after {timeout_s}s"},
                indent=1))
            print("  TIMEOUT", flush=True)


def main(argv=None) -> int:
    from repro_torch.launch import profile

    profile.apply()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=["train_4k", "prefill_32k", "decode_32k", "long_500k"])
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--photonic", action="store_true")
    ap.add_argument("--photonic-scope", default="weights", choices=["none", "weights", "weights_int8"],
                    help="which weight GEMMs the engine routes (with --photonic)")
    ap.add_argument("--photonic-org", default="SMWA",
                    help="DPU organization: a registered name or any S/A/M/W order (with --photonic)")
    ap.add_argument("--dp-shardmap", action="store_true", help="the DP train step (replicated params)")
    ap.add_argument("--dp-compress", action="store_true", help="int8 ring gradient all-reduce (with --dp-shardmap)")
    ap.add_argument("--no-zero1", action="store_true",
                    help="replicated optimizer moments in the train step (default: ZeRO-1 over the data axes)")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default=None)
    ap.add_argument("--override", action="append", default=[], help="config overrides, e.g. --override remat=false")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device of the fake tensors (cuda needs a card)")
    ap.add_argument("--out", default=str(RESULTS_DIR), help="directory of the cell JSONs")
    args = ap.parse_args(argv)
    out_dir = Path(args.out)
    if args.sweep:
        _check_device(args.device)
        sweep(out_dir, args.device, force=args.force)
        return 0
    if not (args.arch and args.shape):
        ap.error("--arch and --shape are required (or --sweep)")
    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        try:
            overrides[k] = json.loads(v)
        except json.JSONDecodeError:
            overrides[k] = v
    variant = args.variant or ("photonic" if args.photonic else "base")
    out_dir.mkdir(parents=True, exist_ok=True)
    path = _cell_path(out_dir, args.arch, args.shape, args.mesh, variant)
    try:
        out = run_cell(
            args.arch, args.shape, args.mesh, device=args.device, photonic=args.photonic,
            photonic_scope=args.photonic_scope, photonic_org=args.photonic_org, overrides=overrides or None,
            variant=variant, dp_shardmap=args.dp_shardmap, dp_compress=args.dp_compress, zero1=not args.no_zero1,
        )
    except Exception:
        out = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh, "variant": variant, "ok": False,
               "error": traceback.format_exc()[-6000:]}
    path.write_text(json.dumps(out, indent=1))
    print(json.dumps(out, indent=1))
    return 0 if out.get("ok") else 1


if __name__ == "__main__":
    sys.exit(main())
