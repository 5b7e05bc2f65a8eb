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
  ``arch.param_defs(cfg.pad_for_mesh(model))``; ``--photonic`` routes the
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

This is the port's program, not the reference's GSPMD one: activations,
and without ``--photonic`` the weights' use, are replicated on every rank
(each rank holds the parameters and the global batch, as ``train(mesh=)``
does), so bytes and FLOPs differ from the reference's cells by design.

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
    ``FakeTensorMode``): each ``P`` at its shape and dtype."""
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


def build_step(arch, cfg, shape, mesh, *, dp_shardmap: bool = False, dp_compress: bool = False) -> Callable:
    """The step function of one cell at config ``cfg``, as the port runs
    it (built outside the ``FakeTensorMode``: the DP step reads the mesh's
    rank tensor when it is made)."""
    import torch

    from repro_torch.models.common import engine_from_model_config
    from repro_torch.optim import adamw

    def scoped(fn):
        """``fn`` under the TP scope a photonic cell's GEMMs K-shard in."""
        if engine_from_model_config(cfg) is None:
            return fn
        from repro_torch.photonic import sharded

        def run(*a):
            with sharded.tensor_parallel(mesh, "model"):
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

        return scoped(build_train_step(loss_fn, opt_cfg))
    if shape.kind == "prefill":
        def prefill_step(p, b):
            with torch.no_grad():
                return arch.prefill(p, b, cfg, shape.seq_len)

        return scoped(prefill_step)

    def serve_step(p, t, c):
        with torch.no_grad():
            return arch.decode(p, t, c, cfg)

    return scoped(serve_step)


def build_args(arch, cfg, shape, device: str) -> tuple:
    """The fake inputs of one cell's step (call inside a
    ``FakeTensorMode``): parameters, and the optimizer state and batch, the
    batch, or the token and cache."""
    from repro_torch.optim import adamw

    params = fake_params(arch.param_defs(cfg), cfg, device)
    if shape.kind == "train":
        return params, adamw.init(params), materialize(arch.train_batch_spec(cfg, shape)[0], device)
    if shape.kind == "prefill":
        return params, materialize(arch.prefill_batch_spec(cfg, shape)[0], device)
    (tok, _), (cache, _) = arch.decode_specs(cfg, shape)
    max_seq = shape.seq_len // cfg.decoder_ratio if arch.family == "audio" else shape.seq_len
    return params, materialize(tok, device), materialize(cache, device, host_position=max_seq - 1)


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
    config=None,
    shape=None,
) -> dict:
    """One cell (module docstring).  ``config`` / ``shape`` replace the
    arch's config and the named shape (smaller cells for tests).
    Reference: ``repro.launch.dryrun:run_cell``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

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
            "dp_shardmap": dp_shardmap, "dp_compress": dp_compress,
        }

        def measure(mcfg):
            step = build_step(arch, mcfg, shape, mesh, dp_shardmap=dp_shardmap, dp_compress=dp_compress)
            with FakeTensorMode(allow_non_fake_inputs=True):
                args = build_args(arch, mcfg, shape, device)
                with shd.use_rules(mesh, mcfg.logical_rules):
                    res = account(step, args)
                    fallbacks = shd.fallback_log()
            return res, fallbacks

        res, fallbacks = measure(cfg)
        out.update(res)
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
                    help="rejected: the port's train step keeps optimizer moments replicated, so there is "
                         "no ZeRO-1 to turn off (ROADMAP Queue 3 item 16)")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default=None)
    ap.add_argument("--override", action="append", default=[], help="config overrides, e.g. --override remat=false")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device of the fake tensors (cuda needs a card)")
    ap.add_argument("--out", default=str(RESULTS_DIR), help="directory of the cell JSONs")
    args = ap.parse_args(argv)
    if args.no_zero1:
        ap.error("--no-zero1: the port's train step keeps optimizer moments replicated, so there is no "
                 "ZeRO-1 to turn off (ROADMAP Queue 3 item 16)")
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
            variant=variant, dp_shardmap=args.dp_shardmap, dp_compress=args.dp_compress,
        )
    except Exception:
        out = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh, "variant": variant, "ok": False,
               "error": traceback.format_exc()[-6000:]}
    path.write_text(json.dumps(out, indent=1))
    print(json.dumps(out, indent=1))
    return 0 if out.get("ok") else 1


if __name__ == "__main__":
    sys.exit(main())
