"""Asynchronous, atomic checkpoints of a tensor tree.

Port of ``repro.checkpoint.ckpt``.  The files are the reference's: one
directory ``step_%08d`` holding ``leaves.npz`` (every leaf under its
``/``-joined path) and ``manifest.json`` (step, keys, shapes, dtypes),
written under a ``.tmp_step_%08d`` name and published by one atomic
rename, so a killed save never corrupts the latest complete checkpoint.
``save`` copies the leaves to the host synchronously and, unless
``blocking``, writes the files on a thread while training goes on.

The leaf paths are the port's own: per-layer lists (``params/layers/0/wq``)
and NamedTuple fields by name (``opt/mu/...``, ``opt/step``).  The
reference stacks the layers on a leading axis (``params/layers/wq``, a MoE
layer's expert banks too; llama-vision's ``cross``, whisper's
``enc_layers`` / ``dec_layers`` and xLSTM's ``slstm`` likewise), xLSTM's
``mlstm`` and Zamba2's ``mamba`` on two (``params/mlstm/up/w`` holds the
port's ``params/mlstm/<g>/<i>/up/w``), and prints NamedTuple fields with a
dot (``opt/.mu/...``, ``opt/.step``); an unstacked block such as
DeepSeek-V2's ``params/first_block/...`` or Zamba2's ``params/shared/...``
has one name in both.
``restore`` reads both layouts.  numpy has no bfloat16: the port stores a
bf16 leaf as its raw 16-bit pattern (int16), the reference's ``np.savez``
as a void ``V2`` array; both manifests record ``bfloat16`` and ``restore``
reads either through the 16-bit pattern, bit for bit.  ``restore(shardings=)``
is the elastic path: the checkpoint holds whole host arrays, so a job
resumes on any mesh; every rank reads the same file and builds each leaf
as a DTensor from its own slice, with no collective.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch._tree import tree_items, tree_unflatten
from repro_torch.weights import STACKED


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _to_host(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.cpu().numpy()


def save(
    ckpt_dir: str | Path,
    step: int,
    tree: Any,
    *,
    blocking: bool = True,
) -> Optional[threading.Thread]:
    """Write the checkpoint of ``step``.  Reference:
    ``repro.checkpoint.ckpt:save``: the leaves go to host now; with
    ``blocking=False`` the files are written on a daemon thread, which is
    returned for the caller to join."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    flat = tree_items(tree)
    host = {k: _to_host(v) for k, v in flat.items()}
    manifest = {
        "step": step,
        "keys": sorted(host),
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "dtypes": {k: _dtype_name(v) for k, v in flat.items()},
    }

    def _write():
        tmp = ckpt_dir / f".tmp_step_{step:08d}"
        final = ckpt_dir / f"step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "leaves.npz", **host)
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic publish

    if blocking:
        _write()
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def _steps(ckpt_dir: Path, complete: bool):
    if not ckpt_dir.exists():
        return []
    return sorted(
        int(p.name.split("_")[1])
        for p in ckpt_dir.iterdir()
        if p.name.startswith("step_") and (not complete or (p / "manifest.json").exists())
    )


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    """The newest complete checkpoint's step, or None.  Reference:
    ``repro.checkpoint.ckpt:latest_step``."""
    steps = _steps(Path(ckpt_dir), complete=True)
    return steps[-1] if steps else None


def _archive_key(key: str, files) -> Tuple[str, Optional[int]]:
    """Where the leaf the port calls ``key`` lies in an archive with names
    ``files``: under ``key`` itself (the port's layout), or in the
    reference's layout, where NamedTuple fields carry a leading ``.`` and
    a ``layers/<i>/`` leaf is row ``i`` of the stacked ``layers/`` leaf
    (so are ``cross/<i>/``, ``enc_layers/<i>/``, ``dec_layers/<i>/`` and
    ``slstm/<i>/``), and a ``mlstm/<g>/<i>/`` leaf is row ``(g, i)`` of
    the doubly stacked ``mlstm/`` leaf (so is ``mamba/<g>/<i>/``).
    Returns the archive name and the row index (a tuple, empty for the
    whole leaf)."""
    if key in files:
        return key, ()
    by_plain = {"/".join(p.lstrip(".") for p in f.split("/")): f for f in files}
    parts = key.split("/")
    for j in range(1, len(parts) - 1):
        depth = STACKED.get(parts[j - 1], 0)
        idx = parts[j : j + depth]
        if depth and len(idx) == depth and all(p.isdigit() for p in idx):
            stacked = "/".join(parts[:j] + parts[j + depth :])
            if stacked in by_plain:
                return by_plain[stacked], tuple(int(p) for p in idx)
    if key in by_plain:
        return by_plain[key], ()
    raise KeyError(f"{key} is not in the checkpoint (in either layout)")


def _local_slice(t: torch.Tensor, sharding) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` under ``sharding``'s
    placements: for each mesh axis that shards a dimension, the chunk at
    the rank's coordinate on that axis, cut as ``torch.chunk`` cuts it
    (DTensor's ``Shard`` layout: a chunk past the last is empty)."""
    from torch.distributed.tensor import Shard

    mesh = sharding.mesh
    for axis, p in zip(mesh.mesh_dim_names, sharding.placements):
        if isinstance(p, Shard):
            n, i = mesh.size(mesh.mesh_dim_names.index(axis)), mesh.get_local_rank(axis)
            chunks = torch.chunk(t, n, dim=p.dim)
            t = chunks[i] if i < len(chunks) else t.narrow(p.dim, 0, 0)
    return t.contiguous()


def _place(t: torch.Tensor, sharding):
    """``t`` (the whole leaf) as a DTensor on ``sharding``'s mesh, built
    from this rank's slice alone."""
    from torch.distributed.tensor import DTensor

    local = _local_slice(t, sharding).to(sharding.mesh.device_type)
    return DTensor.from_local(local, sharding.mesh, sharding.placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def restore(ckpt_dir: str | Path, step: int, target_tree: Any, shardings: Any = None) -> Any:
    """Rebuild a tree shaped like ``target_tree`` from the checkpoint of
    ``step``, each leaf in its target's dtype and on its target's device.
    The checkpoint may be the port's or one the reference's ``save``
    wrote (module docstring).  With ``shardings`` (a tree of
    :class:`~repro_torch.runtime.sharding.NamedSharding` shaped like
    ``target_tree``), each leaf comes back as a DTensor on its sharding's
    mesh and placements, holding this rank's slice on the mesh's device
    (the elastic-resume path).  Reference:
    ``repro.checkpoint.ckpt:restore``."""
    d = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    placed = tree_items(shardings) if shardings is not None else {}
    out = []
    with np.load(d / "leaves.npz") as data:
        files = set(data.files)
        for key, tgt in tree_items(target_tree).items():
            name, row = _archive_key(key, files)
            arr = data[name]
            if manifest["dtypes"][name] == "bfloat16":
                arr = arr.view(np.int16)  # int16 (port) or void V2 (reference)
            if row:
                arr = arr[row]
            if tuple(arr.shape) != tuple(tgt.shape):
                raise ValueError(f"{key}: checkpoint shape {arr.shape}, target {tuple(tgt.shape)}")
            t = torch.from_numpy(np.array(arr))  # a contiguous copy; 0-dim stays 0-dim
            if manifest["dtypes"][name] == "bfloat16":
                t = t.view(torch.bfloat16)
            if key in placed:
                out.append(_place(t.to(dtype=tgt.dtype), placed[key]))
            else:
                out.append(t.to(device=tgt.device, dtype=tgt.dtype))
    return tree_unflatten(target_tree, out)


def cleanup(ckpt_dir: str | Path, keep: int = 3) -> None:
    """Keep the newest ``keep`` checkpoints.  Reference:
    ``repro.checkpoint.ckpt:cleanup``."""
    ckpt_dir = Path(ckpt_dir)
    for s in _steps(ckpt_dir, complete=False)[:-keep]:
        shutil.rmtree(ckpt_dir / f"step_{s:08d}", ignore_errors=True)
