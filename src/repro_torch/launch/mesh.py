"""Device meshes over ``torch.distributed``, and the ranks that fill them.

Port of ``repro.launch.mesh``.  A mesh is a
:class:`~torch.distributed.device_mesh.DeviceMesh` with named axes over
the ranks of the live process group (the reference's devices are JAX's;
here a device is a rank, and a rank holds one card, or on one card several
ranks share it).  Every constructor is a function, so importing this
module touches no process group.

The process group's backend is the caller's choice, never guessed:
``gloo`` on the CPU; ``nccl`` where each rank owns a card; several ranks
on one card over ``gloo`` with CUDA tensors (NCCL refuses two ranks on one
device).  :func:`spawn` starts ``world`` ranks of a function on a named
backend and device — the port's counterpart of the reference tests'
``--xla_force_host_platform_device_count``.
"""

from __future__ import annotations

import math
import os
import tempfile
import traceback
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch._device import resolve_device


def _world() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def build_mesh(shape: Sequence[int], axes: Sequence[str], *, device=None):
    """A :class:`DeviceMesh` over the first ``prod(shape)`` ranks with the
    named ``axes`` (row-major, the last axis fastest, as the reference lays
    devices out).  ``device`` names the ranks' device type: ``cuda``
    unless the caller asks for the CPU.  Reference:
    ``repro.launch.mesh:build_mesh``."""
    from torch.distributed.device_mesh import DeviceMesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    require_devices(math.prod(shape))
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs the default process group: start the ranks with "
            "repro_torch.launch.mesh.spawn (or torchrun and init_process_group)"
        )
    ranks = torch.arange(math.prod(shape), dtype=torch.int64).reshape(shape)
    return DeviceMesh(resolve_device(device).type, ranks, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The reference's production mesh: ("data", "model") 16 x 16, or
    ("pod", "data", "model") 2 x 16 x 16.  Reference:
    ``repro.launch.mesh:make_production_mesh``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return build_mesh(shape, axes, device=device)


def make_smoke_mesh(*, device=None):
    """A one-rank mesh with the production axis names.  Reference:
    ``repro.launch.mesh:make_smoke_mesh``."""
    return build_mesh((1, 1), ("data", "model"), device=device)


def max_tp_degree(limit: int = 8) -> int:
    """Largest power-of-two tensor-parallel degree the live ranks support
    (1 without a process group).  Reference:
    ``repro.launch.mesh:max_tp_degree``."""
    n = min(_world(), limit)
    tp = 1
    while tp * 2 <= n:
        tp *= 2
    return tp


def make_tp_smoke_mesh(tp: Optional[int] = None, *, device=None):
    """("data", "model") mesh with a real tensor-parallel axis of ``tp``
    ranks (default :func:`max_tp_degree`) and a data axis of 1.
    Reference: ``repro.launch.mesh:make_tp_smoke_mesh``."""
    if tp is None:
        tp = max_tp_degree()
    require_devices(tp)
    return build_mesh((1, tp), ("data", "model"), device=device)


def require_devices(n: int) -> None:
    """Raise unless the live process group has at least ``n`` ranks.
    Reference: ``repro.launch.mesh:require_devices``."""
    have = _world()
    if have < n:
        raise RuntimeError(
            f"need {n} devices but have {have}. Start that many ranks first "
            "(repro_torch.launch.mesh.spawn, or torchrun) and initialize the "
            "default process group in each before building a mesh."
        )


# ---------------------------------------------------------------------------
# Starting ranks
# ---------------------------------------------------------------------------
def _rank_main(rank, world, backend, device, store_path, fn, args, results):
    try:
        if device.startswith("cuda"):
            index = torch.device(device).index
            torch.cuda.set_device(0 if index is None else index)
        else:
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        store = dist.FileStore(store_path, world)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world)
        try:
            out = fn(rank, world, *args)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(
    fn: Callable[..., Any],
    world: int,
    *,
    backend: str,
    device: str = "cpu",
    args: tuple = (),
    timeout: float = 600.0,
) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` fresh processes, each a
    rank of a default process group on ``backend`` (named, never guessed)
    whose rendezvous is a ``FileStore`` in a new temporary directory (no
    port, so concurrent groups cannot collide); ``device`` is the device
    each rank sets current (``"cuda"`` or ``"cuda:i"``; every rank the same
    one unless ``fn`` chooses; CPU ranks share the host's cores evenly).
    ``fn`` must be importable by module path
    (the ``spawn`` start method), and its return value picklable.  Returns
    the ranks' return values in rank order; raises with the failing ranks'
    tracebacks if any rank fails or the group outlives ``timeout``
    seconds, and stops every rank it started."""
    import queue

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        store_path = os.path.join(tmp, "store")
        procs = [
            ctx.Process(target=_rank_main, args=(r, world, backend, device, store_path, fn, args, results),
                        daemon=True)
            for r in range(world)
        ]
        for p in procs:
            p.start()
        got, failed = {}, {}
        try:
            for _ in range(world):
                # Once a rank has failed, the others get a short grace to
                # report (their own failure is often the lost peer).
                rank, ok, out = results.get(timeout=10.0 if failed else timeout)
                (got if ok else failed)[rank] = out
        except queue.Empty:
            if not failed:
                failed[-1] = f"the group did not finish within {timeout} s"
        finally:
            for p in procs:
                p.join(timeout=5 if failed else 60)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    if failed:
        raise RuntimeError(
            f"{len(failed)} of {world} ranks failed:\n" + "\n".join(f"rank {r}:\n{tb}" for r, tb in sorted(failed.items()))
        )
    return [got[r] for r in range(world)]
