"""Fault-tolerant training loop, on one device or SPMD over a mesh.

Port of ``repro.runtime.train_loop``:

* **checkpoint/restart** — periodic (by default asynchronous) checkpoints
  of params, optimizer state and step; a start resumes from the latest
  complete checkpoint, and the stateless data pipeline replays the exact
  batch sequence;
* **preemption** — SIGTERM/SIGINT end the run after the current step with
  a final checkpoint;
* **straggler watchdog** — per-step wall times feed an EWMA; steps slower
  than ``straggler_factor`` x the EWMA are logged and recorded;
* **microbatching** — gradient accumulation over ``microbatches``
  sequential chunks of the global batch.

The step is eager PyTorch: ``loss_fn`` runs forward, ``torch.autograd``
takes the gradient (through the photonic engine's straight-through
functions), and ``adamw.update`` applies it.

With ``mesh=`` (a :class:`DeviceMesh` over every rank of the default
process group) the loop runs SPMD: every rank calls :func:`train` with the
same arguments and holds the params and optimizer state replicated;
``use_rules(mesh)`` is active across the run, as the reference's
``train(mesh=)`` enters it, and with ``tp_axis=`` and a photonic engine
every routed GEMM K-shards over that axis (``tensor_parallel``).  The
batch rows are placed over the data axes, as the reference's
``("batch", ...)`` constraints place them (``placement``, the global
batch's ``"batch"`` resolved on the mesh): each rank's batch is its rows of
the one global batch (``make_global_batch(sharding=)``), the step runs on
them, the loss it reports is the global mean (the ranks' means summed in
one ``all_reduce`` and divided by their count, equal blocks) and the
gradients are the global mean's, summed the same way before the update;
``microbatches`` split the local rows.  For the dense GQA decoders the q
and KV heads are placed over ``model`` as well, as the reference's
``train()`` places its activations at its ``with_sharding_constraint``
sites (``arch.placement_sizes(..., params=False)``): the attention runs on
this rank's heads, ``attn.wq`` / ``wk`` / ``wv`` column-parallel and
``attn.wo`` row-parallel on the rank's blocks of the whole weights, whose
gradients come out whole on every rank (the column-parallel backward
gathers its output gradient over ``model``; the row-parallel one its
input); the parameters themselves stay whole, as the reference's
``train()`` never places them (ROADMAP Queue 3 item 16).  The residual
stream between blocks is placed too, by ``seq_sp`` over ``model`` (every
family but xLSTM, as the reference's ``train()`` constrains it): each
block gathers the sequence it reads whole and cuts its output back, its
gradient's blocks gathered in the backward, so the gradients are the run
without it bit for bit (``tests/test_torch_placement_seq.py``).  Summed over
ranks, the gradient is the replicated step's in another order, so a
placed run is not bitwise the replicated one
(``tests/test_torch_placement.py`` states the tolerance).
``place_rows=False`` runs the replicated program instead: every rank's
batch is the one global batch, and the routed GEMMs split their rows over
the data axes and gather them back, so the values are the unsharded
step's.  A batch the data degree does not divide is not placed (recorded
in ``fallback_log``).  The single-controller reference has no ranks to
keep in step; the port keeps three rules: only rank 0 writes checkpoints,
and every rank waits at a barrier before it looks for the latest one; the
preemption flag and the simulated failure are agreed across ranks
(``all_reduce(MAX)``) before the checkpoint decision, so no rank leaves
while the others wait in a collective.
"""

from __future__ import annotations

import contextlib
import dataclasses
import signal
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch import prng
from repro_torch._device import resolve_device
from repro_torch._tree import tree_items, tree_map, tree_unflatten
from repro_torch.checkpoint import ckpt
from repro_torch.data.pipeline import DataConfig, SyntheticTokens, make_global_batch
from repro_torch.models.common import engine_from_model_config, init_params
from repro_torch.optim import adamw
from repro_torch.runtime import collectives
from repro_torch.runtime import sharding as shd


@dataclasses.dataclass
class TrainConfig:
    """Reference: ``repro.runtime.train_loop:TrainConfig`` (same fields;
    the default ``ckpt_dir`` lies under the temporary directory)."""

    steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = dataclasses.field(
        default_factory=lambda: str(Path(tempfile.gettempdir()) / "repro_torch_ckpt")
    )
    log_every: int = 10
    microbatches: int = 1
    straggler_factor: float = 3.0
    async_checkpoint: bool = True
    keep_checkpoints: int = 3
    seed: int = 0


@dataclasses.dataclass
class TrainState:
    """Reference: ``repro.runtime.train_loop:TrainState``."""

    params: Any
    opt_state: adamw.OptState
    step: int


def _value_and_grad(loss_fn: Callable, params: Any, batch: Any):
    """``(loss, grads)`` of ``loss_fn(params, batch)``: every float leaf
    gets its gradient (zeros where the loss does not reach it)."""
    flat = tree_items(params)
    leaves = [p.detach().requires_grad_(p.is_floating_point()) for p in flat.values()]
    loss = loss_fn(tree_unflatten(params, leaves), batch)
    wrt = [p for p in leaves if p.requires_grad]
    got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
    grads = []
    for p in leaves:
        g = next(got) if p.requires_grad else None
        grads.append(torch.zeros_like(p) if g is None else g)
    return loss.detach(), tree_unflatten(params, grads)


def _mean_over_rows(loss: torch.Tensor, grads: Any):
    """The loss and gradients of this rank's rows as the global mean's,
    under a placement of the rows (one ``all_reduce`` of the flattened f32
    gradients and the loss); unchanged otherwise."""
    if shd.block("batch") is None:
        return loss, grads
    leaves = list(tree_items(grads).values())
    flat = torch.cat([g.reshape(-1).to(torch.float32) for g in leaves] + [loss.reshape(1).to(torch.float32)])
    shd.mean_over_rows(flat)
    out, at = [], 0
    for g in leaves:
        # a fresh tensor each, not a view into the buffer: a CPU reduction's
        # order (the update's gradient norm) depends on the data's alignment
        out.append(torch.empty_like(g).copy_(flat[at: at + g.numel()].reshape(g.shape)))
        at += g.numel()
    return flat[at].to(loss.dtype), tree_unflatten(grads, out)


def build_train_step(loss_fn: Callable, opt_cfg: adamw.AdamWConfig, microbatches: int = 1, *, zero1=None,
                     placed=None):
    """``(params, opt_state, batch) -> (params, opt_state, metrics)``.
    Reference: ``repro.runtime.train_loop:build_train_step``: with
    ``microbatches > 1`` the batch splits on its leading axis, the f32
    gradient sum is divided by the count, and the loss reported is the
    last microbatch's (the reference's scan carry).  Under a placement of
    the rows (module docstring) the batch is this rank's rows and the loss
    and gradients become the global mean's before the update; ``zero1``
    (:class:`~repro_torch.optim.adamw.Zero1`) runs the update on this
    rank's block of each leaf (``adamw.update(shards=)``).  ``placed``
    (:class:`~repro_torch.optim.adamw.Placed`) says which parameter leaves
    are this rank's blocks (the dry run's step on placed parameters): each
    block's gradient is its own, and the gradient norm sums the squares of
    placed leaves over ``model`` and counts whole leaves once."""

    def step(params, opt_state, batch):
        if microbatches == 1:
            loss, grads = _value_and_grad(loss_fn, params, batch)
        else:
            mbs = {k: v.reshape(microbatches, -1, *v.shape[1:]) for k, v in batch.items()}
            gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
            b = shd.block("batch")
            with shd.resized("batch", b.size // microbatches if b is not None else 0):
                for i in range(microbatches):
                    loss, g = _value_and_grad(loss_fn, params, {k: v[i] for k, v in mbs.items()})
                    gsum = tree_map(torch.add, gsum, g)
            grads = tree_map(lambda g: g / microbatches, gsum)
        loss, grads = _mean_over_rows(loss, grads)
        params, opt_state, metrics = adamw.update(opt_cfg, params, grads, opt_state, shards=zero1, placed=placed)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step


class StragglerWatchdog:
    """Reference: ``repro.runtime.train_loop:StragglerWatchdog``."""

    def __init__(self, factor: float):
        self.factor = factor
        self.ewma: Optional[float] = None
        self.events: list = []

    def observe(self, step: int, dt: float) -> bool:
        straggled = self.ewma is not None and dt > self.factor * self.ewma
        if straggled:
            self.events.append((step, dt, self.ewma))
        # the EWMA leaves straggler samples out, so one hiccup doesn't mask the next
        if not straggled:
            self.ewma = dt if self.ewma is None else 0.9 * self.ewma + 0.1 * dt
        return straggled


def _agreed(flag: bool, mesh) -> bool:
    """``flag`` or'ed over every rank (an ``all_reduce(MAX)``) on a mesh;
    ``flag`` itself without one."""
    if mesh is None:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32, device=mesh.device_type)
    collectives.all_reduce(t, dist.ReduceOp.MAX)
    return bool(t.item())


def train(
    *,
    arch,
    model_cfg,
    data_cfg: DataConfig,
    train_cfg: TrainConfig,
    opt_cfg: Optional[adamw.AdamWConfig] = None,
    mesh=None,
    tp_axis: Optional[str] = None,
    place_rows: bool = True,
    fail_at_step: Optional[int] = None,  # test hook: a simulated crash
    log: Callable[[str], None] = print,
    device=None,
) -> Dict[str, Any]:
    """Run (or resume) a training job on ``device`` (``cuda`` unless asked
    otherwise), alone or as one rank of ``mesh`` (module docstring), with
    routed GEMMs K-sharded over ``tp_axis`` (a ``ValueError`` names an axis
    the mesh lacks; ``tp_axis`` without a mesh changes nothing, as in the
    reference), the batch rows (and, for the dense GQA decoders, the q and
    KV heads) placed over the mesh unless ``place_rows=False``.  Reference: ``repro.runtime.train_loop:train``.  Returns
    the final params and optimizer state, the losses, the straggler events,
    the final step and whether the run was preempted, as the reference
    does, plus each step's seconds (``step_seconds``) and the seconds the
    loop spent blocked in checkpointing (``checkpoint_seconds``)."""
    if mesh is not None and tp_axis is not None and tp_axis not in shd.mesh_axis_sizes(mesh):
        raise ValueError(f"tp_axis {tp_axis!r} not in mesh axes {tuple(shd.mesh_axis_sizes(mesh))}")
    writer = mesh is None or dist.get_rank() == 0
    dev = resolve_device(device)
    opt_cfg = opt_cfg or adamw.AdamWConfig(total_steps=train_cfg.steps)
    stream = SyntheticTokens(data_cfg)
    # Build the engine up front, so a bad operating point fails here and
    # the log shows which sites run photonically.
    photonic_engine = engine_from_model_config(model_cfg)
    if photonic_engine is not None:
        log(f"[train] photonic engine: {photonic_engine.describe()}")

    def loss_fn(p, b):
        return arch.loss(p, b, model_cfg)

    step_fn = build_train_step(loss_fn, opt_cfg, train_cfg.microbatches)

    # ---- init or resume ----------------------------------------------------
    if mesh is not None:
        dist.barrier()  # rank 0's last checkpoint is on disk before anyone looks
    start = ckpt.latest_step(train_cfg.ckpt_dir)
    params = init_params(model_cfg, prng.PRNGKey(train_cfg.seed), dev, defs=arch.param_defs(model_cfg))
    opt_state = adamw.init(params)
    step0 = 0
    if start is not None:
        restored = ckpt.restore(train_cfg.ckpt_dir, start, {"params": params, "opt": opt_state})
        params, opt_state = restored["params"], restored["opt"]
        step0 = start
        log(f"[train] resumed from checkpoint step {start}")

    # ---- preemption handling -------------------------------------------------
    preempted = {"flag": False}

    def _handler(signum, frame):
        preempted["flag"] = True

    old_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            old_handlers[sig] = signal.signal(sig, _handler)
        except ValueError:
            pass  # not the main thread

    watchdog = StragglerWatchdog(train_cfg.straggler_factor)
    losses, step_seconds = [], []
    ckpt_seconds = 0.0
    pending_save = None
    # The mesh's rule scope and the TP scope are live across the whole loop
    # and are entered last before the try, so `finally` always leaves them
    # (a leaked thread-local scope would re-route every later dense()).
    scopes = contextlib.ExitStack()
    rows = None
    if mesh is not None:
        scopes.enter_context(shd.use_rules(mesh))
        if place_rows:
            from repro_torch.models.registry import ShapeSpec

            shape = ShapeSpec("train", data_cfg.seq_len, data_cfg.global_batch, "train")
            scopes.enter_context(shd.placement(mesh, arch.placement_sizes(model_cfg, shape, params=False)))
            b = shd.block("batch")
            rows = None if b is None else shd.NamedSharding(mesh, (b.part,))
        if tp_axis is not None and photonic_engine is not None:
            from repro_torch.photonic import sharded as tp_sharded

            log(f"[train] photonic tensor-parallel over mesh axis {tp_axis!r}")
            scopes.enter_context(tp_sharded.tensor_parallel(mesh, tp_axis))
    try:
        for step in range(step0, train_cfg.steps):
            if _agreed(fail_at_step is not None and step == fail_at_step, mesh):
                raise RuntimeError(f"simulated node failure at step {step}")
            t0 = time.time()
            batch = make_global_batch(stream, step, dev, sharding=rows)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            losses.append(loss)
            step_seconds.append(dt)
            if watchdog.observe(step, dt):
                log(f"[train] straggler at step {step}: {dt:.3f}s (ewma {watchdog.ewma:.3f}s)")
            if step % train_cfg.log_every == 0:
                log(f"[train] step {step} loss {loss:.4f} ({dt:.3f}s)")
            is_last = step == train_cfg.steps - 1
            preempted["flag"] = _agreed(preempted["flag"], mesh)
            if ((step + 1) % train_cfg.ckpt_every == 0 or is_last or preempted["flag"]) and writer:
                t1 = time.time()
                if pending_save is not None:
                    pending_save.join()
                pending_save = ckpt.save(
                    train_cfg.ckpt_dir,
                    step + 1,
                    {"params": params, "opt": opt_state},
                    blocking=not train_cfg.async_checkpoint,
                )
                ckpt.cleanup(train_cfg.ckpt_dir, train_cfg.keep_checkpoints)
                ckpt_seconds += time.time() - t1
            if preempted["flag"]:
                log(f"[train] preempted at step {step}; checkpointed and exiting")
                break
    finally:
        t1 = time.time()
        if pending_save is not None:
            pending_save.join()
        ckpt_seconds += time.time() - t1
        for sig, h in old_handlers.items():
            signal.signal(sig, h)
        scopes.close()

    return {
        "params": params,
        "opt_state": opt_state,
        "losses": losses,
        "straggler_events": watchdog.events,
        "final_step": step0 + len(losses),
        "preempted": preempted["flag"],
        "step_seconds": step_seconds,
        "checkpoint_seconds": ckpt_seconds,
    }
