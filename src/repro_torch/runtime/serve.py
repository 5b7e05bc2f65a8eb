"""Serving entry point (compatibility wrapper over ``repro_torch.serving``).

Port of ``repro.runtime.serve``.  ``Engine`` keeps the original
constructor/run surface but routes the dense GQA LM family onto the paged
continuous-batching scheduler (``repro_torch.serving.Scheduler``); other
families (the moe family, MLA or not, and the vlm and audio families, as
in the reference) go to ``LegacyEngine``, the original fixed-slot loop,
kept as the baseline the scheduler is compared against.  ``LegacyEngine``
feeds its prefill tokens only, as the reference's does, so it refuses the
vlm and audio families, whose prefill needs ``vision`` / ``audio_embed``:
those run through the registry's ``prefill`` / ``decode``.  Both prepack every routed
weight once at construction (``prepack_serving_params``), so decode does
no weight quantization.  Both run on ``cuda`` unless constructed with
``device="cpu"``.  Both take ``mesh=`` / ``tp_axis=``: tensor-parallel
serving, every rank running the same engine on the same requests, the
banks K-sharded and every model call under
:func:`repro_torch.photonic.sharded.tensor_parallel`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch._device import resolve_device
from repro_torch.serving.scheduler import (
    Request,
    Scheduler,
    ServingConfig,
    _to_device,
    _tp_size,
    prepack_serving_params,
)

__all__ = ["Request", "ServeConfig", "Engine", "LegacyEngine"]


@dataclasses.dataclass
class ServeConfig:
    """Reference: ``repro.runtime.serve:ServeConfig``."""

    batch_size: int = 4
    max_seq: int = 256
    greedy: bool = True
    temperature: float = 1.0
    seed: int = 0


def _paged_block_size(max_seq: int) -> int:
    for b in (16, 8, 4, 2, 1):
        if max_seq % b == 0:
            return b
    raise AssertionError  # unreachable: 1 always divides


class Engine:
    """Reference: ``repro.runtime.serve:Engine``."""

    def __init__(
        self, arch, model_cfg, params, cfg: ServeConfig, *, mesh=None, tp_axis: str = "model", device=None
    ):
        self.arch = arch
        self.model_cfg = model_cfg
        self.cfg = cfg
        paged = (
            getattr(arch, "family", None) == "dense"
            and not model_cfg.mla
            and not model_cfg.cross_attn_every
        )
        if paged:
            # A chunk budget of a full wave (batch_size * max_seq tokens)
            # admits and fully prefills every free slot before the step's
            # decode, preserving the legacy engine's admission order.
            scfg = ServingConfig(
                batch_size=cfg.batch_size,
                max_seq=cfg.max_seq,
                block_size=_paged_block_size(cfg.max_seq),
                chunk_tokens=cfg.batch_size * cfg.max_seq,
                greedy=cfg.greedy,
                temperature=cfg.temperature,
                seed=cfg.seed,
            )
            self.impl = Scheduler(arch, model_cfg, params, scfg, mesh=mesh, tp_axis=tp_axis, device=device)
        else:
            self.impl = LegacyEngine(arch, model_cfg, params, cfg, mesh=mesh, tp_axis=tp_axis, device=device)

    @property
    def photonic(self):
        return self.impl.photonic

    @property
    def params(self):
        return self.impl.params

    @params.setter
    def params(self, value):
        self.impl.params = value

    @property
    def stats(self):
        return self.impl.stats

    def _tp_scope(self):
        return self.impl._tp_scope()

    def run(self, requests: List[Request], max_steps: int = 10_000) -> List[Request]:
        return self.impl.run(requests, max_steps)


def _is_cache_leaf(x) -> bool:
    return isinstance(x, tuple) and len(x) == 3 and isinstance(x[0], tuple) and isinstance(x[1], tuple)


def _batch_axes(cache_def):
    """Batch-axis index per cache leaf, from the cache_def's logical axes
    (``None`` for batchless leaves such as ``pos``)."""
    if _is_cache_leaf(cache_def):
        axes = cache_def[1]
        return axes.index("batch") if "batch" in axes else None
    return {k: _batch_axes(v) for k, v in cache_def.items()}


def _merge(live, new, axes, slot: int):
    """Copy row ``slot`` of every batched leaf of ``new`` into ``live`` (in
    place); batchless leaves keep their live value."""
    if isinstance(live, dict):
        return {k: _merge(live[k], new[k], axes[k], slot) for k in live}
    if axes is None or not isinstance(live, torch.Tensor) or live.ndim == 0:
        return live
    live.narrow(axes, slot, 1).copy_(new.narrow(axes, slot, 1))
    return live


class LegacyEngine:
    """The original fixed-slot continuous-batching loop.  Reference:
    ``repro.runtime.serve:LegacyEngine``.

    Keeps ``batch_size`` decode slots backed by one dense ``(batch,
    max_seq)`` KV cache (GQA ``k``/``v``, or MLA's latent ``c_kv``/``k_rope``
    with the first block's under ``first``; each leaf's batch axis comes
    from the arch's ``cache_def``).  Free slots fill by prefilling the prompt, tiled
    over the batch (one prefill per admission, merged into the batch cache
    at the slot index), then all active slots advance together through
    ``decode`` steps.  Known limitations, kept as the reference has them:
    worst-case cache memory per slot, head-of-line blocking on long
    prompts, the batchless ``pos`` staying live across admissions, and a
    shared sampling stream across slots (the key ``PRNGKey(seed)``, split
    once a step, its second half drawing ``categorical`` for every row, as
    JAX draws).  ``stats`` adds the host seconds of
    the prefills and the decode steps (each ends in a device-to-host token
    read, so they include its device work).
    """

    def __init__(
        self,
        arch,
        model_cfg,
        params,
        cfg: ServeConfig,
        *,
        mesh=None,
        tp_axis: str = "model",
        device=None,
        clock: Callable[[], float] = time.monotonic,
    ):
        family = getattr(arch, "family", None)
        if family in ("vlm", "audio"):
            raise NotImplementedError(
                f"LegacyEngine cannot serve the {family!r} family: the reference's one-shot "
                f"engine feeds its prefill tokens only (repro.runtime.serve:LegacyEngine._admit), never the "
                f"{'vision' if family == 'vlm' else 'audio_embed'} input the family needs; run "
                f"the arch's prefill(params, batch, cfg, max_seq) / decode(params, token, "
                f"cache, cfg) from repro_torch.models.registry instead"
            )
        self.arch = arch
        self.model_cfg = model_cfg
        self.device = resolve_device(device)
        self.mesh = mesh
        self.tp_axis = tp_axis
        self._tp_size = _tp_size(mesh, tp_axis)
        self._clock = clock
        with torch.no_grad():
            self.photonic, self.params = prepack_serving_params(
                arch, model_cfg, _to_device(params, self.device), mesh=mesh, tp_axis=tp_axis
            )
        self.cfg = cfg
        self.slots: List[Optional[Request]] = [None] * cfg.batch_size
        self.cache = None
        self.tokens = torch.zeros((cfg.batch_size, 1), dtype=torch.int64, device=self.device)
        self._rng = prng.PRNGKey(cfg.seed)
        self.stats = {
            "prefills": 0, "decode_steps": 0, "completed": 0, "prefill_s": 0.0, "decode_s": 0.0,
        }
        cache_def = arch.cache_def(
            model_cfg, cfg.batch_size, cfg.max_seq, {"enc_seq": cfg.max_seq},
            model_cfg.compute_dtype,
        )
        self._batch_axis = _batch_axes(cache_def)

    def _tp_scope(self):
        """The tensor-parallel scope every model call runs under (a no-op
        without a TP mesh).  Reference:
        ``repro.runtime.serve:LegacyEngine._tp_scope``."""
        if self.photonic is not None and self._tp_size > 1:
            from repro_torch.photonic import sharded

            return sharded.tensor_parallel(self.mesh, self.tp_axis)
        return contextlib.nullcontext()

    # -- admission -----------------------------------------------------------
    def _admit(self, req: Request, slot: int):
        """Prefill the prompt for one slot and merge into the batch cache."""
        t0 = time.perf_counter()
        b = self.cfg.batch_size
        prompt = torch.as_tensor(np.asarray(req.prompt), dtype=torch.int64, device=self.device)
        batch = {"tokens": prompt[None, :].repeat(b, 1)}
        with torch.no_grad(), self._tp_scope():
            logits, cache = self.arch.prefill(self.params, batch, self.model_cfg, self.cfg.max_seq)
        self.stats["prefills"] += 1
        if self.cache is None:
            self.cache = cache
        else:
            self.cache = _merge(self.cache, cache, self._batch_axis, slot)
        tok = torch.argmax(logits[:, -1, : self.model_cfg.vocab_size], dim=-1)
        self.tokens[slot, 0] = tok[slot]
        req.output.append(int(tok[slot]))
        self.stats["prefill_s"] += time.perf_counter() - t0
        if req.t_first is None:
            req.t_first = self._clock()
        self.slots[slot] = req

    # -- one engine iteration ------------------------------------------------
    def step(self, queue: List[Request]):
        # fill free slots
        for slot in range(self.cfg.batch_size):
            if self.slots[slot] is None and queue:
                self._admit(queue.pop(0), slot)
        if all(s is None for s in self.slots):
            return
        t0 = time.perf_counter()
        with torch.no_grad(), self._tp_scope():
            logits, self.cache = self.arch.decode(self.params, self.tokens, self.cache, self.model_cfg)
        self.stats["decode_steps"] += 1
        logits = logits[:, -1, : self.model_cfg.vocab_size]
        if self.cfg.greedy:
            nxt = torch.argmax(logits, dim=-1)
        else:
            self._rng, k = prng.split(self._rng)
            # The temperature in the logits' dtype first, as JAX's weak typing does.
            temp = torch.full((), self.cfg.temperature, dtype=logits.dtype, device=logits.device)
            nxt = prng.categorical(k, logits / temp, axis=-1)
        self.tokens = nxt[:, None].to(torch.int64)
        nxt = nxt.tolist()
        self.stats["decode_s"] += time.perf_counter() - t0
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            tok = int(nxt[slot])
            req.output.append(tok)
            if (
                len(req.output) >= req.max_new_tokens
                or (req.eos_id is not None and tok == req.eos_id)
            ):
                req.done = True
                req.t_done = self._clock()
                self.stats["completed"] += 1
                self.slots[slot] = None

    def run(self, requests: List[Request], max_steps: int = 10_000) -> List[Request]:
        queue = list(requests)
        for req in queue:
            if req.t_submit is None:
                req.t_submit = self._clock()
        steps = 0
        while (queue or any(s is not None for s in self.slots)) and steps < max_steps:
            self.step(queue)
            steps += 1
        return requests
