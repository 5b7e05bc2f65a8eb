"""Token-budgeted continuous-batching scheduler over the paged KV pool.

Port of ``repro.serving.scheduler``: requests admit into ``batch_size``
decode slots backed by the block pool, prompts prefill in chunks of at
most ``chunk_tokens`` tokens per step, and every step interleaves that
prefill budget with one batched decode over all live slots.  The
scheduler prepacks every routed weight once (weight-stationary decode),
zeroes blocks at allocation (no stale KV), and draws samples under the
reference's key ``fold_in(fold_in(PRNGKey(seed), uid), n)`` — the request
uid and token index, never the slot (:mod:`repro_torch.prng`).  It runs on ``cuda`` unless constructed with ``device="cpu"``.
With ``mesh=`` (a ``DeviceMesh`` whose ``tp_axis`` is sized > 1) every rank
runs the same scheduler on the same requests: the banks prepack K-sharded,
each rank keeping its block, and every prefill and decode call runs its
routed GEMMs under :func:`repro_torch.photonic.sharded.tensor_parallel`.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch._device import resolve_device
from repro_torch.serving import kv_cache as kvc


@dataclasses.dataclass
class Request:
    """Reference: ``repro.serving.scheduler:Request``."""

    uid: int
    prompt: np.ndarray  # (T,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    t_submit: Optional[float] = None
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    logits: List[np.ndarray] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ServingConfig:
    """Reference: ``repro.serving.scheduler:ServingConfig``."""

    batch_size: int = 4
    max_seq: int = 256
    block_size: int = 16
    num_blocks: Optional[int] = None
    chunk_tokens: int = 64
    greedy: bool = True
    temperature: float = 1.0
    seed: int = 0
    record_logits: bool = False


def _to_device(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree


def _tp_size(mesh, tp_axis: str) -> int:
    names = tuple(mesh.mesh_dim_names or ()) if mesh is not None else ()
    return mesh.size(names.index(tp_axis)) if tp_axis in names else 1


def prepack_serving_params(arch, model_cfg, params, *, mesh=None, tp_axis: str = "model"):
    """Quantize and pack every routed weight once.  Returns
    ``(engine_or_None, params)``.  Under ``mla_absorb`` the MLA
    up-projections ``wuk`` / ``wuv`` stay as they are: absorbed decode
    reads them as floats in its own products, never through ``dense``.
    With a ``mesh`` whose ``tp_axis`` is sized > 1 the banks take the
    K-sharded layout and this rank keeps its block.  Reference:
    ``repro.serving.scheduler:prepack_serving_params``."""
    from repro_torch.models.common import engine_from_model_config
    from repro_torch.photonic.packing import prepack_params

    engine = engine_from_model_config(model_cfg)
    if engine is None:
        return None, params
    pack_engine = engine
    if model_cfg.mla_absorb:
        pol = dataclasses.replace(engine.policy, exclude=engine.policy.exclude + ("wuk", "wuv"))
        pack_engine = dataclasses.replace(engine, policy=pol)
    sharded = _tp_size(mesh, tp_axis) > 1
    return engine, prepack_params(
        params, arch.param_defs(model_cfg), pack_engine, mesh=mesh if sharded else None, axis=tp_axis
    )


class _Slot:
    def __init__(self, req: Request, blocks: List[int]):
        self.req = req
        self.blocks = blocks
        self.prefill_done = 0
        self.decoding = False


class Scheduler:
    """Reference: ``repro.serving.scheduler:Scheduler``.  ``mesh`` /
    ``tp_axis``: tensor-parallel serving (see the module docstring)."""

    def __init__(
        self,
        arch,
        model_cfg,
        params,
        cfg: ServingConfig,
        *,
        mesh=None,
        tp_axis: str = "model",
        device=None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if model_cfg.mla or model_cfg.cross_attn_every:
            raise ValueError(
                "paged serving covers the GQA self-attention LM stack; use "
                "runtime.serve.LegacyEngine for MLA / cross-attention families"
            )
        if cfg.max_seq % cfg.block_size:
            raise ValueError(
                f"block_size={cfg.block_size} must divide max_seq={cfg.max_seq}"
            )
        self.device = resolve_device(device)
        b = cfg.batch_size
        self.arch = arch
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.mesh = mesh
        self.tp_axis = tp_axis
        self._tp_size = _tp_size(mesh, tp_axis)
        self._clock = clock
        with torch.no_grad():
            self.photonic, self.params = prepack_serving_params(
                arch, model_cfg, _to_device(params, self.device), mesh=mesh, tp_axis=tp_axis
            )

        table_width = cfg.max_seq // cfg.block_size
        reserved = 1 + b
        num_blocks = cfg.num_blocks if cfg.num_blocks is not None else reserved + b * table_width
        self.num_blocks = num_blocks
        self.allocator = kvc.BlockAllocator(num_blocks, cfg.block_size, reserved=reserved)
        pool_def = arch.cache_def(
            model_cfg, num_blocks, cfg.block_size, {"enc_seq": cfg.block_size},
            model_cfg.compute_dtype,
        )
        self.kv_pool = kvc.init_pool(pool_def["layers"], self.device)
        self._trash = torch.arange(1, b + 1, dtype=torch.int64, device=self.device)

        self._table = np.full((b, table_width), kvc.NULL_BLOCK, np.int64)
        self._pos = np.zeros((b,), np.int64)
        self._tokens = np.zeros((b, 1), np.int64)
        self.slots: List[Optional[_Slot]] = [None] * b
        self._prefill_fifo: List[int] = []
        self.queue: collections.deque = collections.deque()
        self.stats = {
            "prefills": 0, "prefill_chunks": 0, "decode_steps": 0, "completed": 0,
            "prefill_s": 0.0, "decode_s": 0.0,
        }

    # -- device calls --------------------------------------------------------
    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _tp_scope(self):
        """The tensor-parallel scope every model call runs under (a no-op
        without a TP mesh).  Reference:
        ``repro.serving.scheduler:Scheduler._tp_scope``."""
        if self.photonic is not None and self._tp_size > 1:
            from repro_torch.photonic import sharded

            return sharded.tensor_parallel(self.mesh, self.tp_axis)
        return contextlib.nullcontext()

    def _decode_call(self, pool, active: np.ndarray):
        from repro_torch.models import lm

        with torch.no_grad(), self._tp_scope():
            return lm.lm_decode_paged(
                self.params, self._t(self._tokens), pool, self._t(self._table),
                self._t(self._pos), self._t(active), self._trash, self.model_cfg,
                gather_len=self.cfg.max_seq, block_size=self.cfg.block_size,
            )

    def _pick(self, rows: torch.Tensor, uids, ns) -> np.ndarray:
        """Next token per row: argmax, or ``categorical`` of ``row /
        temperature`` under the key ``fold_in(fold_in(PRNGKey(seed), uid),
        n)`` — the request's stream, never the slot's.  The keys are
        folded on the host; all rows draw in one vectorized pass on their
        device.  Reference: ``repro.serving.scheduler:Scheduler._pick``."""
        if self.cfg.greedy:
            return torch.argmax(rows, dim=-1).cpu().numpy()
        base = prng.PRNGKey(self.cfg.seed)
        keys = np.stack([prng.fold_in(prng.fold_in(base, int(u)), int(n)) for u, n in zip(uids, ns)])
        # The temperature in the rows' dtype first, as JAX's weak typing does.
        temp = torch.full((), self.cfg.temperature, dtype=rows.dtype, device=rows.device)
        return prng.categorical(keys, rows / temp).cpu().numpy()

    def _emit(self, slot: int, tok: int, logits_row=None) -> None:
        s = self.slots[slot]
        req = s.req
        req.output.append(tok)
        if req.t_first is None:
            req.t_first = self._clock()
        if self.cfg.record_logits and logits_row is not None:
            req.logits.append(logits_row.to(torch.float32).cpu().numpy())
        done = len(req.output) >= req.max_new_tokens or (
            req.eos_id is not None and tok == req.eos_id
        )
        if done:
            self.allocator.free(s.blocks)
            self._table[slot, :] = kvc.NULL_BLOCK
            self.slots[slot] = None
            if slot in self._prefill_fifo:
                self._prefill_fifo.remove(slot)
            req.done = True
            req.t_done = self._clock()
            self.stats["completed"] += 1

    # -- request lifecycle ---------------------------------------------------
    def submit(self, req: Request, *, t_submit: Optional[float] = None) -> None:
        total = len(req.prompt) + req.max_new_tokens
        if len(req.prompt) < 1:
            raise ValueError("empty prompt")
        if total > self.cfg.max_seq:
            raise ValueError(
                f"prompt + max_new_tokens = {total} exceeds max_seq={self.cfg.max_seq}"
            )
        cap = self.allocator.num_blocks - self.allocator.reserved
        if self.allocator.blocks_needed(total) > cap:
            raise ValueError(
                f"request needs {self.allocator.blocks_needed(total)} blocks "
                f"but the pool only has {cap} allocatable"
            )
        req.t_submit = self._clock() if t_submit is None else t_submit
        self.queue.append(req)

    def _admit(self) -> None:
        for slot in range(self.cfg.batch_size):
            if not self.queue:
                return
            if self.slots[slot] is not None:
                continue
            req = self.queue[0]
            need = self.allocator.blocks_needed(len(req.prompt) + req.max_new_tokens)
            blocks = self.allocator.alloc(need)
            if blocks is None:
                return
            self.queue.popleft()
            kvc.zero_blocks(self.kv_pool, blocks)
            self._table[slot, :] = kvc.NULL_BLOCK
            self._table[slot, : len(blocks)] = blocks
            self._pos[slot] = 0
            self.slots[slot] = _Slot(req, blocks)
            self._prefill_fifo.append(slot)
            self.stats["prefills"] += 1

    def _prefill_phase(self) -> None:
        from repro_torch.models import lm

        budget = self.cfg.chunk_tokens
        while budget > 0 and self._prefill_fifo:
            slot = self._prefill_fifo[0]
            s = self.slots[slot]
            prompt = np.asarray(s.req.prompt, np.int64)
            t_full = len(prompt)
            tc = min(budget, t_full - s.prefill_done)
            toks = self._t(prompt[s.prefill_done : s.prefill_done + tc][None, :])
            final = s.prefill_done + tc == t_full
            with torch.no_grad(), self._tp_scope():
                logits, self.kv_pool = lm.lm_prefill_chunk(
                    self.params, toks, self.kv_pool, self._t(self._table[slot]),
                    s.prefill_done, self.model_cfg, t_full=t_full,
                    block_size=self.cfg.block_size, with_logits=final,
                )
            budget -= tc
            s.prefill_done += tc
            self.stats["prefill_chunks"] += 1
            if final:
                self._prefill_fifo.pop(0)
                row = logits[:, -1, : self.model_cfg.vocab_size]
                tok = int(self._pick(row, [s.req.uid], [len(s.req.output)])[0])
                self._pos[slot] = t_full
                self._tokens[slot, 0] = tok
                s.decoding = True
                self._emit(slot, tok, logits_row=row[0])

    def _decode_phase(self) -> None:
        decoding = [i for i, s in enumerate(self.slots) if s is not None and s.decoding]
        if not decoding:
            return
        b = self.cfg.batch_size
        active = np.zeros((b,), bool)
        active[decoding] = True
        logits, self.kv_pool = self._decode_call(self.kv_pool, active)
        self.stats["decode_steps"] += 1
        rows = logits[:, -1, : self.model_cfg.vocab_size]
        uids = [self.slots[i].req.uid if active[i] else 0 for i in range(b)]
        ns = [len(self.slots[i].req.output) if active[i] else 0 for i in range(b)]
        toks = self._pick(rows, uids, ns)
        for i in decoding:
            tok = int(toks[i])
            self._pos[i] += 1
            self._tokens[i, 0] = tok
            self._emit(i, tok, logits_row=rows[i])

    def step(self) -> None:
        """Admit, spend the prefill budget, run one batched decode.  Host
        seconds per phase accumulate in ``stats`` (each phase ends in a
        device-to-host token read, so they include its device work)."""
        self._admit()
        t0 = time.perf_counter()
        self._prefill_phase()
        t1 = time.perf_counter()
        self._decode_phase()
        t2 = time.perf_counter()
        self.stats["prefill_s"] += t1 - t0
        self.stats["decode_s"] += t2 - t1

    @property
    def pending(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    def run(self, requests: Optional[List[Request]] = None, max_steps: int = 100_000):
        if requests:
            for r in requests:
                self.submit(r)
        steps = 0
        while self.pending and steps < max_steps:
            self.step()
            steps += 1
        return requests

    # -- contract access -----------------------------------------------------
    def decode_checker(self, label: str = "paged_decode"):
        """A :class:`~repro_torch.analysis.contracts.ContractChecker` over one
        decode step with the live state (all rows active, on a copy of the
        pool), recorded as it runs on the scheduler's device.  Reference:
        ``repro.serving.scheduler:Scheduler.decode_checker``."""
        from repro_torch.analysis.contracts import ContractChecker

        pool = {k: v.clone() for k, v in self.kv_pool.items()}
        return ContractChecker.record(self._decode_call, pool, np.ones((self.cfg.batch_size,), bool), label=label)

    def decode_weight_rounds(self) -> int:
        """``round`` ops over inputs as large as the model's smallest routed
        weight in one decode step (:meth:`decode_checker`): the
        weight-stationary contract, zero on prepacked params."""
        from repro_torch.analysis.contracts import min_weight_size

        return self.decode_checker().weight_round_ops(min_weight_size(self.arch.param_defs(self.model_cfg)))
