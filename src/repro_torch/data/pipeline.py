"""Deterministic, shard-aware synthetic token pipeline.

Port of ``repro.data.pipeline``: the port's own copy of the numpy
generator, so a batch is bitwise the reference's.  Generation is keyed on
``(seed, step, shard)``, which makes the stream resumable by
construction: a run restarted from checkpoint step k sees exactly the
batches an uninterrupted run would have seen.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch._device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Reference: ``repro.data.pipeline:DataConfig``."""

    vocab_size: int = 50304
    seq_len: int = 1024
    global_batch: int = 64
    seed: int = 0
    # a mixture of zipf-ish unigrams and copy runs: learnable structure
    copy_prob: float = 0.3


class SyntheticTokens:
    """Infinite deterministic token stream.  Reference:
    ``repro.data.pipeline:SyntheticTokens``."""

    def __init__(self, cfg: DataConfig, shard_index: int = 0, num_shards: int = 1):
        if cfg.global_batch % num_shards:
            raise ValueError(f"global_batch={cfg.global_batch} does not split into {num_shards} shards")
        self.cfg = cfg
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.local_batch = cfg.global_batch // num_shards
        probs = 1.0 / np.arange(1, cfg.vocab_size + 1) ** 1.1
        self._probs = probs / probs.sum()

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """The batch of a global step (stateless, hence resumable)."""
        cfg = self.cfg
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step, self.shard_index]))
        toks = rng.choice(
            cfg.vocab_size, size=(self.local_batch, cfg.seq_len + 1), p=self._probs
        ).astype(np.int32)
        # copy structure: the second half of some rows repeats the first
        copy_rows = rng.random(self.local_batch) < cfg.copy_prob
        half = (cfg.seq_len + 1) // 2
        toks[copy_rows, half : 2 * half] = toks[copy_rows, :half]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def local_rows(t, sharding):
    """This rank's rows of the global ``t`` under ``sharding`` (a
    :class:`~repro_torch.runtime.sharding.NamedSharding` whose spec shards
    the leading dimension, as ``P(dp_axes)`` does): the equal block at the
    rank's coordinate over those mesh axes, row-major; all of ``t`` when
    the leading dimension is replicated."""
    from repro_torch.runtime.sharding import local_block

    i, n = local_block(sharding.spec[0] if sharding.spec else None, sharding.mesh)
    if t.shape[0] % n:
        raise ValueError(f"{t.shape[0]} rows do not split into {n} blocks")
    rows = t.shape[0] // n
    return t[i * rows : (i + 1) * rows]


def make_global_batch(stream: SyntheticTokens, step: int, device=None, sharding=None) -> Dict[str, torch.Tensor]:
    """A step's batch as int32 tensors on ``device`` (``cuda`` unless asked
    otherwise): the whole global batch, or with ``sharding`` this rank's
    rows of it (:func:`local_rows`), slices of the one global stream (a
    ``SyntheticTokens(shard_index=...)`` stream draws other batches).
    Reference: ``repro.data.pipeline:make_global_batch``."""
    dev = resolve_device(device)
    host = stream.batch_at(step)
    if sharding is not None:
        host = {k: local_rows(v, sharding) for k, v in host.items()}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in host.items()}
