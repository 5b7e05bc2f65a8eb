"""Paged KV cache: fixed-size blocks, a free-list allocator, block tables.

Port of ``repro.serving.kv_cache``.  Flat token position ``p`` of a request
lives at ``(table[p // block_size], p % block_size)``; block ``NULL_BLOCK``
stays zero (unallocated table entries point at it) and blocks
``1 .. batch_size`` are per-slot trash blocks for inactive decode rows.
Only this module indexes the pool.  Unlike the reference (which returns
new arrays), :func:`scatter_kv` and :func:`zero_blocks` write the pool in
place and return it.
"""

from __future__ import annotations

import collections
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

NULL_BLOCK = 0


class BlockAllocator:
    """Host-side free-list allocator over the pool's block ids.  Reference:
    ``repro.serving.kv_cache:BlockAllocator``."""

    def __init__(self, num_blocks: int, block_size: int, *, reserved: int = 1):
        if reserved < 1:
            raise ValueError("need at least the null block reserved")
        if num_blocks <= reserved:
            raise ValueError(
                f"num_blocks={num_blocks} leaves no allocatable blocks "
                f"(reserved={reserved})"
            )
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.reserved = reserved
        self._free: collections.deque = collections.deque(range(reserved, num_blocks))

    def blocks_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Reserve ``n`` blocks, or None (and no change) if unavailable."""
        if n > len(self._free):
            return None
        return [self._free.popleft() for _ in range(n)]

    def free(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            if not (self.reserved <= b < self.num_blocks):
                raise ValueError(f"freed block {b} was never allocatable")
        self._free.extend(blocks)


def init_pool(pool_def: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """Zero pool from ``(shape, axes, dtype)`` leaves whose ``(batch,
    kv_seq)`` axes are read as ``(block, in-block offset)``.  Reference:
    ``repro.serving.kv_cache:init_pool``."""
    out = {}
    for name, (shape, axes, dtype) in pool_def.items():
        if "batch" not in axes or "kv_seq" not in axes:
            raise ValueError(f"cache leaf axes {axes} have no (batch, kv_seq) pair")
        if axes.index("kv_seq") != axes.index("batch") + 1:
            raise ValueError(f"paged pool needs kv_seq right after batch, got axes {axes}")
        out[name] = torch.zeros(shape, dtype=dtype, device=device)
    return out


def token_dest(
    block_table: torch.Tensor,  # (B, W)
    pos: torch.Tensor,  # (B,)
    active: torch.Tensor,  # (B,) bool
    trash_blocks: torch.Tensor,  # (B,)
    block_size: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(block ids, offsets) for one decode token per row; inactive rows go
    to their trash block.  Reference: ``repro.serving.kv_cache:token_dest``."""
    owned = torch.gather(block_table, 1, (pos // block_size)[:, None].to(block_table.dtype))
    blocks = torch.where(active, owned[:, 0], trash_blocks)
    offsets = torch.where(active, pos % block_size, torch.zeros_like(pos))
    return blocks, offsets


def chunk_dest(
    block_table: torch.Tensor, t0: int, tc: int, block_size: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(block ids, offsets) of flat positions ``[t0, t0 + tc)`` of one
    request.  Reference: ``repro.serving.kv_cache:chunk_dest``."""
    flat = t0 + torch.arange(tc, dtype=torch.int64, device=block_table.device)
    return block_table[flat // block_size], flat % block_size


def gather_kv(
    kv_pool: Dict[str, torch.Tensor],  # one layer: leaves (num_blocks, bs, ...)
    block_table: torch.Tensor,  # (B, W)
    length: int,
) -> Dict[str, torch.Tensor]:
    """Contiguous ``(B, length, ...)`` view of each request's first
    ``length`` rows.  Reference: ``repro.serving.kv_cache:gather_kv``."""
    out = {}
    for name, p in kv_pool.items():
        bs = p.shape[1]
        n = -(-length // bs)
        t = block_table[:, :n].to(torch.int64)
        g = p[t].reshape((t.shape[0], n * bs) + tuple(p.shape[2:]))
        out[name] = g[:, :length]
    return out


def scatter_kv(
    kv_pool: Dict[str, torch.Tensor],
    blocks: torch.Tensor,  # (N,)
    offsets: torch.Tensor,  # (N,)
    rows: Dict[str, torch.Tensor],  # leaves (N, ...)
) -> Dict[str, torch.Tensor]:
    """Write N rows at ``(blocks[i], offsets[i])`` in every leaf, in place.
    Reference: ``repro.serving.kv_cache:scatter_kv``."""
    b, o = blocks.to(torch.int64), offsets.to(torch.int64)
    for name, p in kv_pool.items():
        p[b, o] = rows[name].to(p.dtype)
    return kv_pool


def zero_blocks(kv_pool: Dict[str, torch.Tensor], blocks: Sequence[int]) -> Dict[str, torch.Tensor]:
    """Zero the given blocks of every leaf of the stacked pool (leaves
    ``(layers, num_blocks, ...)``), in place.  Reference:
    ``repro.serving.kv_cache:zero_blocks``."""
    for p in kv_pool.values():
        idx = torch.as_tensor(list(blocks), dtype=torch.int64, device=p.device)
        p[:, idx] = 0
    return kv_pool
