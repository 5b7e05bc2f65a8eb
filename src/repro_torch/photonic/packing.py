"""One-time weight prepacking for the weight-stationary photonic engine.

Port of ``repro.photonic.packing`` (unsharded layout; ``fuse_qkv_params``
and the K-sharded banks wait for their slices).  :func:`prepack_params`
walks a parameter tree against its definition tree and replaces every
routed dense weight with a :class:`PackedDense`: per-column int8 weights
(bitwise the per-call ``quantize_symmetric(w, bits, axis=0)``), stored
tile-padded in the kernel's ``(Kp, Cp)`` layout for the ``kernel`` backend,
plus — for a noisy channel — the weight's content word for the noise-stream
seed, computed once here instead of on every decode step.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.dpu import quantize_symmetric
from repro_torch.noise.stages import tweak_word
from repro_torch.photonic.engine import PhotonicEngine, pallas_tiling


class PackedDense:
    """A prepacked dense weight.  Reference:
    ``repro.photonic.packing:PackedDense`` (``shards`` is always 1 here).

    ``wq`` int8 ``(K, C)`` or tile-padded ``(Kp, Cp)`` when ``tiling`` is
    set; ``w_scale`` f32 ``(C,)``; ``k, c`` the logical dims; ``w_word`` the
    0-dim int64 content word of ``wq`` (or None when no stream needs it).
    """

    __slots__ = ("wq", "w_scale", "k", "c", "tiling", "shards", "w_word")

    def __init__(
        self,
        wq: torch.Tensor,
        w_scale: torch.Tensor,
        k: int,
        c: int,
        tiling: Optional[Tuple[int, int, int]] = None,
        shards: int = 1,
        w_word: Optional[torch.Tensor] = None,
    ):
        if shards != 1:
            raise NotImplementedError(
                "K-sharded packs wait for the tensor-parallel slice "
                "(ROADMAP.md Queue 1, 'Tensor parallel')"
            )
        self.wq = wq
        self.w_scale = w_scale
        self.k = k
        self.c = c
        self.tiling = tiling
        self.shards = shards
        self.w_word = w_word

    def dequant(self) -> torch.Tensor:
        """The float32 weight this pack represents (logical K x C)."""
        wq = self.wq[: self.k, : self.c]
        return wq.to(torch.float32) * self.w_scale.to(torch.float32)[None, :]

    def __repr__(self):
        return (
            f"PackedDense(k={self.k}, c={self.c}, stored={tuple(self.wq.shape)}, "
            f"tiling={self.tiling}, shards={self.shards})"
        )


def site_name(path: Tuple) -> str:
    """Dotted site name of a dense def at ``path`` (integer layer indices in
    the path are skipped like any wrapper component).  Reference:
    ``repro.photonic.packing:site_name``."""
    parts = list(path)
    if not parts:
        return "root"
    for i in range(len(parts) - 1, -1, -1):
        if parts[i] in ("attn", "ffn"):
            return ".".join(str(p) for p in parts[i:])
        if parts[i] == "cross" and i == len(parts) - 2:
            return "attn." + parts[-1]
    return str(parts[-1])


def _is_dense_def(node: Any) -> bool:
    if not isinstance(node, dict) or "w" not in node:
        return False
    w = node["w"]
    return not isinstance(w, dict) and hasattr(w, "shape") and len(w.shape) >= 2


def pack_dense(params: dict, engine: PhotonicEngine, *, already_quantized: bool = False) -> dict:
    """Pack one dense-layer param dict ``{"w", ["w_scale"], ["b"]}``.
    Reference: ``repro.photonic.packing:pack_dense`` (``shards=1``)."""
    w = params["w"]
    if already_quantized or "w_scale" in params:
        wq = w
        scale = params["w_scale"].to(torch.float32)
    else:
        wq, s = quantize_symmetric(w, engine.dpu.operand_bits, axis=-2)
        scale = s.squeeze(-2)
    k, c = wq.shape[-2], wq.shape[-1]
    tiling = None
    if engine.backend == "kernel":
        n_chunk, tile_k, tile_c = pallas_tiling(engine.dpu, k, c)
        kp = -(-k // tile_k) * tile_k
        cp = -(-c // tile_c) * tile_c
        wq = F.pad(wq, (0, cp - c, 0, kp - k)).contiguous()
        tiling = (n_chunk, tile_k, tile_c)
    w_word = tweak_word(wq) if engine.noisy else None
    out = {"w": PackedDense(wq, scale, k, c, tiling, 1, w_word)}
    if "b" in params:
        out["b"] = params["b"]
    return out


def prepack_params(params: Any, defs: Any, engine: PhotonicEngine) -> Any:
    """Prepack every policy-routed dense site of a parameter tree (dicts and
    per-layer lists).  Reference: ``repro.photonic.packing:prepack_params``
    (single device)."""

    def walk(p, d, path):
        if _is_dense_def(d):
            if engine.routes(site_name(path)):
                return pack_dense(p, engine, already_quantized="w_scale" in d)
            return p
        if isinstance(d, dict):
            return {k: walk(p[k], d[k], path + (k,)) for k in d}
        if isinstance(d, list):
            return [walk(pi, di, path + (i,)) for i, (pi, di) in enumerate(zip(p, d))]
        return p

    return walk(params, defs, ())
