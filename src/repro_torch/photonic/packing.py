"""One-time weight prepacking for the weight-stationary photonic engine.

Port of ``repro.photonic.packing`` (unsharded layout; the K-sharded banks
wait for their slice).  :func:`prepack_params` walks a parameter tree
against its definition tree and replaces every routed dense weight with a
:class:`PackedDense`: per-column int8 weights (bitwise the per-call
``quantize_symmetric(w, bits, axis=0)``), stored tile-padded in the
kernel's ``(Kp, Cp)`` layout for the ``kernel`` backend, plus — for a noisy
channel — the weight's content word for the noise-stream seed, computed
once here instead of on every decode step.  A pack also caches, per plane
width, the planes of its bank and their words for bit-sliced execution
(:meth:`PackedDense.planes`).  :func:`fuse_qkv_params` fuses an attention
dict's Q/K/V projections into one ``wqkv`` bank.  :func:`reprogram_cost`
prices the weight-stationary reprogramming that packing amortizes (the
mapper's replication price).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.dpu import quantize_symmetric
from repro_torch.noise.stages import tweak_word
from repro_torch.photonic.engine import PhotonicEngine, pallas_tiling, plane_operands


@dataclasses.dataclass(frozen=True)
class ReprogramCost:
    """Latency/energy to (re)program one weight tile onto a DPU's rings.
    Reference: ``repro.photonic.packing:ReprogramCost``.

    The tile is EO-tuned once (``latency_s``, Table VI) and then streamed
    against for free.  The mapper prices replication with it
    (``AcceleratorConfig.weight_reprogram_cost``): a row-split replica
    re-programs the full tile chain, so it must stream long enough to
    cover its own reprogramming.
    """

    latency_s: float
    energy_j: float
    rings: int


def reprogram_cost(
    rings: int, *, tune_latency_s: float, tune_power_w_per_ring: float
) -> ReprogramCost:
    """Cost of programming ``rings`` weight rings in one tuning pass.
    Reference: ``repro.photonic.packing:reprogram_cost``.  (Energy is
    spelled ``(power x latency) x rings`` to stay bit-identical with the
    legacy simulator's tune-energy accounting.)"""
    return ReprogramCost(
        latency_s=tune_latency_s,
        energy_j=tune_power_w_per_ring * tune_latency_s * rings,
        rings=rings,
    )


class PackedDense:
    """A prepacked dense weight.  Reference:
    ``repro.photonic.packing:PackedDense`` (``shards`` is always 1 here).

    ``wq`` int8 ``(K, C)`` or tile-padded ``(Kp, Cp)`` when ``tiling`` is
    set; ``w_scale`` f32 ``(C,)``; ``k, c`` the logical dims; ``w_word`` the
    0-dim int64 content word of ``wq`` (or None when no stream needs it).
    """

    __slots__ = ("wq", "w_scale", "k", "c", "tiling", "shards", "w_word", "_planes")

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
        self._planes = {}

    def planes(self, plane_bits: int, planes: int, shape: Tuple[int, int], with_words: bool):
        """The bit-sliced mode's weight operands, cached per plane width:
        the ``planes`` signed-magnitude planes of the logical bank,
        zero-padded to ``shape`` (the plane engine's ``(Kp, Cp)``), and each
        plane's content word when ``with_words``; bitwise what
        :func:`~repro_torch.photonic.engine.plane_operands` gives per call.
        Computed at the first sliced call, so decode neither re-slices nor
        re-hashes the bank."""
        key = (plane_bits, planes, tuple(shape), with_words)
        if key not in self._planes:
            self._planes[key] = plane_operands(self.wq[: self.k, : self.c], plane_bits, planes, shape, with_words)
        return self._planes[key]

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


def fuse_qkv_params(attn: dict, engine: PhotonicEngine) -> dict:
    """Fuse a self-attention dict's ``wq``/``wk``/``wv`` into one ``wqkv``
    bank of width ``Cq + Ck + Cv``, so the three projections run as one
    engine call (``models/attention.py::_qkv_proj`` splits the columns
    back).  Per-column quantization, the K-chunked accumulation and the
    epilogue are column-independent, so under a deterministic channel the
    fused call equals the three calls bitwise; a noisy channel draws
    another, equally valid stream (the site is "attn.wqkv").

    Takes prepacked (:class:`PackedDense`), int8-stored (``w`` + per-column
    ``w_scale``) or float parts; mixed layouts, a bias on only some of
    Q/K/V, and a missing projection raise.  A fused pack is re-padded for
    the ``kernel`` backend and carries the content word of the fused bank
    when the channel is noisy.  Reference:
    ``repro.photonic.packing:fuse_qkv_params``."""
    names = ("wq", "wk", "wv")
    missing = [n for n in names if n not in attn]
    if missing:
        raise KeyError(f"fuse_qkv_params: attention dict lacks {missing}")
    parts = [attn[n] for n in names]
    packed = [isinstance(p["w"], PackedDense) for p in parts]
    scaled = ["w_scale" in p for p in parts]
    if (any(packed) and not all(packed)) or (any(scaled) and not all(scaled)):
        raise ValueError("fuse_qkv_params: mixed Q/K/V weight layouts")
    with_bias = ["b" in p for p in parts]
    if any(with_bias) and not all(with_bias):
        raise ValueError("fuse_qkv_params: bias on only some of Q/K/V")

    if all(packed):
        packs = [p["w"] for p in parts]
        k = packs[0].k
        if any(pk.k != k for pk in packs):
            raise ValueError(f"fuse_qkv_params: mismatched K {[pk.k for pk in packs]}")
        # Each bank cut to its logical columns (dropping its tile padding),
        # concatenated, re-padded once for the fused width.
        wq = torch.cat([pk.wq[: pk.k, : pk.c] for pk in packs], dim=-1)
        scale = torch.cat([pk.w_scale for pk in packs], dim=-1)
        c = sum(pk.c for pk in packs)
        tiling = None
        if engine.backend == "kernel":
            n_chunk, tile_k, tile_c = pallas_tiling(engine.dpu, k, c)
            kp = -(-k // tile_k) * tile_k
            cp = -(-c // tile_c) * tile_c
            wq = F.pad(wq, (0, cp - c, 0, kp - k))
            tiling = (n_chunk, tile_k, tile_c)
        wq = wq.contiguous()
        w_word = tweak_word(wq) if engine.noisy else None
        fused = {"w": PackedDense(wq, scale, k, c, tiling, 1, w_word)}
    elif all(scaled):
        fused = {
            "w": torch.cat([p["w"] for p in parts], dim=-1),
            "w_scale": torch.cat([p["w_scale"] for p in parts], dim=-1),
        }
    else:
        fused = {"w": torch.cat([p["w"] for p in parts], dim=-1)}

    if all(with_bias):
        fused["b"] = torch.cat([p["b"] for p in parts], dim=-1)
    out = {name: val for name, val in attn.items() if name not in names}
    out["wqkv"] = fused
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
