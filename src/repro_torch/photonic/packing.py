"""One-time weight prepacking for the weight-stationary photonic engine.

Port of ``repro.photonic.packing``.  :func:`prepack_params` walks a
parameter tree against its definition tree and replaces every routed dense
weight with a :class:`PackedDense`: per-column int8 weights (bitwise the
per-call ``quantize_symmetric(w, bits, axis=0)``), stored tile-padded in the
kernel's ``(Kp, Cp)`` layout for the ``kernel`` backend, plus — for a noisy
channel — the weight's content word for the noise-stream seed, computed
once here instead of on every decode step.  With ``shards > 1`` the bank is
stored K-sharded for tensor-parallel execution
(:mod:`repro_torch.photonic.sharded`): quantized globally, split into
``shards`` row blocks each tile-padded for the shard-local engine; under a
mesh each rank keeps only its own block.  A pack also caches, per plane
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
from repro_torch.noise.stages import tweak_word, tweak_words
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
    ``repro.photonic.packing:PackedDense``.

    ``wq`` int8 ``(K, C)`` or tile-padded ``(Kp, Cp)`` when ``tiling`` is
    set; with ``shards > 1`` the concatenation of the per-shard banks,
    ``(shards * Kp_local, Cp)``, each tile-padded for its shard-local
    ``tiling`` (``(K, C)`` rows in order without one).  ``shard`` is set
    when the pack holds only that shard's block (a rank's share under a
    mesh): ``wq`` is then ``(Kp_local, Cp)``.  ``w_scale`` f32 ``(C,)``,
    always the global per-column scale; ``k, c`` the logical global dims;
    ``w_word`` the content word the noise stream folds for the bank (0-dim
    int64; int64 ``(shards,)``, one word a block, when sharded), or None
    when no stream needs it.
    """

    __slots__ = ("wq", "w_scale", "k", "c", "tiling", "shards", "w_word", "shard", "_planes", "_views")

    def __init__(
        self,
        wq: torch.Tensor,
        w_scale: torch.Tensor,
        k: int,
        c: int,
        tiling: Optional[Tuple[int, int, int]] = None,
        shards: int = 1,
        w_word: Optional[torch.Tensor] = None,
        shard: Optional[int] = None,
    ):
        if shard is not None and not 0 <= shard < shards:
            raise ValueError(f"shard={shard} outside [0, {shards})")
        self.wq = wq
        self.w_scale = w_scale
        self.k = k
        self.c = c
        self.tiling = tiling
        self.shards = shards
        self.w_word = w_word
        self.shard = shard
        self._planes = {}
        self._views = {}

    @property
    def k_local(self) -> int:
        """Per-shard logical contraction length."""
        return self.k // self.shards

    def _block_rows(self, parts: int) -> int:
        """Stored rows of one of ``parts`` row blocks."""
        if self.tiling is not None:
            return self.wq.shape[-2] // (1 if self.shard is not None else self.shards)
        return self.k // parts

    def local(self, i: int, parts: int) -> "PackedDense":
        """Block ``i`` of ``parts`` K-blocks as an unsharded pack over the
        logical ``(K/parts, C)``: a K-sharded pack's own bank (``parts`` is
        its ``shards``), or rows of an unsharded raw ``(K, C)`` bank; the
        global scale, the block's content word when the pack carries
        words.  Cached, so a block's planes and words are made once."""
        if i not in self._views:
            if self.shard is not None and i != self.shard:
                raise ValueError(f"this pack holds shard {self.shard} only, not shard {i}")
            if self.shards not in (1, parts) or (self.tiling is not None and self.shards != parts):
                raise ValueError(f"{self!r} cannot be split into {parts} K-blocks")
            rows = self._block_rows(parts)
            start = 0 if self.shard is not None else i * rows
            wq = self.wq[start : start + rows]
            k_local = self.k // parts
            if self.tiling is None:
                wq = wq[:, : self.c]
            word = None
            if self.shards > 1 and self.w_word is not None:
                word = self.w_word[i]
            self._views[i] = PackedDense(wq.contiguous(), self.w_scale, k_local, self.c, self.tiling, 1, word)
        return self._views[i]

    def only(self, i: int) -> "PackedDense":
        """This K-sharded pack reduced to shard ``i``'s block (what a rank
        keeps under a mesh)."""
        if self.shards == 1:
            raise ValueError("only() takes a K-sharded pack")
        if self.shard is not None:
            if i != self.shard:
                raise ValueError(f"this pack holds shard {self.shard} only, not shard {i}")
            return self
        rows = self._block_rows(self.shards)
        wq = self.wq[i * rows : (i + 1) * rows].contiguous()
        return PackedDense(wq, self.w_scale, self.k, self.c, self.tiling, self.shards, self.w_word, i)

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
        """The float32 weight this pack represents (logical K x C); for a
        pack that holds one shard's block, that block's ``(K/shards, C)``
        rows."""
        if self.shard is not None:
            wq = self.wq[: self.k_local, : self.c]
        elif self.shards > 1:
            rows = self.wq.shape[-2] // self.shards
            wq = self.wq.reshape(self.shards, rows, self.wq.shape[-1])[:, : self.k_local, : self.c]
            wq = wq.reshape(self.k, self.c)
        else:
            wq = self.wq[: self.k, : self.c]
        return wq.to(torch.float32) * self.w_scale.to(torch.float32)[None, :]

    def __repr__(self):
        held = "" if self.shard is None else f", shard={self.shard}"
        return (
            f"PackedDense(k={self.k}, c={self.c}, stored={tuple(self.wq.shape)}, "
            f"tiling={self.tiling}, shards={self.shards}{held})"
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


def pack_dense(
    params: dict, engine: PhotonicEngine, *, already_quantized: bool = False, shards: int = 1
) -> dict:
    """Pack one dense-layer param dict ``{"w", ["w_scale"], ["b"]}``.
    Reference: ``repro.photonic.packing:pack_dense``.

    ``shards > 1`` stores the K-sharded layout: the quantization stays
    global (bitwise scales), then the int8 bank splits into ``shards`` row
    blocks of ``K/shards``, each tile-padded for the shard-local engine
    (``pallas_tiling`` of ``dpu.shard_local(K/shards)``), concatenated; a
    noisy engine's pack carries one content word a block."""
    w = params["w"]
    if already_quantized or "w_scale" in params:
        wq = w
        scale = params["w_scale"].to(torch.float32)
    else:
        wq, s = quantize_symmetric(w, engine.dpu.operand_bits, axis=-2)
        scale = s.squeeze(-2)
    k, c = wq.shape[-2], wq.shape[-1]
    if shards > 1 and k % shards:
        raise ValueError(f"K={k} is not divisible by shards={shards}")
    k_local = k // shards
    tiling = None
    if engine.backend == "kernel":
        tile_dpu = engine.dpu.shard_local(k_local) if shards > 1 else engine.dpu
        n_chunk, tile_k, tile_c = pallas_tiling(tile_dpu, k_local, c)
        kp = -(-k_local // tile_k) * tile_k
        cp = -(-c // tile_c) * tile_c
        lead = wq.shape[:-2]
        wq = wq.reshape(*lead, shards, k_local, c)
        wq = F.pad(wq, (0, cp - c, 0, kp - k_local)).reshape(*lead, shards * kp, cp).contiguous()
        tiling = (n_chunk, tile_k, tile_c)
    w_word = None
    if engine.noisy:
        if shards == 1:
            w_word = tweak_word(wq)
        else:
            w_word = tweak_words(wq.reshape(shards, wq.shape[-2] // shards, wq.shape[-1]))
    out = {"w": PackedDense(wq, scale, k, c, tiling, shards, w_word)}
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
    ``w_scale``) or float parts; mixed layouts, K-sharded packs, a bias on
    only some of Q/K/V, and a missing projection raise.  A fused pack is re-padded for
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
        if any(pk.shards != 1 for pk in packs):
            raise ValueError("fuse_qkv_params: K-sharded packs not supported")
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


def prepack_params(
    params: Any, defs: Any, engine: PhotonicEngine, *, mesh=None, axis: str = "model"
) -> Any:
    """Prepack every policy-routed dense site of a parameter tree (dicts and
    per-layer lists).  Reference: ``repro.photonic.packing:prepack_params``.

    With ``mesh`` (a :class:`~torch.distributed.device_mesh.DeviceMesh`
    whose ``axis`` is sized > 1) the banks take the K-sharded layout and
    this rank keeps only its own block and the global scale, ready for
    :mod:`repro_torch.photonic.sharded`; a site whose K the axis does not
    divide keeps the unsharded layout (and the single-device path at call
    time)."""
    shards, rank = 1, 0
    if mesh is not None and axis in (mesh.mesh_dim_names or ()):
        shards = mesh.size(mesh.mesh_dim_names.index(axis))
        rank = mesh.get_local_rank(axis)

    def walk(p, d, path):
        if _is_dense_def(d):
            if engine.routes(site_name(path)):
                k = p["w"].shape[-2]
                site_shards = shards if k % shards == 0 else 1
                packed = pack_dense(p, engine, already_quantized="w_scale" in d, shards=site_shards)
                if site_shards > 1:
                    packed["w"] = packed["w"].only(rank)
                return packed
            return p
        if isinstance(d, dict):
            return {k: walk(p[k], d[k], path + (k,)) for k in d}
        if isinstance(d, list):
            return [walk(pi, di, path + (i,)) for i, (pi, di) in enumerate(zip(p, d))]
        return p

    return walk(params, defs, ())
