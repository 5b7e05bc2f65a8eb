"""The photonic execution engine: one dispatcher for every DPU GEMM.

Port of ``repro.photonic.engine``.  A frozen :class:`PhotonicEngine` holds
the operating point (:class:`~repro_torch.core.dpu.DPUConfig`), a backend
and a :class:`SitePolicy`; :meth:`PhotonicEngine.matmul` is the
weight-stationary hot path (float activation against a prepacked int8
weight), :meth:`PhotonicEngine.int_gemm` the integer datapath every caller
shares.

Backends: ``kernel``, the default (the photonic GEMM kernels: the CUDA
kernel on CUDA tensors, its plain twin on CPU tensors — the port's
counterpart of the reference's ``pallas`` backend, whose interpret mode
plays the twin's role on CPU), ``ref`` (the untiled oracle) and ``exact``
(the ideal integer GEMM).

The float entry points train: :meth:`PhotonicEngine.matmul_float` and
:meth:`PhotonicEngine.matmul` are ``torch.autograd.Function``s around the
whole forward (quantization and the kernel inside), with the reference's
straight-through backward: dense f32 products of the float operands, the
activation's derivative taken at the dense pre-activation.

Contracts carried over: with an ideal channel every backend equals
``exact_int_gemm`` bitwise; deterministic analog stages are bitwise across
backends; noisy calls derive their stream from ``DPUConfig.noise_seed``
folded with the site name, the layer index and a content word of each
operand.  The weight's word is constant for a prepacked weight, so
:class:`~repro_torch.photonic.packing.PackedDense` carries it (computed once
at pack time, bitwise the per-call value) and decode never re-hashes the
int8 weight bank.

Bit-sliced execution (``slicing=``, DESIGN.md §15): each operand splits
into ``plane_bits``-wide signed-magnitude planes, every plane pair runs as
one unfused pass (``photonic_gemm`` on the ``kernel`` backend) through the
channel re-referred to the plane full-scale, and the passes recombine with
exact shifts; the epilogue is then applied digitally.  A pack caches its
weight planes and their content words per plane width
(:meth:`~repro_torch.photonic.packing.PackedDense.planes`), so decode
neither re-slices nor re-hashes the bank.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.core.dpu import (
    DPUConfig,
    bit_slices,
    quant_scale,
    quantize_symmetric,
    quantize_with_scale,
)
from repro_torch.kernels.photonic_gemm.epilogue import (
    ACTIVATIONS,
    EpilogueArgs,
    EpilogueSpec,
    apply_epilogue,
    as_epilogue,
)
from repro_torch.kernels.photonic_gemm.kernel import (
    photonic_gemm,
    photonic_gemm_fused,
    seed_words,
)
from repro_torch.kernels.photonic_gemm.ref import exact_int_gemm, photonic_gemm_ref
from repro_torch.noise.channel import sliced_channel
from repro_torch.noise.stages import (
    fold_seed,
    fold_words,
    seed_from_key,
    seed_from_key_words,
    tweak_word,
    tweak_words,
)
from repro_torch.photonic.slicing import SlicingSpec, resolve_slicing

BACKENDS = ("ref", "kernel", "exact")

# Stream-domain tag folded in ahead of the shard index of a K-sharded GEMM,
# so the (site, fold=i) and (site, shard=i) streams never coincide.
# Reference: ``repro.photonic.engine:SHARD_STREAM_TAG``.
SHARD_STREAM_TAG = 0x5348

# Stream-domain tag folded in ahead of the plane-pair index of a sliced GEMM,
# so plane streams decorrelate from each other and never collide with a
# layer-fold or shard stream.  Reference:
# ``repro.photonic.engine:PLANE_STREAM_TAG``.
PLANE_STREAM_TAG = 0x504C


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _digital_reference(x, wf, bias, spec: EpilogueSpec) -> torch.Tensor:
    """Non-routed fallback in the historical digital op order.  Reference:
    ``repro.photonic.engine:_digital_reference``."""
    y = x @ wf
    if bias is not None:
        y = y + bias.to(y.dtype)
    if spec.activation is not None:
        y = ACTIVATIONS[spec.activation](y)
    return y


def plane_operands(
    q: torch.Tensor, plane_bits: int, planes: int, shape: Tuple[int, int], with_words: bool
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The planes of an int operand ``q`` zero-padded to ``shape``, as one
    contiguous int8 ``(planes, *shape)`` tensor, and each plane's content
    word (int64 ``(planes,)``, or None).  Zero padding slices to zero
    planes and hashes to nothing, so the words are the logical planes'."""
    r, k = q.shape
    qp = F.pad(q, (0, shape[1] - k, 0, shape[0] - r))
    pl = bit_slices(qp, plane_bits, planes)
    return pl, (tweak_words(pl) if with_words else None)


def site_hash(site: str) -> int:
    """Stable 32-bit FNV-1a of a site name.  Reference:
    ``repro.photonic.engine:site_hash``."""
    h = 2166136261
    for ch in site.encode():
        h = (h ^ ch) * 16777619 & 0xFFFFFFFF
    return h


def pallas_tiling(cfg: DPUConfig, k: int, c: int) -> Tuple[int, int, int]:
    """The *logical* tiling ``(n_chunk, tile_k, tile_c)`` for a (K, C) weight,
    which the noise-stream ids derive from.  Reference:
    ``repro.photonic.engine:pallas_tiling``."""
    channel = cfg.effective_channel()
    analog = channel is not None and channel.analog
    adc_bits = channel.adc_bits if channel is not None else cfg.adc_bits
    if adc_bits is None and not analog:
        tile_k = 512 if k >= 512 else _round_up(max(k, 128), 128)
        n_chunk = min(128, tile_k)
    else:
        n = cfg.n
        n_chunk = n
        tile_k = n * max(1, 512 // n)
    tile_c = min(128, _round_up(c, 128))
    return n_chunk, tile_k, tile_c


def kernel_stages(
    cfg: DPUConfig,
    r: int,
    k: int,
    c: int,
    tiling: Optional[Tuple[int, int, int]] = None,
    *,
    tile_r: int = 128,
    tile_c: int = 128,
) -> Tuple[dict, Tuple[int, int, int]]:
    """The photonic GEMM kernels' stage arguments for a logical
    ``(r, k) x (k, c)`` GEMM at operating point ``cfg``, and the padded
    operand shape ``(Rp, Kp, Cp)`` they take.  ``tiling`` is a prepacked
    weight's ``(n_chunk, tile_k, tile_c)``; without it the logical tiling
    comes from :func:`pallas_tiling`.  Reference: the kernel branch of
    ``repro.photonic.engine:PhotonicEngine.int_gemm``."""
    ch = cfg.effective_channel()
    analog = ch is not None and ch.analog
    noisy = analog and ch.detector_sigma_lsb > 0.0
    if tiling is not None:
        n_chunk, tile_k, tc = tiling
    else:
        n_chunk, tile_k, _ = pallas_tiling(cfg, k, c)
        tc = min(tile_c, _round_up(c, 128))
    tr = min(tile_r, _round_up(r, 8))
    stages = dict(
        slice_bits=cfg.bits,
        num_slices=cfg.num_slices,
        n_chunk=n_chunk,
        adc_bits=ch.adc_bits if ch is not None else cfg.adc_bits,
        noise_sigma=ch.detector_sigma_lsb if analog else 0.0,
        filter_alpha=ch.filter_alpha if analog else 0.0,
        intermod_eps=ch.intermod_eps if analog else 0.0,
        crossweight_eps=ch.crossweight_eps if analog else 0.0,
        valid_chunks=-(-k // n_chunk) if noisy else None,
        tile_r=tr,
        tile_c=tc,
        tile_k=tile_k,
    )
    return stages, (_round_up(r, tr), _round_up(k, tile_k), _round_up(c, tc))


@dataclasses.dataclass(frozen=True)
class SitePolicy:
    """Which named GEMM sites execute on the photonic DPU.  Reference:
    ``repro.photonic.engine:SitePolicy``."""

    include: Tuple[str, ...] = ("*",)
    exclude: Tuple[str, ...] = ("router",)

    def routes(self, site: Optional[str]) -> bool:
        if site is None:
            return True
        return self._match(self.include, site) and not self._match(self.exclude, site)

    @staticmethod
    def _match(patterns: Tuple[str, ...], site: str) -> bool:
        leaf = site.rsplit(".", 1)[-1]
        return any(
            fnmatch.fnmatchcase(site, p) or fnmatch.fnmatchcase(leaf, p)
            for p in patterns
        )


@dataclasses.dataclass(frozen=True)
class EngineInfo:
    """Structured ``PhotonicEngine.describe()`` result.  Reference:
    ``repro.photonic.engine:EngineInfo``."""

    backend: str
    organization: str
    platform: str
    blocks: Tuple[str, ...]
    through_devices: str
    bits: int
    n: int
    datarate_gs: float
    channel: str
    slicing: Optional[int]
    include: Tuple[str, ...]
    exclude: Tuple[str, ...]

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        extra = "" if self.platform == "SOI" else f"platform={self.platform}, "
        if self.slicing is not None:
            extra += f"slicing={self.slicing}b planes, "
        return (
            f"{self.backend} backend, {self.organization} "
            f"(blocks {'->'.join(self.blocks)}, through {self.through_devices}) "
            f"B={self.bits} N={self.n} @ {self.datarate_gs} GS/s, "
            f"channel={self.channel}, {extra}"
            f"sites include={list(self.include)} "
            f"exclude={list(self.exclude)}"
        )


@dataclasses.dataclass(frozen=True)
class PhotonicEngine:
    """Frozen photonic operating point + routing policy.  Reference:
    ``repro.photonic.engine:PhotonicEngine``.  ``slicing`` (anything
    :func:`~repro_torch.photonic.slicing.resolve_slicing` takes) selects
    the bit-sliced execution mode for every routed GEMM."""

    dpu: DPUConfig = DPUConfig()
    backend: str = "kernel"
    policy: SitePolicy = SitePolicy()
    slicing: Optional[SlicingSpec] = None

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown photonic backend {self.backend!r}; expected one of "
                f"{BACKENDS}"
            )
        object.__setattr__(self, "slicing", resolve_slicing(self.slicing))

    def routes(self, site: Optional[str]) -> bool:
        return self.policy.routes(site)

    def with_slicing(self, slicing) -> "PhotonicEngine":
        """This engine with another slicing mode (frozen replace).
        Reference: ``repro.photonic.engine:PhotonicEngine.with_slicing``."""
        spec = resolve_slicing(slicing)
        if spec == self.slicing:
            return self
        return dataclasses.replace(self, slicing=spec)

    @property
    def noisy(self) -> bool:
        ch = self.dpu.effective_channel()
        return ch is not None and ch.analog and ch.detector_sigma_lsb > 0.0

    def describe(self) -> EngineInfo:
        d = self.dpu
        ch = d.effective_channel()
        spec = d.org_spec
        return EngineInfo(
            backend=self.backend,
            organization=d.organization,
            platform=ch.platform if ch is not None else d.platform,
            blocks=tuple(spec.blocks),
            through_devices=spec.through_devices,
            bits=d.bits,
            n=d.n,
            datarate_gs=d.datarate_gs,
            channel="analog" if ch is not None and ch.analog else "ideal",
            slicing=None if self.slicing is None else self.slicing.plane_bits,
            include=tuple(self.policy.include),
            exclude=tuple(self.policy.exclude),
        )

    # -- seed derivation -----------------------------------------------------
    def _site_key(self, site: Optional[str], fold: Optional[int], prng_key, shard: Optional[int] = None):
        """``prng_key`` with the site hash, the layer index and
        ``(SHARD_STREAM_TAG, shard)`` folded in (``jax.random.fold_in`` on
        the host)."""
        key = prng.key_data(prng_key)
        if site is not None:
            key = prng.fold_in(key, site_hash(site) & 0x7FFFFFFF)
        if fold is not None:
            key = prng.fold_in(key, int(fold))
        if shard is not None:
            key = prng.fold_in(prng.fold_in(key, SHARD_STREAM_TAG), int(shard))
        return key

    def _site_seed(
        self,
        site: Optional[str],
        fold: Optional[int],
        prng_key,
        plane: Optional[int] = None,
        shard: Optional[int] = None,
    ) -> int:
        """The stream seed before the operands' content words (a host
        integer).  A key wins over ``noise_seed``: site hash, layer index,
        ``(SHARD_STREAM_TAG, shard)`` and ``(PLANE_STREAM_TAG, plane)`` are
        folded into the key, which then collapses through
        ``seed_from_key``; without one they are folded into ``noise_seed``
        by ``fold_seed`` in the same order."""
        if prng_key is not None:
            key = self._site_key(site, fold, prng_key, shard)
            if plane is not None:
                key = prng.fold_in(prng.fold_in(key, PLANE_STREAM_TAG), plane)
            return seed_from_key(key)
        seed = self.dpu.noise_seed_array(None)
        if site is not None:
            seed = fold_seed(seed, site_hash(site))
        if fold is not None:
            seed = fold_seed(seed, int(fold))
        if shard is not None:
            seed = fold_seed(seed, SHARD_STREAM_TAG, int(shard))
        if plane is not None:
            seed = fold_seed(seed, PLANE_STREAM_TAG, plane)
        return seed

    def _plane_seeds(self, site, fold, prng_key, n: int, device, shard: Optional[int] = None) -> torch.Tensor:
        """:meth:`_site_seed` of plane passes ``0 .. n-1`` (int64 ``(n,)``
        on ``device``), as one vectorized fold on the device (no host copy,
        so a CUDA graph can hold it): ``fold_seed`` of the plane ids without
        a key; with one, the site/layer/tag key folded on the host, then
        ``fold_in`` of each plane id (the threefry block of ``(0, id)``) and
        ``seed_from_key`` elementwise."""
        ids = torch.arange(n, dtype=torch.int64, device=device)
        if prng_key is None:
            return fold_seed(self._site_seed(site, fold, None, shard=shard), PLANE_STREAM_TAG, ids)
        k1, k2 = (int(w) for w in prng.fold_in(self._site_key(site, fold, prng_key, shard), PLANE_STREAM_TAG))
        return seed_from_key_words(*prng.threefry2x32(k1, k2, torch.zeros_like(ids), ids))

    def stream_seed(
        self,
        site: Optional[str],
        fold: Optional[int],
        xq: torch.Tensor,
        wq: torch.Tensor,
        *,
        w_word: Optional[torch.Tensor] = None,
        x_word: Optional[torch.Tensor] = None,
        prng_key=None,
        plane: Optional[int] = None,
        shard: Optional[int] = None,
    ) -> torch.Tensor:
        """uint32 noise-stream seed for one GEMM call (0-dim int64 on the
        operands' device).  Reference: ``repro.photonic.engine:
        PhotonicEngine.stream_seed``: site hash, layer index, for one shard
        of a K-sharded GEMM ``(SHARD_STREAM_TAG, shard)`` and for a plane
        pass ``(PLANE_STREAM_TAG, plane)`` folded on the host into
        ``prng_key`` (which wins) or ``noise_seed``, then the operands'
        content words (``w_word`` is the prepacked weight's, if known;
        ``x_word`` the whole activation's, when ``xq`` is a block of its
        rows).  ``shard=None, plane=None`` is the unsharded, unsliced
        stream."""
        seed = self._site_seed(site, fold, prng_key, plane, shard)
        return fold_words(seed, tweak_word(xq) if x_word is None else x_word,
                          tweak_word(wq) if w_word is None else w_word)

    # -- integer datapath ----------------------------------------------------
    def int_gemm(
        self,
        xq: torch.Tensor,
        wq: torch.Tensor,
        *,
        site: Optional[str] = None,
        fold: Optional[int] = None,
        shard: Optional[int] = None,
        plane: Optional[int] = None,
        logical_kc: Optional[Tuple[int, int]] = None,
        tiling: Optional[Tuple[int, int, int]] = None,
        tile_r: int = 128,
        tile_c: int = 128,
        epilogue: Optional[EpilogueArgs] = None,
        slicing=None,
        pack=None,
        prng_key=None,
        columns: Optional[Tuple[int, int]] = None,
        w_word: Optional[torch.Tensor] = None,
        rows: Optional[Tuple[int, int]] = None,
        x_word: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Integer GEMM through the DPU datapath; int32 ``(R, C)``, or f32
        with ``epilogue`` (the fused hot path; ``xq`` may then be a float
        activation, quantized in the kernel prologue on the ``kernel``
        backend and digitally elsewhere).  ``shard`` is the index of one
        K-shard of a tensor-parallel GEMM and ``plane`` the plane-pair
        index of one pass of a sliced GEMM (both only perturb the noise
        stream); ``slicing`` overrides the engine's mode for this call
        (``"none"`` forces the unsliced datapath; the ``exact`` backend
        ignores slicing, the decomposition being exact); ``pack`` is the
        :class:`~repro_torch.photonic.packing.PackedDense` that ``wq``
        belongs to, whose precomputed content word (and, sliced, cached
        weight planes) the noise stream uses instead of hashing ``wq``.
        Reference: ``repro.photonic.engine:PhotonicEngine.int_gemm``.

        ``columns = (origin, total)`` makes ``wq`` the columns from
        ``origin`` of a ``total``-column weight (a rank's column block under
        a placement): every backend draws its columns' noise as the whole
        weight's GEMM draws those columns, and ``w_word`` is then the whole
        weight's content word (:func:`~repro_torch.noise.stages.
        tweak_word`, summed over the blocks), which the stream folds in
        place of ``wq``'s own.  ``rows = (origin, total)`` likewise makes
        ``xq`` the rows from ``origin`` of a ``total``-row activation (a
        rank's block of a placed cache's rows): its rows draw the whole
        activation's noise (the kernel's tile rows from ``total``), and
        ``x_word`` is then the whole activation's content word.  A
        bit-sliced call takes neither (its planes' content words would be
        the whole operands' planes')."""
        mode = self.slicing if slicing is None else resolve_slicing(slicing)
        if mode is not None and self.backend != "exact":
            if columns is not None or rows is not None:
                raise ValueError("a bit-sliced GEMM runs on whole columns and rows: columns= / rows= are not taken")
            return self._sliced_int_gemm(
                mode, xq, wq, site=site, fold=fold, shard=shard, logical_kc=logical_kc,
                tile_r=tile_r, tile_c=tile_c, epilogue=epilogue, pack=pack, prng_key=prng_key,
            )
        k, c = logical_kc if logical_kc is not None else tuple(wq.shape[-2:])
        cfg = self.dpu
        channel = cfg.effective_channel()
        adc_bits = channel.adc_bits if channel is not None else cfg.adc_bits
        noisy = self.noisy

        if xq.is_floating_point():
            if epilogue is None:
                raise TypeError(
                    "int_gemm got float activations without an EpilogueArgs; "
                    "quantize explicitly or pass epilogue= (fused hot path)"
                )
            if noisy or self.backend != "kernel":
                xq = quantize_with_scale(xq, epilogue.x_scale, cfg.operand_bits)

        if self.backend == "exact":
            acc = exact_int_gemm(xq, wq[:k, :c])
            return acc if epilogue is None else _finish(acc, epilogue)

        if pack is not None:
            w_word = pack.w_word
        seed = (
            self.stream_seed(site, fold, xq, wq, w_word=w_word, x_word=x_word, prng_key=prng_key, plane=plane,
                             shard=shard)
            if noisy
            else None
        )

        if self.backend == "ref":
            acc = photonic_gemm_ref(
                xq,
                wq[:k, :c],
                slice_bits=cfg.bits,
                num_slices=cfg.num_slices,
                n_chunk=cfg.n,
                adc_bits=adc_bits,
                channel=channel,
                seed=seed,
                columns=columns,
                rows=rows,
            )
            return acc if epilogue is None else _finish(acc, epilogue)

        r = xq.shape[0]
        c_origin = 0 if columns is None else int(columns[0])
        r_origin = 0 if rows is None else int(rows[0])
        # the logical row tile is the whole activation's
        stages, (_, kp, cp) = kernel_stages(
            cfg, r if rows is None else int(rows[1]), k, c, tiling, tile_r=tile_r, tile_c=tile_c
        )
        rp = _round_up(r, stages["tile_r"])
        xp = F.pad(xq, (0, kp - k, 0, rp - r)).contiguous()
        if tuple(wq.shape) != (kp, cp):
            wq = F.pad(wq[:k, :c], (0, cp - c, 0, kp - k)).contiguous()
        if epilogue is None:
            return photonic_gemm(xp, wq, seed, rows=r, c_origin=c_origin, r_origin=r_origin, **stages)[:r, :c]
        ws = F.pad(epilogue.w_scale.to(torch.float32).reshape(-1), (0, cp - c))
        bias = epilogue.bias
        if bias is not None:
            bias = F.pad(bias.to(torch.float32).reshape(-1), (0, cp - c))
        out = photonic_gemm_fused(
            xp,
            wq,
            epilogue.x_scale.to(torch.float32).reshape(1),
            ws,
            bias,
            seed,
            operand_bits=cfg.operand_bits,
            activation=epilogue.spec.activation,
            rows=r,
            c_origin=c_origin,
            r_origin=r_origin,
            **stages,
        )
        return out[:r, :c]

    def _sliced_int_gemm(
        self,
        mode: SlicingSpec,
        xq: torch.Tensor,
        wq: torch.Tensor,
        *,
        site,
        fold,
        shard=None,
        logical_kc,
        tile_r,
        tile_c,
        epilogue: Optional[EpilogueArgs],
        pack,
        prng_key,
    ) -> torch.Tensor:
        """Bit-sliced execution: both operands decomposed into
        ``mode.plane_bits``-wide signed-magnitude planes, every plane pair
        one unfused pass of the plane engine (:func:`_plane_engine`) with
        ``(PLANE_STREAM_TAG, si * P + ti)`` folded into its stream and the
        *plane* operands' content words hashed, the passes recombined with
        exact shifts, the epilogue applied digitally.  Reference:
        ``repro.photonic.engine:PhotonicEngine._sliced_int_gemm``.

        As there, a pack's tiling is dropped: the planes run at the plane
        engine's own tiling over the logical ``(K, C)``.  The activation is
        quantized and sliced once per call and each of its planes hashed
        once; the weight planes and words come from ``pack``'s cache when
        given.  Each pass is the plane engine's ``int_gemm`` on these
        operands, spelled out here so the stage arguments and padding are
        worked out once per call, not once per pass."""
        cfg = self.dpu
        k, c = logical_kc if logical_kc is not None else tuple(wq.shape[-2:])
        if xq.is_floating_point():
            if epilogue is None:
                raise TypeError(
                    "int_gemm got float activations without an EpilogueArgs; "
                    "quantize explicitly or pass epilogue= (fused hot path)"
                )
            xq = quantize_with_scale(xq, epilogue.x_scale, cfg.operand_bits)
        pe = _plane_engine(self, mode)
        pcfg = pe.dpu
        p = mode.plane_bits
        planes = mode.num_planes(cfg.operand_bits)
        r = xq.shape[0]
        if pe.backend == "kernel":
            stages, (rp, kp, cp) = kernel_stages(
                pcfg, r, k, c, None, tile_r=tile_r, tile_c=tile_c
            )
        else:
            rp, kp, cp = r, k, c
        noisy = pe.noisy
        x_pl, x_words = plane_operands(xq, p, planes, (rp, kp), noisy)
        if pack is not None:
            w_pl, w_words = pack.planes(p, planes, (kp, cp), noisy)
        else:
            w_pl, w_words = plane_operands(wq[:k, :c], p, planes, (kp, cp), noisy)
        seeds = None
        if noisy:
            base = pe._plane_seeds(site, fold, prng_key, planes * planes, xq.device, shard)
            seeds = fold_words(base.reshape(planes, planes), x_words[:, None], w_words[None, :])
            seeds = seed_words(seeds.reshape(-1))
        channel = pcfg.effective_channel()
        acc = None
        for si in range(planes):
            for ti in range(planes):
                i = si * planes + ti
                seed = None if seeds is None else seeds[i]
                if pe.backend == "kernel":
                    part = photonic_gemm(x_pl[si], w_pl[ti], seed, rows=r, **stages)[:r, :c]
                else:
                    part = photonic_gemm_ref(
                        x_pl[si], w_pl[ti], slice_bits=pcfg.bits, num_slices=pcfg.num_slices,
                        n_chunk=pcfg.n, adc_bits=channel.adc_bits if channel is not None else pcfg.adc_bits,
                        channel=channel, seed=seed,
                    )
                # Exact recombination: q = sum_s plane_s * 2^(p s) per operand.
                part = part << (p * (si + ti))
                acc = part if acc is None else acc + part
        return acc if epilogue is None else _finish(acc, epilogue)

    # -- float entry points --------------------------------------------------
    def matmul_float(
        self,
        x: torch.Tensor,
        w: torch.Tensor,
        *,
        site: Optional[str] = None,
        fold: Optional[int] = None,
        epilogue=None,
        slicing=None,
        bias: Optional[torch.Tensor] = None,
        activation: Optional[str] = None,
        prng_key=None,
    ) -> torch.Tensor:
        """Float GEMM quantizing both operands per call (the training
        path; differentiable by the straight-through estimator, whose
        backward does not depend on ``slicing``, this call's override of
        the engine's mode).  Reference:
        ``repro.photonic.engine:PhotonicEngine.matmul_float``."""
        spec, bias = as_epilogue(epilogue, bias=bias, activation=activation)
        eng = self if slicing is None else self.with_slicing(slicing)
        if not eng.routes(site):
            return _digital_reference(x, w.to(x.dtype), bias, spec)
        return _FloatMatmul.apply(eng, site, spec, fold, prng_key, x, w, bias)

    def matmul(
        self,
        x: torch.Tensor,
        packed,  # PackedDense
        *,
        site: Optional[str] = None,
        fold: Optional[int] = None,
        epilogue=None,
        slicing=None,
        bias: Optional[torch.Tensor] = None,
        activation: Optional[str] = None,
        prng_key=None,
    ) -> torch.Tensor:
        """Float GEMM against a prepacked weight — the weight-stationary hot
        path; differentiable in ``x`` and the bias (the int8 bank is frozen
        and its scale gets a zero gradient); ``slicing`` overrides the
        engine's mode for this call.  A K-sharded pack runs only under
        :func:`~repro_torch.photonic.sharded.tensor_parallel` at its degree
        and raises here.  Reference:
        ``repro.photonic.engine:PhotonicEngine.matmul``."""
        if packed.shards != 1:
            raise ValueError(
                f"{packed!r} is K-sharded: it runs under "
                "repro_torch.photonic.sharded.tensor_parallel with a mesh axis of its size"
            )
        spec, bias = as_epilogue(epilogue, bias=bias, activation=activation)
        eng = self if slicing is None else self.with_slicing(slicing)
        if not eng.routes(site):
            return _digital_reference(x, packed.dequant().to(x.dtype), bias, spec)
        return _PackedMatmul.apply(eng, site, spec, fold, prng_key, packed, x, packed.w_scale, bias)


@functools.lru_cache(maxsize=None)
def _plane_engine(engine: PhotonicEngine, mode: SlicingSpec) -> PhotonicEngine:
    """The single-plane-pass engine of a sliced ``engine``: analog precision
    = operand width = the plane width (one pass, no hardware re-slicing),
    the DPE size frozen at the parent's N, the channel re-referred to the
    plane full-scale (a legacy ``noise_sigma_lsb`` re-referred alike).
    Reference: ``repro.photonic.engine:_plane_engine``."""
    cfg = engine.dpu
    p = mode.plane_bits
    updates = dict(bits=p, operand_bits=p, dpe_size=cfg.n)
    if cfg.channel is not None:
        updates["channel"] = sliced_channel(cfg.channel, p)
    elif cfg.noise_sigma_lsb > 0.0:
        scale = float((2**p - 1) ** 2) / float((2**cfg.bits - 1) ** 2)
        updates["noise_sigma_lsb"] = cfg.noise_sigma_lsb * scale
    return dataclasses.replace(engine, dpu=dataclasses.replace(cfg, **updates), slicing=None)


@functools.lru_cache(maxsize=None)
def engine_for(
    dpu: DPUConfig,
    backend: str,
    include: Tuple[str, ...] = ("*",),
    exclude: Tuple[str, ...] = ("router",),
    slicing=None,
) -> PhotonicEngine:
    """Cached engine construction.  Reference:
    ``repro.photonic.engine:engine_for``."""
    return PhotonicEngine(
        dpu=dpu,
        backend=backend,
        policy=SitePolicy(include, exclude),
        slicing=resolve_slicing(slicing),
    )


def _finish(acc: torch.Tensor, e: EpilogueArgs) -> torch.Tensor:
    """The fused epilogue applied to a digital int32 accumulator."""
    return apply_epilogue(acc, e.x_scale, e.w_scale.to(torch.float32), e.bias, e.spec)


def _stream_gemm(
    eng: PhotonicEngine,
    site,
    spec: EpilogueSpec,
    x,
    wq,
    w_scale,
    bias,
    fold,
    prng_key=None,
    *,
    pack=None,
    columns=None,
    w_word=None,
    rows=None,
    x_word=None,
):
    """One forward through the fused hot path.  Reference:
    ``repro.photonic.engine:_stream_gemm``: f32 activations defer their
    rounding (scale computed here), other dtypes quantize up front.
    ``pack`` is the prepacked weight ``wq`` belongs to: its logical shape,
    tiling, content word and plane cache.  Under a placement of the rows
    (``repro_torch.runtime.sharding.placement``) ``x`` holds this rank's
    rows and the scale is the abs-max over every rank's
    (:func:`~repro_torch.runtime.sharding.activation_amax`); the noise
    tiles are then the local rows', as the tensor-parallel path draws
    them.  ``columns`` / ``w_word`` and ``rows`` / ``x_word`` go to
    :meth:`PhotonicEngine.int_gemm` (``wq`` a column block of a wider
    weight, ``x`` a block of a taller activation's rows).  Where ``x``
    ``(B, L, K)`` is this rank's block of a placed ``"kv_seq"``
    (:func:`~repro_torch.runtime.sharding.row_segments`) on a noisy
    channel, each of its ``B`` rows' ``L`` rows runs at its global row
    origin with the whole activation's content word
    (:func:`~repro_torch.runtime.sharding.rows_word`): the noise the
    single-device program draws on the whole rows."""
    from repro_torch.runtime.sharding import activation_amax, row_segments, rows_word

    lead = x.shape[:-1]
    xr = x.reshape(-1, x.shape[-1])
    amax = activation_amax(xr)
    if xr.dtype == torch.float32:
        xs, sx = xr, quant_scale(xr, eng.dpu.operand_bits, amax=amax)
    else:
        xs, sx = quantize_symmetric(xr, eng.dpu.operand_bits, amax=amax)
    cols = wq.shape[1] if pack is None else pack.c
    kw = dict(site=site, fold=fold, logical_kc=None if pack is None else (pack.k, pack.c),
              tiling=None if pack is None else pack.tiling, epilogue=EpilogueArgs(spec, sx, w_scale, bias), pack=pack,
              prng_key=prng_key, columns=columns, w_word=w_word)
    segments = row_segments(lead) if rows is None and eng.noisy and eng.backend != "exact" else None
    if segments is None:
        y = eng.int_gemm(xs, wq, rows=rows, x_word=x_word, **kw)
    else:
        origins, total = segments
        if x_word is None:
            xq = quantize_with_scale(xs, sx, eng.dpu.operand_bits) if xs.is_floating_point() else xs
            x_word = rows_word(tweak_word(xq))
        n = xs.shape[0] // len(origins)
        y = torch.cat([eng.int_gemm(xs[i * n : (i + 1) * n], wq, rows=(o, total), x_word=x_word, **kw)
                       for i, o in enumerate(origins)], dim=0)
    return y.reshape(*lead, cols).to(x.dtype)


def _epilogue_bwd(spec: EpilogueSpec, g2, x2, wf, bias):
    """Backward of the epilogue under the STE convention: straight through
    the quantized GEMM, exact through bias and activation, the activation's
    derivative taken at the dense f32 pre-activation ``x2 @ wf (+ bias)``.
    Returns the gradient at the GEMM output and the bias gradient (``None``
    without a bias).  Reference: ``repro.photonic.engine:_epilogue_bwd``."""
    if spec.activation is not None:
        pre = x2 @ wf
        if bias is not None:
            pre = pre + bias.to(torch.float32)
        with torch.enable_grad():
            pre = pre.detach().requires_grad_(True)
            (g2,) = torch.autograd.grad(ACTIVATIONS[spec.activation](pre), pre, g2)
    db = None if bias is None else g2.sum(dim=0).to(bias.dtype)
    return g2, db


def _ste_grads(spec, g, x, wf, bias):
    """``(dx, g2, x2, db)`` of one straight-through backward in f32."""
    g2 = g.reshape(-1, g.shape[-1]).to(torch.float32)
    x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
    g2, db = _epilogue_bwd(spec, g2, x2, wf, bias)
    dx = (g2 @ wf.T).reshape(x.shape).to(x.dtype)
    return dx, g2, x2, db


class _FloatMatmul(torch.autograd.Function):
    """Reference: ``repro.photonic.engine:_float_matmul`` (custom VJP): the
    weight is quantized per call inside the forward; ``dx``, ``dw`` and
    ``db`` are f32 products cast back to the operand dtypes."""

    @staticmethod
    def forward(ctx, eng, site, spec, fold, prng_key, x, w, bias):
        ctx.spec = spec
        ctx.save_for_backward(x, w, bias)
        wq, sw = quantize_symmetric(w, eng.dpu.operand_bits, axis=0)
        return _stream_gemm(eng, site, spec, x, wq, sw, bias, fold, prng_key)

    @staticmethod
    def backward(ctx, g):
        x, w, bias = ctx.saved_tensors
        wf = w.to(torch.float32)
        dx, g2, x2, db = _ste_grads(ctx.spec, g, x, wf, bias)
        dw = (x2.T @ g2).to(w.dtype)
        return None, None, None, None, None, dx, dw, db


class _PackedMatmul(torch.autograd.Function):
    """Reference: ``repro.photonic.engine:_packed_matmul`` (custom VJP):
    ``dx`` against the dequantized bank and ``db``; the int8 bank is
    frozen serving state and ``w_scale`` gets zeros."""

    @staticmethod
    def forward(ctx, eng, site, spec, fold, prng_key, packed, x, w_scale, bias):
        ctx.spec, ctx.packed = spec, packed
        ctx.save_for_backward(x, w_scale, bias)
        return _stream_gemm(eng, site, spec, x, packed.wq, w_scale, bias, fold, prng_key, pack=packed)

    @staticmethod
    def backward(ctx, g):
        x, w_scale, bias = ctx.saved_tensors
        p = ctx.packed
        wf = p.wq[: p.k, : p.c].to(torch.float32) * w_scale.to(torch.float32)[None, :]
        dx, _, _, db = _ste_grads(ctx.spec, g, x, wf, bias)
        return None, None, None, None, None, None, dx, torch.zeros_like(w_scale), db
