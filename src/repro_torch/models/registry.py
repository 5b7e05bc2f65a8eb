"""Architecture registry (the dense, moe, vlm, ssm, hybrid and audio
families: all of the reference's).

Port of ``repro.models.registry``: each arch exposes its config, a smoke
config, ``param_defs(cfg)``, ``loss(params, batch, cfg)``,
``prefill(params, batch, cfg, max_seq)``, ``decode(params, token, cache,
cfg)`` and ``cache_def(cfg, batch, max_seq, meta, dtype)``.  The vlm
family's batches carry ``vision`` ``(B, vision_seq, D)`` beside
``tokens``; the audio family's carry ``audio_embed`` ``(B, T_enc, D)``,
and its ``cache_def`` reads the encoder length from ``meta["enc_seq"]``.
The ssm (xLSTM) and hybrid (Zamba2) families take ``tokens`` only.

The shape surface is the reference's too: :data:`SHAPES` (the LM-family
input shapes the dry run sweeps), ``Arch.ladder`` (the layer ladder whose
rungs sum to the whole model's cost) and ``train_batch_spec`` /
``prefill_batch_spec`` / ``decode_specs``, which return
:class:`TensorSpec` leaves (the port's ``jax.ShapeDtypeStruct``) with
the same logical-axes trees.  Given a ``mesh``, the three spec methods
return this rank's blocks along the logical names the port places
(:meth:`Arch.placement_sizes`): local shapes from the same axes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.models import lm, whisper, xlstm, zamba2
from repro_torch.models.common import ModelConfig


# ---------------------------------------------------------------------------
# Input-shape table (the LM-family shapes)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """Reference: ``repro.models.registry:ShapeSpec``."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A tensor's shape and dtype, nothing allocated: the port's
    ``jax.ShapeDtypeStruct``."""

    shape: Tuple[int, ...]
    dtype: torch.dtype

    @property
    def nbytes(self) -> int:
        n = self.dtype.itemsize
        for d in self.shape:
            n *= d
        return n


@dataclasses.dataclass(frozen=True)
class Arch:
    name: str
    family: str
    config: ModelConfig
    smoke_config: ModelConfig
    param_defs: Callable[[ModelConfig], Any]
    loss: Callable[..., Any]
    prefill: Callable[..., Any]
    decode: Callable[..., Any]
    cache_def: Callable[..., Any]
    skip_shapes: Tuple[str, ...] = ()
    notes: str = ""

    # ---- cost ladder --------------------------------------------------------
    def ladder(self, cfg: ModelConfig):
        """``[(step_name, cfg_overrides, coeff)]`` such that an additive
        cost (FLOPs, bytes) of the whole model is ``sum_i coeff_i *
        cost_i`` over the rungs.  The reference needs it because XLA counts
        a scan body once; the port runs every layer eagerly, so the
        identity checks that the per-layer work does not depend on the
        layer's index.  Reference: ``repro.models.registry:Arch.ladder``."""
        u = {"unroll_scans": True}
        L = cfg.num_layers
        if self.family == "audio":
            le, ld = cfg.encoder_layers, cfg.num_layers
            return [
                ("zero", {**u, "encoder_layers": 0, "num_layers": 0}, 1.0 - le - ld),
                ("enc1", {**u, "encoder_layers": 1, "num_layers": 0}, float(le)),
                ("dec1", {**u, "encoder_layers": 0, "num_layers": 1}, float(ld)),
            ]
        if self.family == "vlm":
            g = L // cfg.cross_attn_every
            return [
                ("zero", {**u, "num_layers": 0}, 1.0 - g),
                ("grp1", {**u, "num_layers": cfg.cross_attn_every}, float(g)),
            ]
        if self.family == "ssm":
            g = L // cfg.slstm_every
            return [
                ("zero", {**u, "num_layers": 0}, 1.0 - g),
                ("grp1", {**u, "num_layers": cfg.slstm_every}, float(g)),
            ]
        if self.family == "hybrid":
            g = L // cfg.attn_every
            return [
                ("zero", {**u, "num_layers": 0}, 1.0 - g),
                ("grp1", {**u, "num_layers": cfg.attn_every}, float(g)),
            ]
        if cfg.mla and cfg.num_experts:  # deepseek-v2: a dense first block
            return [
                ("l1", {**u, "num_layers": 1}, 2.0 - L),
                ("l2", {**u, "num_layers": 2}, L - 1.0),
            ]
        return [
            ("zero", {**u, "num_layers": 0}, 1.0 - L),
            ("l1", {**u, "num_layers": 1}, float(L)),
        ]

    # ---- placement -------------------------------------------------------------
    def placement_sizes(self, cfg: ModelConfig, shape: ShapeSpec, *, params: bool = True) -> Dict[str, int]:
        """The global sizes of the logical names the port places for one
        step of ``shape`` (``repro_torch.runtime.sharding.placement``): the
        batch rows always; the q and KV heads of GQA attention in prefill
        and decode (the xLSTM stack keeps its heads whole), and in training
        for the dense GQA decoders.  With ``params`` the step takes the
        parameters placed (``sharding.place_params``), in training too:
        by ``heads`` (MLA's alone: its latent cache has no head axis),
        ``kv_heads``, ``d_ff``, ``vocab`` and ``experts``, and for the
        recurrent families by ``inner`` (the xLSTM and Mamba2 projections,
        the mLSTM state's key dimension, the Mamba2 conv state) and
        ``mamba_heads`` (Mamba2's heads and SSM state), Zamba2's shared
        block by its heads and ``d_ff``.  ``train(mesh=)`` asks for rows
        and heads only (``params=False``; the MoE and recurrent families'
        rows alone): its parameters stay whole, as the reference's
        ``train()`` keeps them.  The sequence axes: ``seq_sp``, the residual
        stream's positions (the encoder's frames for whisper), in prefill
        and training whatever ``params`` says (the reference's ``train()``
        constrains the residual under its mesh too; xLSTM constrains no
        sequence); ``kv_seq``, the decode cache's ``max_seq`` positions, in
        decode (``placed_parts`` gives them "data" only where the rows do
        not take it)."""
        sizes = {"batch": shape.global_batch}
        dense = self.family == "dense" and not cfg.mla
        if (shape.kind != "train" or dense or params) and self.family != "ssm" and not cfg.mla:
            sizes.update(heads=cfg.n_q_heads, kv_heads=cfg.num_kv_heads)
        if shape.kind != "decode" and self.family != "ssm":
            sizes.update(seq_sp=shape.seq_len)
        if shape.kind == "decode" and self.family != "ssm":
            sizes.update(kv_seq=shape.seq_len // cfg.decoder_ratio if self.family == "audio" else shape.seq_len)
        if not params:
            return sizes
        if cfg.mla:
            sizes.update(heads=cfg.n_q_heads)
        sizes.update(vocab=cfg.n_vocab)
        if cfg.d_ff:  # xLSTM has no MLP (d_ff 0)
            sizes.update(d_ff=cfg.d_ff)
        if cfg.num_experts:
            sizes.update(experts=cfg.num_experts)
        if self.family in ("ssm", "hybrid"):
            sizes.update(inner=cfg.ssm_expand * cfg.d_model)
        if self.family == "hybrid":
            sizes.update(mamba_heads=cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim)
        return sizes

    def param_specs(self, cfg: ModelConfig, shape: ShapeSpec, mesh=None):
        """``(spec, axes)`` of the parameters; with ``mesh``, this rank's
        blocks in a step of ``shape`` (the whole tree where the arch holds
        its parameters whole).  Reference: the ``param_axes`` shardings of
        ``repro.launch.dryrun``."""
        from repro_torch._tree import tree_map
        from repro_torch.models.common import _DTYPES, axes_tree

        defs = self.param_defs(cfg)
        spec = tree_map(lambda p: TensorSpec(p.shape, _DTYPES[p.dtype] if p.dtype else cfg.param_dtype), defs)
        axes = axes_tree(defs)
        return self._placed(cfg, shape, mesh, spec, axes), axes

    def _placed(self, cfg, shape, mesh, specs, axes):
        """``specs`` as this rank's blocks on ``mesh`` (unchanged without
        one)."""
        if mesh is None:
            return specs
        from repro_torch.runtime import sharding as shd

        names = tuple(shd.placed_parts(self.placement_sizes(cfg, shape), mesh, cfg.logical_rules))

        def local(spec, ax):
            ours, _ = shd.port_spec(spec.shape, ax, mesh, names, cfg.logical_rules)
            return TensorSpec(shd.local_shape(spec.shape, ours, mesh), spec.dtype)

        return _zip_specs(specs, axes, local)

    # ---- input specs ----------------------------------------------------------
    def train_batch_spec(self, cfg: ModelConfig, shape: ShapeSpec, mesh=None):
        """``(spec, axes)`` of a training batch; with ``mesh``, this rank's
        rows.  Reference: ``repro.models.registry:Arch.train_batch_spec``."""
        spec, axes = self._global_batch_spec(cfg, shape)
        return self._placed(cfg, shape, mesh, spec, axes), axes

    def _global_batch_spec(self, cfg: ModelConfig, shape: ShapeSpec):
        b, t = shape.global_batch, shape.seq_len
        tok = TensorSpec((b, t), torch.int32)
        spec = {"tokens": tok, "labels": tok}
        axes = {"tokens": ("batch", None), "labels": ("batch", None)}
        if self.family == "vlm":
            spec["vision"] = TensorSpec((b, cfg.vision_seq, cfg.d_model), cfg.compute_dtype)
            axes["vision"] = ("batch", None, None)
        if self.family == "audio":
            dec = t // cfg.decoder_ratio
            spec = {
                "audio_embed": TensorSpec((b, t, cfg.d_model), cfg.compute_dtype),
                "tokens": TensorSpec((b, dec), torch.int32),
                "labels": TensorSpec((b, dec), torch.int32),
            }
            axes = {
                "audio_embed": ("batch", "seq_sp", None),
                "tokens": ("batch", None),
                "labels": ("batch", None),
            }
        return spec, axes

    def prefill_batch_spec(self, cfg: ModelConfig, shape: ShapeSpec, mesh=None):
        """With ``mesh``, this rank's rows.  Reference:
        ``repro.models.registry:Arch.prefill_batch_spec``."""
        spec, axes = self._global_batch_spec(cfg, shape)
        spec.pop("labels", None)
        axes.pop("labels", None)
        return self._placed(cfg, shape, mesh, spec, axes), axes

    def decode_specs(self, cfg: ModelConfig, shape: ShapeSpec, mesh=None):
        """``((token spec, axes), (cache spec, cache axes))`` for one decode
        step; with ``mesh``, this rank's rows and KV heads.  Reference:
        ``repro.models.registry:Arch.decode_specs``."""
        b = shape.global_batch
        max_seq = shape.seq_len if self.family != "audio" else shape.seq_len // cfg.decoder_ratio
        cache = self.cache_def(cfg, b, max_seq, {"enc_seq": shape.seq_len}, cfg.compute_dtype)
        tok, tok_axes = TensorSpec((b, 1), torch.int32), ("batch", None)
        cache_spec = _map_cache(cache, lambda leaf: TensorSpec(leaf[0], leaf[2]))
        cache_axes = _map_cache(cache, lambda leaf: leaf[1])
        return ((self._placed(cfg, shape, mesh, tok, tok_axes), tok_axes),
                (self._placed(cfg, shape, mesh, cache_spec, cache_axes), cache_axes))


def _is_cache_leaf(x) -> bool:
    return isinstance(x, tuple) and len(x) == 3 and isinstance(x[0], tuple) and isinstance(x[1], tuple)


def _map_cache(node, fn):
    """``fn`` over the ``(shape, axes, dtype)`` leaves of a cache def,
    dicts and tuples kept."""
    if _is_cache_leaf(node):
        return fn(node)
    if isinstance(node, dict):
        return {k: _map_cache(v, fn) for k, v in node.items()}
    return tuple(_map_cache(v, fn) for v in node)


def _zip_specs(specs, axes, fn):
    """``fn(spec, axes)`` over a tree of :class:`TensorSpec` leaves and its
    axes tree (dicts and tuples kept)."""
    if isinstance(specs, TensorSpec):
        return fn(specs, axes)
    if isinstance(specs, dict):
        return {k: _zip_specs(v, axes[k], fn) for k, v in specs.items()}
    out = [_zip_specs(v, a, fn) for v, a in zip(specs, axes)]
    return out if isinstance(specs, list) else tuple(out)


def _lm_loss(params, batch, cfg):
    return lm.lm_loss(params, batch, cfg)


def _lm_prefill(params, batch, cfg, max_seq):
    return lm.lm_prefill(params, batch["tokens"], cfg, max_seq, vision=batch.get("vision"))


def _lm_decode(params, token, cache, cfg):
    return lm.lm_decode(params, token, cache, cfg)


def _lm_cache_def(cfg, batch, max_seq, meta, dtype):
    return lm.lm_cache_def(cfg, batch, max_seq, dtype)


def _xlstm_prefill(params, batch, cfg, max_seq):
    return xlstm.xlstm_prefill(params, batch["tokens"], cfg)


def _xlstm_cache_def(cfg, batch, max_seq, meta, dtype):
    return xlstm.xlstm_cache_def(cfg, batch, max_seq, dtype)


def _zamba_prefill(params, batch, cfg, max_seq):
    return zamba2.zamba2_prefill(params, batch["tokens"], cfg, max_seq)


def _zamba_cache_def(cfg, batch, max_seq, meta, dtype):
    return zamba2.zamba2_cache_def(cfg, batch, max_seq, dtype)


def _whisper_prefill(params, batch, cfg, max_seq):
    return whisper.whisper_prefill(params, batch, cfg, max_seq)


def _whisper_cache_def(cfg, batch, max_seq, meta, dtype):
    return whisper.whisper_cache_def(cfg, batch, max_seq, meta["enc_seq"], dtype)


FAMILY_FNS = {
    "dense": (lm.lm_def, _lm_loss, _lm_prefill, _lm_decode, _lm_cache_def),
    "vlm": (lm.lm_def, _lm_loss, _lm_prefill, _lm_decode, _lm_cache_def),
    "moe": (lm.lm_def, _lm_loss, _lm_prefill, _lm_decode, _lm_cache_def),
    "ssm": (
        xlstm.xlstm_def,
        xlstm.xlstm_loss,
        _xlstm_prefill,
        xlstm.xlstm_decode,
        _xlstm_cache_def,
    ),
    "hybrid": (
        zamba2.zamba2_def,
        zamba2.zamba2_loss,
        _zamba_prefill,
        zamba2.zamba2_decode,
        _zamba_cache_def,
    ),
    "audio": (
        whisper.whisper_def,
        whisper.whisper_loss,
        _whisper_prefill,
        whisper.whisper_decode,
        _whisper_cache_def,
    ),
}
_REGISTRY: Dict[str, Arch] = {}


def register(arch: Arch) -> Arch:
    """Reference: ``repro.models.registry:register``."""
    _REGISTRY[arch.name] = arch
    return arch


def get(name: str) -> Arch:
    """Reference: ``repro.models.registry:get``."""
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def names() -> list:
    """Reference: ``repro.models.registry:names``."""
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded() -> None:
    if not _REGISTRY:
        import repro_torch.configs  # noqa: F401  (registers the ported archs)


def make_arch(name: str, family: str, config: ModelConfig, smoke_config: ModelConfig,
              skip_shapes: Tuple[str, ...] = (), notes: str = "") -> Arch:
    """Reference: ``repro.models.registry:make_arch``."""
    defs, loss, prefill, decode, cache_def = FAMILY_FNS[family]
    return register(Arch(name, family, config, smoke_config, defs, loss, prefill, decode, cache_def,
                         skip_shapes, notes))
