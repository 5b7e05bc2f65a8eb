"""Shared model substrate: config, parameter definitions, core layers.

Port of ``repro.models.common``.  Models are plain functions over nested
dicts of tensors; a *definition tree* (nested dicts / per-layer lists of
:class:`P`) carries each parameter's shape and init rule, and
:func:`init_tree` materializes it from a threefry key, bit for bit the
reference's ``init_tree`` (``repro_torch.prng`` draws what ``jax.random``
draws, on the CPU and on the card); :func:`init_params` also takes a seed
or a ``torch.Generator`` for a torch stream of the same shapes and rules.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import torch
import torch.utils.checkpoint

from repro_torch._device import resolve_device
from repro_torch.core.dpu import DPUConfig, quantize_symmetric
from repro_torch.runtime.sharding import logical_constraint, parted


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Reference: ``repro.models.common:ModelConfig`` (same fields and
    validation; dtypes are torch dtypes, and the photonic backends are the
    port's ``ref | kernel | exact``, defaulting to ``kernel`` so a photonic
    config runs its GEMMs on the CUDA kernels; ``ref`` and ``exact`` are
    asked for by name)."""

    arch_id: str = "custom"
    family: str = "dense"

    num_layers: int = 2
    d_model: int = 128
    num_heads: int = 2
    num_kv_heads: int = 2
    d_ff: int = 256
    vocab_size: int = 256
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    ffn_act: str = "swiglu"

    num_experts: int = 0
    num_experts_per_tok: int = 2
    num_shared_experts: int = 0
    moe_d_ff: Optional[int] = None
    capacity_factor: float = 1.25

    mla: bool = False
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    cross_attn_every: int = 0
    vision_seq: int = 1024

    ssm_state_size: int = 64
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    attn_every: int = 0
    slstm_every: int = 0

    encoder_decoder: bool = False
    encoder_layers: int = 0
    decoder_ratio: int = 4

    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32
    remat: bool = True
    remat_policy: str = "full"
    attn_f32: bool = True
    attn_chunk: int = 512
    attn_impl: str = "chunked"
    unroll_scans: bool = False
    logical_rules: Any = None
    kv_cache_int8: bool = False
    mla_absorb: bool = False
    seq_shard_residual: bool = True
    photonic: Optional[DPUConfig] = None
    photonic_backend: str = "kernel"
    photonic_scope: str = "weights"
    photonic_include: Tuple[str, ...] = ("*",)
    photonic_exclude: Tuple[str, ...] = ("router",)
    photonic_slicing: Any = None

    padded_heads: Optional[int] = None
    padded_vocab: Optional[int] = None

    def __post_init__(self):
        from repro_torch.photonic.engine import BACKENDS
        from repro_torch.photonic.slicing import resolve_slicing

        scopes = ("none", "weights", "weights_int8")
        if self.photonic_scope not in scopes:
            raise ValueError(
                f"photonic_scope={self.photonic_scope!r} is not one of {scopes}"
            )
        if self.photonic_backend not in BACKENDS:
            raise ValueError(
                f"photonic_backend={self.photonic_backend!r} is not one of "
                f"{BACKENDS}"
            )
        impls = ("chunked", "flash")
        if self.attn_impl not in impls:
            raise ValueError(f"attn_impl={self.attn_impl!r} is not one of {impls}")
        # Eager normalization through the slicing resolution point (an
        # unknown plane width raises here, not at the first GEMM).
        object.__setattr__(self, "photonic_slicing", resolve_slicing(self.photonic_slicing))

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def n_q_heads(self) -> int:
        return self.padded_heads if self.padded_heads is not None else self.num_heads

    @property
    def n_vocab(self) -> int:
        return self.padded_vocab if self.padded_vocab is not None else self.vocab_size

    @property
    def moe_hidden(self) -> int:
        return self.moe_d_ff if self.moe_d_ff is not None else self.d_ff

    def pad_for_mesh(self, model_axis: int) -> "ModelConfig":
        """A config whose head, kv-head and vocab counts the TP degree
        divides: q-heads padded up (``padded_heads``; the extras are
        structural), kv-heads replicated up to the degree when fewer (raises
        when the degree is not a multiple of them) or padded up, the vocab
        padded up (``padded_vocab``, masked out of the loss).  Reference:
        ``repro.models.common:ModelConfig.pad_for_mesh``."""
        changes: Dict[str, Any] = {}
        if self.num_heads % model_axis:
            changes["padded_heads"] = _round_up(self.num_heads, model_axis)
        kv = self.num_kv_heads
        if kv and kv < model_axis:
            if model_axis % kv:
                raise ValueError(f"cannot replicate kv={kv} onto tp={model_axis}")
            changes["num_kv_heads"] = model_axis
        elif kv % model_axis:
            changes["num_kv_heads"] = _round_up(kv, model_axis)
        if self.vocab_size % model_axis:
            changes["padded_vocab"] = _round_up(self.vocab_size, model_axis)
        return dataclasses.replace(self, **changes) if changes else self


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class P:
    """A parameter definition.  Reference: ``repro.models.common:P``.
    ``parts`` (the port's) declares the last dimension's layout: the
    global widths of the column parts laid side by side in it, of which a
    rank holds a block each where the dimension is placed
    (``runtime.sharding.parted``); empty for one part."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "fan_in"  # fan_in | zeros | ones | embed | normal
    fan_axis: int = 0
    dtype: Optional[str] = None  # override param_dtype ("int8", "float32")
    parts: Tuple[int, ...] = ()

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} disagree")
        if self.parts and sum(self.parts) != self.shape[-1]:
            raise ValueError(f"parts {self.parts} do not lay out the last dimension of {self.shape}")


_DTYPES = {"int8": torch.int8, "float32": torch.float32}


def init_params(
    cfg: ModelConfig,
    key: Union[int, torch.Generator, "np.ndarray", torch.Tensor],
    device=None,
    defs: Any = None,
) -> Any:
    """Materialize ``defs`` (default: the defs of ``cfg.family``) on
    ``device`` (``cuda`` unless asked otherwise) in ``cfg.param_dtype``.

    A threefry key (a uint32 pair, as ``prng.PRNGKey`` / ``prng.fold_in``
    make) draws with :func:`init_tree`: the reference's own weights, bit
    for bit.  An int seed or a ``torch.Generator`` draws the same init
    rules (fan-in-scaled normals, 0.02 normals for embeddings, zeros,
    ones, uniform int8) from a torch stream instead: a different draw,
    for code that needs some weights and no reference to match."""
    dev = resolve_device(device)
    if defs is None:
        from repro_torch.models import registry

        defs = registry.FAMILY_FNS[cfg.family][0](cfg)
    if not isinstance(key, (int, torch.Generator)):
        return init_tree(defs, key, cfg.param_dtype, dev)
    generator = key
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator(device=dev)
        generator.manual_seed(int(key))

    def make(p: P) -> torch.Tensor:
        dt = _DTYPES[p.dtype] if p.dtype is not None else cfg.param_dtype
        if dt == torch.int8:
            return torch.randint(-127, 128, p.shape, generator=generator, device=dev).to(dt)
        if p.init == "zeros":
            return torch.zeros(p.shape, dtype=dt, device=dev)
        if p.init == "ones":
            return torch.ones(p.shape, dtype=dt, device=dev)
        z = torch.randn(p.shape, generator=generator, device=dev, dtype=torch.float32)
        if p.init in ("embed", "normal"):
            return (z * 0.02).to(dt)
        fan = max(p.shape[p.fan_axis], 1)
        return (z * (1.0 / math.sqrt(fan))).to(dt)

    def walk(node):
        if isinstance(node, P):
            return make(node)
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [walk(n) for n in node]
        raise TypeError(f"bad param def: {type(node)}")

    return walk(defs)


def _stable_hash(s: str) -> int:
    """FNV-1a of the UTF-8 bytes, 32-bit.  Reference:
    ``repro.models.common:_stable_hash``."""
    h = 2166136261
    for ch in s.encode():
        h = (h ^ ch) * 16777619 & 0xFFFFFFFF
    return h


def _draw(p: P, key, dtype, device) -> torch.Tensor:
    """One leaf as the reference's ``init_tree`` draws it under ``key``."""
    from repro_torch import prng

    dt = _DTYPES[p.dtype] if p.dtype is not None else dtype
    if dt == torch.int8:
        return prng.randint(key, p.shape, -127, 128, torch.int32, device=device).to(dt)
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dt, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=dt, device=device)
    z = prng.normal(key, p.shape, device=device)
    if p.init in ("embed", "normal"):
        return (z * torch.tensor(0.02, dtype=torch.float32, device=device)).to(dt)
    fan = max(p.shape[p.fan_axis], 1)
    return prng._div(z, torch.tensor(math.sqrt(fan), dtype=torch.float32, device=device)).to(dt)


def init_tree(defs: Any, key, dtype: torch.dtype, device=None) -> Any:
    """Materialize ``defs`` from the threefry ``key`` as the reference
    does: a leaf's key folds the FNV-1a hash of each name on its path into
    ``key``; int8 leaves draw ``randint(-127, 128)``, ``embed`` /
    ``normal`` leaves ``0.02 * normal``, fan-in leaves ``normal /
    sqrt(fan)``, each cast to its dtype.  A per-layer list is drawn as the
    reference's stacked leaf (:func:`reference_defs`) and handed out a
    layer at a time, one stacked leaf alive at once.  Reference:
    ``repro.models.common:init_tree``."""
    from repro_torch import prng

    dev = resolve_device(device)
    out = _skeleton(defs)
    leaves = []

    def walk(node, path):
        if isinstance(node, P):
            leaves.append((path, node))
        else:
            for name in sorted(node):
                walk(node[name], path + (name,))

    walk(reference_defs(defs), ())
    for path, p in leaves:
        sub = key
        for name in path:
            sub = prng.fold_in(sub, _stable_hash(name))
        _place(out, defs, path, _draw(p, sub, dtype, dev))
    return out


def reference_defs(defs: Any) -> Any:
    """``defs`` in the reference's layout: each per-layer list (or list of
    lists) one stacked :class:`P` a leaf, as ``repro.models.lm:stack_defs``
    builds it: a leading axis a list level, the fan axis shifted by as
    many, the dtype override dropped."""
    if isinstance(defs, P):
        return defs
    if isinstance(defs, dict):
        return {k: reference_defs(v) for k, v in defs.items()}
    if isinstance(defs, list):
        return _stack_list([reference_defs(v) for v in defs])
    raise TypeError(f"bad param def: {type(defs)}")


def _stack_list(parts: list) -> Any:
    first = parts[0]
    if isinstance(first, dict):
        return {k: _stack_list([q[k] for q in parts]) for k in first}
    return P((len(parts),) + first.shape, (None,) + first.axes, first.init, first.fan_axis + 1)


def _skeleton(defs: Any) -> Any:
    if isinstance(defs, P):
        return None
    if isinstance(defs, list):
        return [_skeleton(v) for v in defs]
    return {k: _skeleton(defs[k]) for k in sorted(defs)}


def _place(out: Any, node: Any, path: Tuple[str, ...], arr: torch.Tensor) -> None:
    """Put the stacked leaf ``arr`` at ``path`` of ``out``, one copy a
    layer along each list level of ``node`` (no layer holds the stacked
    storage)."""
    if isinstance(node, list):
        for i, sub in enumerate(node):
            if isinstance(sub, P):
                out[i] = arr[i].clone()
            else:
                _place(out[i], sub, path, arr[i])
        return
    name, sub = path[0], node[path[0]]
    if isinstance(sub, P):
        out[name] = arr
    else:
        _place(out[name], sub, path[1:], arr)


def axes_tree(defs: Any) -> Any:
    """The logical-axis tree matching :func:`init_params`' output: each
    :class:`P` as its ``axes`` tuple, dicts and per-layer lists kept.
    Reference: ``repro.models.common:axes_tree`` (whose stacked layer
    leaves carry one more leading ``None`` per stacking); a leaf with
    ``parts`` as :class:`~repro_torch.runtime.sharding.Axes`."""
    if isinstance(defs, P):
        return parted(defs.axes, defs.parts) if defs.parts else defs.axes
    if isinstance(defs, list):
        return [axes_tree(v) for v in defs]
    return {k: axes_tree(v) for k, v in defs.items()}


def dense_def(
    d_in: int,
    d_out: int,
    axes: Tuple[Optional[str], Optional[str]],
    bias: bool = False,
    init: str = "fan_in",
    quantized: bool = False,
    parts: Tuple[int, ...] = (),
) -> Dict[str, P]:
    """Reference: ``repro.models.common:dense_def``.  ``parts``: the
    output columns' parts (:class:`P`), declared on every leaf with a
    column axis."""
    if quantized:
        d: Dict[str, P] = {
            "w": P((d_in, d_out), axes, init=init, dtype="int8", parts=parts),
            "w_scale": P((d_out,), (axes[1],), init="ones", dtype="float32", parts=parts),
        }
    else:
        d = {"w": P((d_in, d_out), axes, init=init, parts=parts)}
    if bias:
        d["b"] = P((d_out,), (axes[1],), init="zeros", parts=parts)
    return d


def qdense_def(cfg: ModelConfig, d_in, d_out, axes, bias=False, init="fan_in", parts=()):
    """Reference: ``repro.models.common:qdense_def``."""
    quantized = cfg.photonic is not None and cfg.photonic_scope == "weights_int8"
    return dense_def(d_in, d_out, axes, bias=bias, init=init, quantized=quantized, parts=parts)


def engine_from_model_config(cfg: ModelConfig):
    """The engine a model config implies, or None.  Reference:
    ``repro.models.common:engine_from_model_config``."""
    from repro_torch.photonic.engine import engine_for

    if cfg.photonic is None or cfg.photonic_scope == "none":
        return None
    return engine_for(
        cfg.photonic,
        cfg.photonic_backend,
        tuple(cfg.photonic_include),
        tuple(cfg.photonic_exclude),
        slicing=cfg.photonic_slicing,
    )


class GemmRecord(NamedTuple):
    """One ``dense`` call under :func:`recording`: its site and layer, copies
    of its input and output, its ``params`` and keywords (to call it again),
    and where the placement put it: the global ``(origin, width)`` column
    segments of a column-parallel GEMM, ``(index, local)`` of the placed
    rows, ``(index, count)`` of the placed K (``k_local``), each or None;
    ``reduces``, ``contracts.PARAM_REDUCES`` as it stood; ``seq``, ``(index,
    local)`` of the operand's second dimension where it is this rank's
    block of the placed ``kv_seq`` (``sharding.rows_over``), else None."""

    site: Optional[str]
    layer: Any
    x: torch.Tensor
    y: torch.Tensor
    params: Dict[str, Any]
    kwargs: Dict[str, Any]
    segments: Optional[Tuple[Tuple[int, int], ...]]
    rows: Optional[Tuple[int, int]]
    k_block: Optional[Tuple[int, int]]
    reduces: Dict[str, int]
    seq: Optional[Tuple[int, int]] = None


_RECORDING: list = []  # the logs of the open recording() scopes
_DEPTH = [0]


@contextlib.contextmanager
def recording(log: list):
    """Every ``dense`` call the model makes in this scope appends a
    :class:`GemmRecord` to ``log``; a call ``dense`` makes of itself is not
    recorded."""
    _RECORDING.append(log)
    try:
        yield log
    finally:
        _RECORDING.remove(log)


def _recorded(fn):
    @functools.wraps(fn)
    def call(params, x, cfg, **kw):
        if not _RECORDING:
            return fn(params, x, cfg, **kw)
        _DEPTH[0] += 1
        try:
            y = fn(params, x, cfg, **kw)
        finally:
            _DEPTH[0] -= 1
        if _DEPTH[0] == 0:
            from repro_torch.analysis import contracts
            from repro_torch.runtime.sharding import block, column_layout, row_blocks

            cols, k_local = kw.get("columns"), kw.get("k_local")
            layout = None if cols is None else column_layout(cols)
            rows, kb = block("batch"), None if k_local is None else block(k_local)
            seq = block("kv_seq")
            seq = seq if seq is not None and seq in row_blocks() else None
            rec = GemmRecord(kw.get("site"), kw.get("layer"), x.detach().clone(), y.detach().clone(), params, kw,
                             None if layout is None else layout.segments,
                             None if rows is None else (rows.index, rows.local),
                             None if kb is None else (kb.index, kb.count), dict(contracts.PARAM_REDUCES),
                             None if seq is None else (seq.index, x.shape[1]))
            for log in _RECORDING:
                log.append(rec)
        return y

    return call


@_recorded
def dense(
    params: Dict[str, Any],
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    site: Optional[str] = None,
    layer: Optional[int] = None,
    epilogue: Any = None,
    slicing: Any = None,
    activation: Optional[str] = None,
    prng_key: Any = None,
    k_local: Optional[str] = None,
    columns: Optional[Tuple[Tuple[str, int], ...]] = None,
) -> torch.Tensor:
    """Linear layer; routes through the photonic engine when enabled.
    Reference: ``repro.models.common:dense``.  Bias and activation ride
    the engine's fused epilogue; ``slicing`` overrides
    ``cfg.photonic_slicing`` for this GEMM; ``prng_key`` (a
    :mod:`repro_torch.prng` key) is the noise source, winning over
    ``DPUConfig.noise_seed``.

    Under an active tensor-parallel scope
    (:func:`repro_torch.photonic.sharded.tensor_parallel` / ``manual_tp``)
    routed GEMMs K-shard over the mesh axis: shard-local channel at
    ``N_local``, (site, layer, shard)-folded noise, an int32 all-reduce —
    bitwise the single-device path under an ideal channel.

    ``k_local`` names the logical dimension (``"heads"``, ``"d_ff"``) whose
    placement (:func:`repro_torch.runtime.sharding.placement`) cuts ``x``'s
    last dimension: a tensor-parallel GEMM whose K shard is that block
    takes it as it is (against the weight's K rows, or the rank's K rows
    of a whole weight: row-parallel); the digital path on a placed weight
    sums its partial products over the mesh axes
    (:func:`~repro_torch.runtime.sharding.reduce_from_model`, then the
    epilogue); any other path gathers ``x`` first (counted in
    ``contracts.HEAD_GATHERS``), so the values are the replicated
    program's.

    ``columns`` lays out the weight's output columns as parts ``(logical
    name, global width)`` (``(("heads", h * hd),)``; SwiGLU's ``wi``
    ``(("d_ff", f), ("d_ff", f))``): where the placement cuts them
    (:func:`~repro_torch.runtime.sharding.column_layout`) the GEMM is
    column-parallel (:func:`repro_torch.photonic.sharded.column_matmul`)
    and returns this rank's columns; ``params`` may hold them (a placed
    weight) or the whole weight (``train(mesh=)``, whose parameters stay
    whole).  A form that does not apply runs on whole columns (a placed
    weight gathered first) and keeps this rank's."""
    from repro_torch.photonic import Epilogue, EpilogueSpec
    from repro_torch.photonic import sharded as tp
    from repro_torch.runtime.sharding import (block, column_layout, gather_block, gather_rows, reduce_from_model,
                                              reduce_rows, whole_input)

    if epilogue is not None:
        if activation is not None:
            raise TypeError(
                "pass either epilogue= or the legacy activation= keyword, not both"
            )
        if not isinstance(epilogue, EpilogueSpec) or epilogue.bias:
            raise TypeError("dense() takes a bias-free EpilogueSpec")
        activation = epilogue.activation
    bias = params.get("b")
    ep = Epilogue(EpilogueSpec(bias=bias is not None, activation=activation), bias)
    eng = engine_from_model_config(cfg)
    kw = dict(site=site, layer=layer, slicing=slicing, prng_key=prng_key)
    layout = None if columns is None else column_layout(columns)
    if layout is not None:
        routed = eng
        if routed is None and "w_scale" in params:
            from repro_torch.photonic.engine import engine_for

            routed = engine_for(DPUConfig(), cfg.photonic_backend)
        if routed is not None and not routed.routes(site):
            routed = None
        y = tp.column_matmul(routed, layout, params, x, cfg, site=site, fold=layer, prng_key=prng_key, epilogue=ep,
                             slicing=slicing)
        if y is not None:
            return y
        w = params["w"]
        if isinstance(w, torch.Tensor) and w.shape[-1] != layout.total:
            params = {k: layout.gather(v) for k, v in params.items()}
        return layout.take(dense(params, whole_input(x), cfg, epilogue=epilogue, activation=activation, **kw))
    kb = None if k_local is None else block(k_local)
    if kb is not None:
        y = tp.maybe_tp_matmul(
            eng, params, x, cfg, site=site, fold=layer, prng_key=prng_key, epilogue=ep, slicing=slicing, k_block=kb,
            block_output=True,
        )
        if y is not None:
            return y
        w = params["w"]
        if isinstance(w, torch.Tensor) and w.shape[-2] == x.shape[-1]:  # the weight's K rows (placed)
            if "w_scale" not in params and (eng is None or not eng.routes(site)):
                # digital: the partial products summed over the K axes, then the epilogue (a bias, whose
                # gradient must sum every position, on the whole sum)
                y = x @ w.to(x.dtype)
                return _digital_epilogue(reduce_rows(y, kb.part) if ep.bias is None else reduce_from_model(y, kb.part),
                                         ep)
            params = {**params, "w": gather_rows(w, kb)}
        x = gather_block(x, k_local, x.dim() - 1)
    y = tp.maybe_tp_matmul(
        eng, params, x, cfg, site=site, fold=layer, prng_key=prng_key, epilogue=ep, slicing=slicing,
        block_output=k_local is not None,
    )
    if y is not None:
        return y
    return _single_device_matmul(
        eng, params, params["w"], x, cfg, site=site, layer=layer, epilogue=ep, slicing=slicing,
        prng_key=prng_key,
    )


def _digital_epilogue(y, ep):
    if ep.bias is not None:
        y = y + ep.bias.to(y.dtype)
    if ep.spec.activation is not None:
        from repro_torch.photonic import ACTIVATIONS

        y = ACTIVATIONS[ep.spec.activation](y)
    return y


def _single_device_matmul(
    eng, params, w, x, cfg, *, site, layer, epilogue, slicing=None, prng_key=None
):
    """Reference: ``repro.models.common:_single_device_matmul``."""
    from repro_torch.photonic.packing import PackedDense

    kw = dict(site=site, fold=layer, epilogue=epilogue, slicing=slicing, prng_key=prng_key)
    if isinstance(w, PackedDense):
        if eng is None:
            return _digital_epilogue(x @ w.dequant().to(x.dtype), epilogue)
        return eng.matmul(x, w, **kw)
    if "w_scale" in params:
        if eng is None:
            from repro_torch.photonic.engine import engine_for

            eng = engine_for(DPUConfig(), cfg.photonic_backend)
        packed = PackedDense(w, params["w_scale"], w.shape[-2], w.shape[-1], tiling=None)
        return eng.matmul(x, packed, **kw)
    if eng is not None and cfg.photonic_scope == "weights":
        return eng.matmul_float(x, w, **kw)
    return _digital_epilogue(x @ w.to(x.dtype), epilogue)


def quantize_params(params: Any, defs: Any) -> Any:
    """A float checkpoint in the int8-stored layout that ``defs`` (made
    with ``photonic_scope="weights_int8"``) describes: every dense def with
    a ``w_scale`` gets an int8 ``w`` and an f32 per-column scale over the
    contraction axis, from the f32 weight in the reference's spelling
    (``quantize_symmetric``).  Per-layer lists are walked layer by layer.
    Reference: ``repro.models.common:quantize_params``."""
    if isinstance(defs, dict) and "w_scale" in defs:
        q, scale = quantize_symmetric(params["w"].to(torch.float32), 8, axis=-2)
        return {**params, "w": q, "w_scale": scale.squeeze(-2)}
    if isinstance(defs, dict):
        return {
            k: quantize_params(params[k], v) if isinstance(v, (dict, list)) else params[k]
            for k, v in defs.items()
        }
    if isinstance(defs, list):
        return [quantize_params(p, d) for p, d in zip(params, defs)]
    return params


def stack_states(states) -> Dict[str, torch.Tensor]:
    """Per-layer state dicts as one dict of tensors stacked on a new
    leading axis (the reference's scanned layout)."""
    return {k: torch.stack([s[k] for s in states]) for k in states[0]}


def zeros_of(defs: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """Zeros for a dict of cache-def ``(shape, axes, dtype)`` leaves: the
    stacked states of a scan over zero layers, as the reference's
    zero-length ``lax.scan`` returns them."""
    return {k: torch.zeros(shape, dtype=dt, device=device) for k, (shape, _, dt) in defs.items()}


def rmsnorm_def(d: int) -> Dict[str, P]:
    return {"scale": P((d,), (None,), init="ones")}


def rmsnorm(params, x: torch.Tensor, eps: float) -> torch.Tensor:
    """Reference: ``repro.models.common:rmsnorm``.  ``x32`` is a copy even
    of an f32 ``x``, so ``x``'s gradient takes the norm's terms as one sum,
    whether ``x`` is the residual or its gather over a placed ``"seq_sp"``."""
    dt = x.dtype
    x32 = x.to(torch.float32, copy=True)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32)).to(dt)


def embed_def(vocab: int, d: int) -> Dict[str, P]:
    return {"table": P((vocab, d), ("vocab", None), init="embed")}


def _vocab_rows(table: torch.Tensor):
    """The active placement's vocab :class:`~repro_torch.runtime.sharding.
    Block` when ``table`` holds this rank's rows of it, else ``None``."""
    from repro_torch.runtime.sharding import block

    b = block("vocab")
    return b if b is not None and table.shape[0] == b.local else None


def embed(params, ids: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Reference: ``repro.models.common:embed``.  A table placed over the
    vocab (this rank's rows, ``runtime.sharding.place_params``) is read by
    a masked lookup, then an all-reduce SUM over its mesh axes in f32, exact
    because one rank holds each row and the others add zeros."""
    table = params["table"]
    b = _vocab_rows(table)
    if b is None:
        return table.to(cfg.compute_dtype)[ids]
    from repro_torch.runtime.sharding import reduce_rows

    local = ids - b.index * b.local
    mine = (local >= 0) & (local < b.local)
    rows = table.to(cfg.compute_dtype)[torch.where(mine, local, torch.zeros_like(local))].to(torch.float32)
    rows = torch.where(mine[..., None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device))
    return reduce_rows(rows, b.part, "vocab").to(cfg.compute_dtype)


def unembed(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Logits head, tied to the embedding table or not (digital, as in the
    reference).  Reference: ``repro.models.common:unembed``.  The product
    runs batched over ``x``'s leading dimension (one ``bmm`` entry a batch
    row, the weight expanded, not copied), so a row's logits do not depend
    on how many rows run beside it: a BLAS folds a plain ``x @ w`` into
    one GEMM whose kernel, and so whose rounding, changes with the row
    count, and a rank holding its block of the rows (``runtime.sharding.
    placement``) must get the replicated program's logits bit for bit.  A
    table placed over the vocab gives this rank's vocab block of the
    logits (the reference's ``vocab``-sharded head), its input's gradient
    summed over the vocab's mesh axes (a column-parallel GEMM)."""
    if "table" in params:
        b = _vocab_rows(params["table"])
        if b is not None:
            from repro_torch.runtime.sharding import copy_to_model

            x = copy_to_model(x, b.part)
    w = params["table"].to(x.dtype).T if "table" in params else params["w"].to(x.dtype)
    if x.dim() < 3:
        return x @ w
    return torch.matmul(x, w.expand(*x.shape[:-2], *w.shape))


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Reference: ``repro.models.common:rope_freqs``."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq).  Reference:
    ``repro.models.common:apply_rope``."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)
    angles = positions[..., :, None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class _Softplus(torch.autograd.Function):
    """``lax.logaddexp(x, 0)`` with its custom JVP: the gradient is ``exp(x
    - out)`` (``+inf`` replaced by 0 on both sides first), not the
    derivative of the spelled-out forward, which passes 1 at ``x = 0``
    where JAX passes 0.5 (xLSTM's zero-init forget gates sit there)."""

    @staticmethod
    def forward(ctx, x):
        out = torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))
        out = torch.where(torch.isnan(x), x, out)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors

        def finite(a):
            return torch.where(a == float("inf"), torch.zeros_like(a), a)

        return g * torch.exp(finite(x) - finite(out))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, spelled as ``lax``
    spells it (``max(x, 0) + log1p(exp(-|x|))``, NaN passed through), with
    ``lax.logaddexp``'s gradient (:class:`_Softplus`).
    ``torch.nn.functional.softplus`` returns ``x`` itself above its
    ``threshold`` instead."""
    return _Softplus.apply(x)


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``."""
    return -softplus(-x)


# ---------------------------------------------------------------------------
# Loss and rematerialization
# ---------------------------------------------------------------------------
def softmax_cross_entropy(
    logits: torch.Tensor,  # (B, T, V_padded)
    labels: torch.Tensor,  # (B, T) int
    true_vocab: int,
) -> torch.Tensor:
    """Mean cross-entropy in f32, padded vocab columns masked to ``-1e30``.
    Reference: ``repro.models.common:softmax_cross_entropy``.  Under a
    placement of the vocab, ``logits`` of this rank's vocab block are
    vocab-parallel: the padded columns masked by their global index, the
    row max a ``MAX`` all-reduce (a shift, no gradient), the sum of
    ``exp`` a SUM all-reduce, the gold logit from the rank that holds its
    column (a SUM of it and zeros)."""
    from repro_torch.runtime.sharding import block

    b = block("vocab")
    if b is not None and logits.shape[-1] == b.local:
        return _vocab_parallel_cross_entropy(logits, labels, true_vocab, b)
    v = logits.shape[-1]
    logits = logits.to(torch.float32)
    if v > true_vocab:
        col = torch.arange(v, device=logits.device)
        logits = torch.where(col < true_vocab, logits, torch.full((), -1e30, device=logits.device))
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].to(torch.int64))[..., 0]
    return torch.mean(lse - gold)


def _vocab_parallel_cross_entropy(logits, labels, true_vocab: int, b) -> torch.Tensor:
    """:func:`softmax_cross_entropy` of this rank's vocab block ``b``."""
    from repro_torch.runtime.sharding import max_over, reduce_from_model

    v0 = b.index * b.local
    logits = logits.to(torch.float32)
    if b.size > true_vocab:
        col = v0 + torch.arange(b.local, device=logits.device)
        logits = torch.where(col < true_vocab, logits, torch.full((), -1e30, device=logits.device))
    m = max_over(torch.amax(logits, dim=-1).detach(), b.part)
    lse = torch.log(reduce_from_model(torch.sum(torch.exp(logits - m[..., None]), dim=-1), b.part, "vocab")) + m
    local = labels.to(torch.int64) - v0
    mine = (local >= 0) & (local < b.local)
    gold = torch.gather(logits, -1, torch.where(mine, local, torch.zeros_like(local))[..., None])[..., 0]
    gold = reduce_from_model(torch.where(mine, gold, torch.zeros((), device=gold.device)), b.part, "vocab")
    return torch.mean(lse - gold)


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat_policy="dots"``: save the
    outputs of matrix products without batch dimensions (``mm``,
    ``addmm``, ``mv``, ``dot``), recompute everything else — batched
    products (``bmm``, the attention scores) included.  Reference:
    ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``."""
    from torch.utils.checkpoint import CheckpointPolicy

    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default, aten.mv.default, aten.dot.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def apply_remat(fn, cfg: ModelConfig):
    """``fn`` under activation checkpointing when ``cfg.remat``
    (``torch.utils.checkpoint``, non-reentrant).  Policy "full" (and, as
    in the reference, any name but "dots") saves nothing and recomputes
    the whole call in the backward; "dots" saves the outputs of matrix
    products without batch dimensions (:func:`_dots_policy`).  The
    photonic kernel is a ``ctypes`` call, not a product the policy sees
    (in the reference it is a ``pallas_call``, no ``dot`` either), so it
    is recomputed under both; the recompute is deterministic, so both
    policies give the same losses and gradients bit for bit.  Without
    autograd (no grad mode) the call runs as it is, as ``jax.checkpoint``
    outside a differentiation does.  The recompute runs under the
    tensor-parallel scope and placement of the forward call (both are
    thread-local and autograd recomputes on its own thread on the card), as
    the reference's recompute replays the traced, sharded forward.
    Reference: ``repro.models.common:apply_remat``."""
    if not cfg.remat:
        return fn
    from repro_torch.photonic.sharded import current_tp, reenter
    from repro_torch.runtime import sharding as shd

    def contexts(tp, pl):
        if cfg.remat_policy == "dots":
            from torch.utils.checkpoint import create_selective_checkpoint_contexts

            fwd, rec = create_selective_checkpoint_contexts(_dots_policy)
        else:
            fwd, rec = contextlib.nullcontext(), contextlib.nullcontext()
        return fwd, _stacked_contexts(rec, reenter(tp), shd.reenter(pl))

    def remat(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        # The recompute runs in the backward, on autograd's device thread on
        # the card: it re-enters the forward's tensor-parallel scope and
        # placement, so its GEMMs K-shard, take the same scales and issue
        # their collectives as the forward's did.
        tp, pl = current_tp(), shd.current_placement()
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                                 context_fn=functools.partial(contexts, tp, pl))

    return remat


@contextlib.contextmanager
def _stacked_contexts(*cms):
    with contextlib.ExitStack() as stack:
        for cm in cms:
            stack.enter_context(cm)
        yield


# ---------------------------------------------------------------------------
# Sharding-constraint helper (no-op outside a mesh)
# ---------------------------------------------------------------------------
def with_logical(x: torch.Tensor, axes: Tuple[Optional[str], ...]) -> torch.Tensor:
    """Reference: ``repro.models.common:with_logical``
    (:func:`repro_torch.runtime.sharding.logical_constraint`: ``x``
    unchanged; under a placement its placed dimensions are checked to be
    this rank's blocks; inside a ``use_rules`` scope the spec's
    divisibility fallbacks are recorded)."""
    return logical_constraint(x, axes)
