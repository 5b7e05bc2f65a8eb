"""Shared model substrate: config, parameter definitions, core layers.

Port of ``repro.models.common``.  Models are plain functions over nested
dicts of tensors; a *definition tree* (nested dicts / per-layer lists of
:class:`P`) carries each parameter's shape and init rule, and
:func:`init_params` materializes it from a ``torch.Generator`` (the card
has no JAX, so the port initializes its own weights; parity tests instead
carry the reference's weights over with ``repro_torch.weights``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.utils.checkpoint

from repro_torch._device import resolve_device
from repro_torch.core.dpu import DPUConfig, quantize_symmetric
from repro_torch.runtime.sharding import logical_constraint


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
    """A parameter definition.  Reference: ``repro.models.common:P``."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "fan_in"  # fan_in | zeros | ones | embed | normal
    fan_axis: int = 0
    dtype: Optional[str] = None  # override param_dtype ("int8", "float32")

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} disagree")


_DTYPES = {"int8": torch.int8, "float32": torch.float32}


def init_params(
    cfg: ModelConfig,
    generator: Union[int, torch.Generator],
    device=None,
    defs: Any = None,
) -> Any:
    """Materialize ``defs`` (default: the defs of ``cfg.family``) from a
    seeded generator on ``device`` (``cuda`` unless asked otherwise).

    Same init rules as ``repro.models.common:init_tree`` (fan-in-scaled
    normals, 0.02 normals for embeddings, zeros, ones, uniform int8), drawn
    from a torch stream: a different draw than ``jax.random``'s, so parity
    tests carry reference weights over instead."""
    dev = resolve_device(device)
    if not isinstance(generator, torch.Generator):
        seed = int(generator)
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
    if defs is None:
        from repro_torch.models import registry

        defs = registry.FAMILY_FNS[cfg.family][0](cfg)

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


def axes_tree(defs: Any) -> Any:
    """The logical-axis tree matching :func:`init_params`' output: each
    :class:`P` as its ``axes`` tuple, dicts and per-layer lists kept.
    Reference: ``repro.models.common:axes_tree`` (whose stacked layer
    leaves carry one more leading ``None`` per stacking)."""
    if isinstance(defs, P):
        return defs.axes
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
) -> Dict[str, P]:
    """Reference: ``repro.models.common:dense_def``."""
    if quantized:
        d: Dict[str, P] = {
            "w": P((d_in, d_out), axes, init=init, dtype="int8"),
            "w_scale": P((d_out,), (axes[1],), init="ones", dtype="float32"),
        }
    else:
        d = {"w": P((d_in, d_out), axes, init=init)}
    if bias:
        d["b"] = P((d_out,), (axes[1],), init="zeros")
    return d


def qdense_def(cfg: ModelConfig, d_in, d_out, axes, bias=False, init="fan_in"):
    """Reference: ``repro.models.common:qdense_def``."""
    quantized = cfg.photonic is not None and cfg.photonic_scope == "weights_int8"
    return dense_def(d_in, d_out, axes, bias=bias, init=init, quantized=quantized)


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
    bitwise the single-device path under an ideal channel."""
    from repro_torch.photonic import Epilogue, EpilogueSpec
    from repro_torch.photonic import sharded as tp

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
    y = tp.maybe_tp_matmul(
        eng, params, x, cfg, site=site, fold=layer, prng_key=prng_key, epilogue=ep, slicing=slicing,
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
    """Reference: ``repro.models.common:rmsnorm``."""
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32)).to(dt)


def embed_def(vocab: int, d: int) -> Dict[str, P]:
    return {"table": P((vocab, d), ("vocab", None), init="embed")}


def embed(params, ids: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Reference: ``repro.models.common:embed``."""
    return params["table"].to(cfg.compute_dtype)[ids]


def unembed(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Logits head, tied to the embedding table or not (digital, as in the
    reference).  Reference: ``repro.models.common:unembed``."""
    if "table" in params:
        return x @ params["table"].to(x.dtype).T
    return x @ params["w"].to(x.dtype)


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
    Reference: ``repro.models.common:softmax_cross_entropy``."""
    v = logits.shape[-1]
    logits = logits.to(torch.float32)
    if v > true_vocab:
        col = torch.arange(v, device=logits.device)
        logits = torch.where(col < true_vocab, logits, torch.full((), -1e30, device=logits.device))
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].to(torch.int64))[..., 0]
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
    tensor-parallel scope of the forward call (the scope is thread-local and
    autograd recomputes on its own thread on the card), as the reference's
    recompute replays the traced, sharded forward.  Reference:
    ``repro.models.common:apply_remat``."""
    if not cfg.remat:
        return fn
    from repro_torch.photonic.sharded import current_tp, reenter

    def contexts(tp):
        if cfg.remat_policy == "dots":
            from torch.utils.checkpoint import create_selective_checkpoint_contexts

            fwd, rec = create_selective_checkpoint_contexts(_dots_policy)
        else:
            fwd, rec = contextlib.nullcontext(), contextlib.nullcontext()
        return fwd, _stacked_contexts(rec, reenter(tp))

    def remat(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        # The recompute runs in the backward, on autograd's device thread on
        # the card: it re-enters the forward's tensor-parallel scope, so its
        # GEMMs K-shard and issue their collectives as the forward's did.
        tp = current_tp()
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                                 context_fn=functools.partial(contexts, tp))

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
    unchanged; inside a ``use_rules`` scope the spec's divisibility
    fallbacks are recorded)."""
    return logical_constraint(x, axes)
