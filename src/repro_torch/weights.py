"""Carry the reference's parameters into the port.

Parity tests that start from a tree the reference built (its weights,
a training state, the int8 layout, a prepacked bank) hand it over as
numpy arrays; :func:`params_from_jax` turns that tree (stacked layer axes
included) into the port's layout, where ``layers`` (and the other stacks:
llama-vision's ``cross``, whisper's ``enc_layers`` and ``dec_layers``,
xLSTM's ``slstm``) is a per-layer list (a stacked ``(L, E, d, 2f)`` expert
bank becomes ``(E, d, 2f)`` per layer), the doubly stacked ``(n_groups,
per, ...)`` ``mlstm`` (xLSTM) and ``mamba`` (Zamba2) become lists of
groups, each a list of per-layer dicts, and an unstacked block such as
DeepSeek-V2's ``first_block`` or Zamba2's ``shared`` comes as it is), and
:func:`train_state_from_jax` does the same for a training state (params
plus the AdamW moments and step), so a test can continue a reference run in
the port; :func:`params_to_reference` goes the other way, a port tree (its
parameters or their gradients) in the reference's stacked layout.  The
int8-stored serving layout (``quantize_params``: int8 ``w`` with an f32
per-column ``w_scale``) and a fused ``wqkv`` attention dict come across
unchanged in dtype, and so does a prepacked weight, the reference's
``PackedDense`` (K-sharded or not: its stored bank, scale, logical dims,
tiling and shard count), as the port's (:func:`packed_from_jax`).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device

# The reference's layer stacks and how many leading layer axes each has
# (lists, or lists of lists, in the port): the decoder layers,
# llama-vision's cross layers, whisper's encoder and decoder, xLSTM's sLSTM
# layers (one a group); xLSTM's mLSTM and Zamba2's Mamba2 layers, stacked
# (n_groups, per, ...).
STACKED = {"layers": 1, "cross": 1, "enc_layers": 1, "dec_layers": 1, "slstm": 1, "mlstm": 2, "mamba": 2}
# Float leaves that keep f32 whatever the parameter dtype: the per-column
# dequantization scales of the int8-stored layout.
_F32_LEAVES = frozenset({"w_scale"})


def _tensor(a, dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind not in "iub" and a.dtype != np.float32 and a.dtype != np.float64:
        a = a.astype(np.float32)  # e.g. ml_dtypes bfloat16, which torch cannot read
    t = torch.from_numpy(np.array(a, copy=True, order="C"))
    if t.is_floating_point() and dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(tree: Any, cfg, device=None) -> Any:
    """The reference's parameter tree (nested dicts of numpy arrays, layer
    leaves stacked on axis 0) as the port's parameters on ``device``.
    Float leaves take ``cfg.param_dtype``, except a ``w_scale``, which stays
    f32 as the int8 layout keeps it; integer leaves keep their dtype."""
    return _unstacked(tree, cfg.param_dtype, resolve_device(device))


def train_state_from_jax(params: Any, opt_state: Any, cfg, device=None):
    """The reference's training state (its params and ``OptState(step, mu,
    nu)``, as numpy trees) as the port's
    :class:`~repro_torch.runtime.train_loop.TrainState` on ``device``: the
    params as :func:`params_from_jax` makes them, the moments f32 with the
    same layer unstacking, the step a 0-dim int32 tensor."""
    from repro_torch.optim.adamw import OptState
    from repro_torch.runtime.train_loop import TrainState

    dev = resolve_device(device)
    step, mu, nu = opt_state
    step = int(np.asarray(step))
    opt = OptState(
        torch.tensor(step, dtype=torch.int32, device=dev),
        _unstacked(mu, torch.float32, dev),
        _unstacked(nu, torch.float32, dev),
    )
    return TrainState(params_from_jax(params, cfg, dev), opt, step)


class _Pack(NamedTuple):
    """One layer's slice of a stacked reference ``PackedDense``."""

    wq: Any
    w_scale: Any
    k: int
    c: int
    tiling: Optional[Tuple[int, int, int]]
    shards: int


def _is_pack(node) -> bool:
    """A reference ``PackedDense`` (duck-typed: the port imports no
    ``repro``) or a :class:`_Pack`."""
    return all(hasattr(node, a) for a in ("wq", "w_scale", "k", "c", "tiling", "shards"))


def packed_from_jax(pack, *, words: bool = False, device=None):
    """The reference's ``PackedDense`` as the port's
    :class:`~repro_torch.photonic.packing.PackedDense` on ``device``: the
    int8 bank as stored (the K-sharded ``(shards * Kp_local, Cp)`` layout
    kept, with ``shards``), the f32 global scale, the logical ``k, c`` and
    the tiling; with ``words`` also the content word(s) the port's pack
    carries for a noisy engine (one a block when sharded), computed from
    the bank."""
    from repro_torch.noise.stages import tweak_word, tweak_words
    from repro_torch.photonic.packing import PackedDense

    dev = resolve_device(device)
    wq = _tensor(pack.wq, None, dev)
    scale = _tensor(pack.w_scale, torch.float32, dev)
    tiling = None if pack.tiling is None else tuple(int(t) for t in pack.tiling)
    shards = int(pack.shards)
    word = None
    if words:
        word = tweak_word(wq) if shards == 1 else tweak_words(wq.reshape(shards, -1, wq.shape[-1]))
    return PackedDense(wq, scale, int(pack.k), int(pack.c), tiling, shards, word)


def _unstacked(tree: Any, dtype, dev) -> Any:
    def conv(node, key=None):
        if _is_pack(node):
            return packed_from_jax(node, device=dev)
        if isinstance(node, dict):
            return {k: conv(v, k) for k, v in node.items()}
        return _tensor(node, torch.float32 if key in _F32_LEAVES else dtype, dev)

    def unstack(node, i):
        if _is_pack(node):
            return _Pack(np.asarray(node.wq)[i], np.asarray(node.w_scale)[i], node.k, node.c, node.tiling,
                         node.shards)
        if isinstance(node, dict):
            return {k: unstack(v, i) for k, v in node.items()}
        return np.asarray(node)[i]

    def lists(node, depth):
        if depth == 0:
            return conv(node)
        n = len(np.asarray(_first_leaf(node)))
        return [lists(unstack(node, i), depth - 1) for i in range(n)]

    return {key: lists(sub, STACKED[key]) if key in STACKED else conv(sub, key) for key, sub in tree.items()}


def _first_leaf(node):
    while isinstance(node, dict) or _is_pack(node):
        node = node.wq if _is_pack(node) else node[sorted(node)[0]]
    return node


def params_to_reference(tree: Any) -> Any:
    """A port tree of tensors (parameters, gradients or moments) in the
    reference's layout, as numpy: each per-layer list (or list of lists)
    stacked on its leading axes again, bf16 leaves as f32 (numpy has no
    bfloat16).  The inverse of :func:`params_from_jax` up to dtype."""

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, list):
            return _stacked([conv(v) for v in node])
        t = node.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()

    return conv(tree)


def _stacked(parts):
    if isinstance(parts[0], dict):
        return {k: _stacked([p[k] for p in parts]) for k in parts[0]}
    return np.stack(parts)
