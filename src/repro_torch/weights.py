"""Carry the reference's parameters into the port.

``repro`` initializes with ``jax.random``, which PyTorch cannot reproduce,
so parity tests build parameters with the reference and hand them over as
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
unchanged in dtype.
"""

from __future__ import annotations

from typing import Any

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


def _unstacked(tree: Any, dtype, dev) -> Any:
    def conv(node, key=None):
        if isinstance(node, dict):
            return {k: conv(v, k) for k, v in node.items()}
        return _tensor(node, torch.float32 if key in _F32_LEAVES else dtype, dev)

    def unstack(node, i):
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
    while isinstance(node, dict):
        node = node[sorted(node)[0]]
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
