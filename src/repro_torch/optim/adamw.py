"""AdamW with decoupled weight decay, global-norm clipping and LR schedules.

Port of ``repro.optim.adamw``, spelled as plain tensor ops over the
parameter tree in the reference's order (``torch.optim.AdamW`` places eps
and the decay differently).  The moments are f32 whatever the parameter
dtype, so bf16 parameters keep f32 statistics; the step counter is a 0-dim
int32 tensor on the parameters' device, and the schedule is computed from
it in f32 tensor ops as the reference computes it from its array.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch._tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    """Reference: ``repro.optim.adamw:AdamWConfig`` (same fields and
    defaults)."""

    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    schedule: str = "cosine"  # cosine | linear | constant


class OptState(NamedTuple):
    """Reference: ``repro.optim.adamw:OptState``."""

    step: torch.Tensor  # 0-dim int32
    mu: Any
    nu: Any


def init(params: Any) -> OptState:
    """Zero f32 moments shaped like ``params``, step 0.  Reference:
    ``repro.optim.adamw:init``."""
    dev = tree_leaves(params)[0].device

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return OptState(
        torch.zeros((), dtype=torch.int32, device=dev), tree_map(zeros, params), tree_map(zeros, params)
    )


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), v, dtype=torch.float32, device=like.device)


def schedule_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine (to 0.1 x), linear (to 0.1 x) or constant
    decay; 0-dim f32.  Reference: ``repro.optim.adamw:schedule_lr``."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        decay = _f32(1.0, step)
    else:
        frac = torch.clamp(
            (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0
        )
        if cfg.schedule == "linear":
            decay = 1.0 - 0.9 * frac
        else:  # cosine
            decay = 0.1 + 0.45 * (1.0 + torch.cos(math.pi * frac))
    return cfg.lr * warm * decay


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32.  Reference:
    ``repro.optim.adamw:global_norm``."""
    return torch.sqrt(sum(torch.sum(x.to(torch.float32) ** 2) for x in tree_leaves(tree)))


def update(
    cfg: AdamWConfig, params: Any, grads: Any, state: OptState
) -> Tuple[Any, OptState, dict]:
    """One AdamW step; returns ``(new_params, new_state, {"lr",
    "grad_norm"})``.  Reference: ``repro.optim.adamw:update``."""
    gnorm = global_norm(grads)
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
        grads = tree_map(lambda g: g * scale.to(g.dtype), grads)

    step = state.step + 1
    lr = schedule_lr(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1.0 - torch.pow(_f32(b1, step), step.to(torch.float32))
    bc2 = 1.0 - torch.pow(_f32(b2, step), step.to(torch.float32))

    def upd(p, g, mu, nu):
        g32 = g.to(torch.float32)
        mu = b1 * mu + (1 - b1) * g32
        nu = b2 * nu + (1 - b2) * g32 * g32
        mhat = mu / bc1
        vhat = nu / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype), mu, nu

    out = [
        upd(p, g, m, n)
        for p, g, m, n in zip(
            tree_leaves(params), tree_leaves(grads), tree_leaves(state.mu), tree_leaves(state.nu)
        )
    ]
    new_p = tree_unflatten(params, [o[0] for o in out])
    new_mu = tree_unflatten(params, [o[1] for o in out])
    new_nu = tree_unflatten(params, [o[2] for o in out])
    return new_p, OptState(step, new_mu, new_nu), {"lr": lr, "grad_norm": gnorm}


def opt_state_axes(param_axes: Any) -> OptState:
    """Logical axes of the optimizer state: the step unsharded, the
    moments sharded like the params.  Reference:
    ``repro.optim.adamw:opt_state_axes``."""
    return OptState((), param_axes, param_axes)
