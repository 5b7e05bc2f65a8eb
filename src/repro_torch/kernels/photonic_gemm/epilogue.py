"""Fused GEMM shoulder work shared by every photonic backend, in PyTorch.

Port of ``repro.kernels.photonic_gemm.epilogue``: the single definition of
the activation-quantize prologue (:func:`quantize_tile`) and the
rescale / bias / activation epilogue (:func:`apply_epilogue`).  The CUDA
kernel applies the same op sequence per element; the rescale chain
``acc.f32 * x_scale * w_scale`` is left-associated and multiply-only, so
it is bitwise across backends.  The bias add and the activation are held
at float tolerance against the reference (its compiled regime may contract
them into FMAs).  Gelu is the tanh form, ``jax.nn.gelu``'s default, spelled
in the kernel's op order.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F


def _gelu(y: torch.Tensor) -> torch.Tensor:
    """The tanh-form gelu in the CUDA kernel's op order (``gelu_tanh`` in
    ``csrc/photonic_gemm.cu``), one rounding per op: ``x * (0.5 * (1 +
    tanh(c * (x + 0.044715 * x^3))))``, ``c = sqrt(2 / pi)`` rounded to f32;
    a narrower input is computed in f32 and rounded once, as ``F.gelu``
    does."""
    x = y.to(torch.float32)
    x3 = x * x * x
    return (x * (0.5 * (1.0 + torch.tanh(0.7978845608028654 * (x + 0.044715 * x3))))).to(y.dtype)


ACTIVATIONS = {
    "gelu": _gelu,
    "silu": F.silu,
}


@dataclasses.dataclass(frozen=True)
class EpilogueSpec:
    """What the fused GEMM epilogue applies to the int32 accumulator.
    Reference: ``repro.kernels.photonic_gemm.epilogue:EpilogueSpec``."""

    bias: bool = False
    activation: Optional[str] = None  # None | "gelu" | "silu"

    def __post_init__(self):
        if self.activation is not None and self.activation not in ACTIVATIONS:
            raise ValueError(
                f"activation={self.activation!r} is not one of "
                f"{(None, *sorted(ACTIVATIONS))}"
            )


class EpilogueArgs(NamedTuple):
    """Runtime operands of one fused-epilogue GEMM call.  Reference:
    ``repro.kernels.photonic_gemm.epilogue:EpilogueArgs``."""

    spec: EpilogueSpec
    x_scale: torch.Tensor
    w_scale: torch.Tensor
    bias: Optional[torch.Tensor] = None


class Epilogue(NamedTuple):
    """A static spec plus its runtime bias operand.  Reference:
    ``repro.kernels.photonic_gemm.epilogue:Epilogue``."""

    spec: EpilogueSpec
    bias: Optional[torch.Tensor] = None


def as_epilogue(
    epilogue=None,
    *,
    bias: Optional[torch.Tensor] = None,
    activation: Optional[str] = None,
) -> "tuple[EpilogueSpec, Optional[torch.Tensor]]":
    """Normalize the ``epilogue=`` surface to ``(spec, bias)``.  Reference:
    ``repro.kernels.photonic_gemm.epilogue:as_epilogue``."""
    if epilogue is None:
        return EpilogueSpec(bias=bias is not None, activation=activation), bias
    if bias is not None or activation is not None:
        raise TypeError(
            "pass either epilogue= or the legacy bias=/activation= "
            "keywords, not both"
        )
    if isinstance(epilogue, Epilogue):
        spec, b = epilogue
        if not isinstance(spec, EpilogueSpec):
            raise TypeError(
                f"Epilogue.spec must be an EpilogueSpec, got "
                f"{type(spec).__name__}"
            )
        if spec.bias != (b is not None):
            raise TypeError(
                f"Epilogue spec.bias={spec.bias} disagrees with its bias "
                f"operand ({'present' if b is not None else 'absent'})"
            )
        return spec, b
    if isinstance(epilogue, EpilogueSpec):
        if epilogue.bias:
            raise TypeError(
                "EpilogueSpec(bias=True) carries no bias operand; pass "
                "Epilogue(spec, bias) instead"
            )
        return epilogue, None
    raise TypeError(
        f"epilogue must be an EpilogueSpec or Epilogue, got "
        f"{type(epilogue).__name__}"
    )


def quantize_tile(x: torch.Tensor, scale: torch.Tensor, qmax: float) -> torch.Tensor:
    """The prologue: ``clip(round_half_even(x / scale))`` as int32.
    Reference: ``repro.kernels.photonic_gemm.epilogue:quantize_tile``."""
    return torch.clamp(torch.round(x / scale), -qmax, qmax).to(torch.int32)


def apply_epilogue(
    acc: torch.Tensor,  # (..., C) int32
    x_scale: torch.Tensor,  # scalar f32
    w_scale: torch.Tensor,  # (C,) f32
    bias: Optional[torch.Tensor],
    spec: EpilogueSpec,
) -> torch.Tensor:
    """int32 accumulator -> rescale -> optional bias -> optional activation.
    Reference: ``repro.kernels.photonic_gemm.epilogue:apply_epilogue``."""
    y = acc.to(torch.float32) * x_scale.to(torch.float32) * w_scale.to(torch.float32)
    return apply_bias_activation(y, bias, spec.activation)


def apply_bias_activation(
    y: torch.Tensor, bias: Optional[torch.Tensor], activation: Optional[str]
) -> torch.Tensor:
    """The bias/activation tail of the epilogue.  Reference:
    ``repro.kernels.photonic_gemm.epilogue:apply_bias_activation``."""
    if bias is not None:
        y = y + bias.to(torch.float32)
    if activation is not None:
        y = ACTIVATIONS[activation](y)
    return y
