"""The bit-sliced execution mode (DESIGN.md §15).

Port of ``repro.photonic.slicing`` (a private copy: nothing of ``repro`` is
imported).  :class:`SlicingSpec` makes the plane width an execution choice
decoupled from the hardware's analog precision B: slicing int8 operands
into 2-bit planes runs 16 analog passes instead of 4, each at the product
full-scale ``(2^p - 1)^2`` instead of ``(2^B - 1)^2``, so the detector sigma
referred to it shrinks by the same ratio, and the digital shift-add
recombination is exact.

:func:`resolve_slicing` is the one normalization point of the ``slicing=``
argument across the engine's GEMM surface: ``None`` is the hardware
datapath unchanged, an int or a digit string is the plane width, and a
:class:`SlicingSpec` passes through.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

_VALID_PLANE_BITS = (1, 2, 4, 8)


@dataclasses.dataclass(frozen=True)
class SlicingSpec:
    """Bit-sliced execution mode (frozen, hashable).  Reference:
    ``repro.photonic.slicing:SlicingSpec``.

    ``plane_bits`` is the per-pass operand plane width p.  Each GEMM runs
    ``num_planes(operand_bits)**2`` plane-pair passes through the channel
    re-referred to the p-bit full-scale
    (:func:`repro_torch.noise.channel.sliced_channel`), recombined with
    exact shifts: under an ideal channel the result is bitwise the unsliced
    exact GEMM.
    """

    plane_bits: int = 2

    def __post_init__(self):
        if self.plane_bits not in _VALID_PLANE_BITS:
            raise ValueError(
                f"plane_bits must be one of {_VALID_PLANE_BITS}, got "
                f"{self.plane_bits!r}"
            )

    def num_planes(self, operand_bits: int) -> int:
        """Planes per operand: ``ceil(operand_bits / plane_bits)``."""
        return -(-int(operand_bits) // self.plane_bits)

    def __str__(self) -> str:
        return f"{self.plane_bits}b-planes"


def resolve_slicing(
    slicing: Union[None, int, str, SlicingSpec],
) -> Optional[SlicingSpec]:
    """The normalization point of the ``slicing=`` mode argument.
    Reference: ``repro.photonic.slicing:resolve_slicing``.

    ``None`` / ``"none"`` / ``"off"`` / ``""`` -> ``None`` (unsliced); an
    int or a digit string -> ``SlicingSpec(plane_bits)``; a spec passes
    through.  Anything else raises ``ValueError`` at once.
    """
    if slicing is None:
        return None
    if isinstance(slicing, SlicingSpec):
        return slicing
    if isinstance(slicing, bool):  # bool is an int; reject it explicitly
        raise ValueError(
            f"slicing must be None, an int, or SlicingSpec, got {slicing!r}"
        )
    if isinstance(slicing, int):
        return SlicingSpec(plane_bits=slicing)
    if isinstance(slicing, str):
        text = slicing.strip().lower()
        if text in ("", "none", "off"):
            return None
        if text.isdigit():
            return SlicingSpec(plane_bits=int(text))
    raise ValueError(
        f"slicing must be None, plane bits (int or digit string), or a "
        f"SlicingSpec, got {slicing!r}"
    )
