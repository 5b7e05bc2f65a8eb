"""Engine-side attention-core surface: the flash-attention kernel as the
models reach it.

Port of ``repro.photonic.flash``: ``models/attention.py`` takes the kernel
from here, not from ``repro_torch.kernels``.  Selected per model with
``ModelConfig.attn_impl = "flash"``; the default ("chunked") keeps the
online-softmax loop.  The two cores are the same math over different key
blocks, so they agree to float tolerance, not bitwise.  Decode and the
paged paths stay on their explicit-softmax / chunked cores either way.
"""

from __future__ import annotations

from repro_torch.kernels.flash_attention.ops import flash_attention

__all__ = ["flash_attention"]
