"""Signal-chain stages of the analog channel, in PyTorch.

Port of ``repro.noise.stages``.  The counter-based generator is the
reference's bit for bit: murmur3 ``fmix32`` mixing, the same seed folding
and the same Box-Muller transform, so the plain twin of the photonic GEMM
kernel and the CUDA kernel itself draw the reference's noise stream.

uint32 arithmetic: torch has no usable uint32 ``>>``/``+`` on the CPU and
``.sum()`` promotes, so every uint32 value is held in an int64 tensor (or
a Python int) in ``[0, 2^32)`` and masked with ``& 0xFFFFFFFF`` after each
multiply and add.  Multiplies by 32-bit constants are split into 16-bit
halves (:func:`_mul32`) so no intermediate leaves the int64 range.  The
same functions accept Python ints, which is how scalar seeds (site, layer,
key words) are folded on the host without a device round trip.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import numpy as np
import torch

U32 = 0xFFFFFFFF

_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9
_S1 = 0x27D4EB2F
_S2 = 0x165667B1
_S3 = 0x5BF03635

UInt = Union[int, torch.Tensor]  # a uint32 value: Python int or int64 tensor


def _mul32(x: UInt, m: int) -> UInt:
    """``(x * m) mod 2^32`` for ``x`` in [0, 2^32) and a constant ``m``,
    with every partial product below 2^48 (int64-safe)."""
    lo = x * (m & 0xFFFF)
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & U32


def hash_mix32(x: UInt) -> UInt:
    """murmur3 fmix32 finalizer.  Reference: ``repro.noise.stages:hash_mix32``."""
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 13)
    x = _mul32(x, _M2)
    x = x ^ (x >> 16)
    return x


def _u32(v: UInt) -> UInt:
    """An integer id or seed as its uint32 image (two's complement wrap, as
    ``astype(jnp.uint32)`` does)."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.int64) & U32
    return int(v) & U32


def fold_seed(seed: UInt, *ids: UInt) -> UInt:
    """Fold integer stream ids into a seed: ``s ^ ((v+1)*GOLDEN) ^ i``, then
    mix.  Reference: ``repro.noise.stages:fold_seed``."""
    s = _u32(seed)
    for i, v in enumerate(ids):
        v = _u32(v)
        s = hash_mix32(s ^ _mul32((v + 1) & U32, _GOLDEN) ^ i)
    return s


def f32(v: float, device) -> torch.Tensor:
    """A Python float as a 0-dim f32 tensor on ``device``, rounded to f32 as
    JAX rounds a weak-typed scalar.  Built with ``torch.full`` (a fill
    kernel), not a host-to-device copy, so it never synchronizes."""
    return torch.full((), v, dtype=torch.float32, device=device)


def gaussian_from_ctr(base: UInt, ctr: torch.Tensor) -> torch.Tensor:
    """Standard-normal draws for element counters ``ctr`` (int64 tensor)
    under stream seed(s) ``base`` (broadcastable) — the elementwise body of
    :func:`gaussian_from_counter`."""
    dev = ctr.device
    u1 = hash_mix32(base ^ _mul32(ctr, _S1))
    u2 = hash_mix32(base ^ _mul32(ctr, _S2) ^ _S3)
    inv24 = f32(1.0 / (1 << 24), dev)
    f1 = (u1 >> 8).to(torch.float32) * inv24 + f32(0.5 / (1 << 24), dev)
    f2 = (u2 >> 8).to(torch.float32) * inv24
    r = torch.sqrt(f32(-2.0, dev) * torch.log(f1))
    return r * torch.cos(f32(2.0 * math.pi, dev) * f2)


def gaussian_from_counter(base: UInt, shape, device=None) -> torch.Tensor:
    """Standard-normal draws of ``shape`` from a mixed ``base`` seed; the
    counter is the row-major flat index.  Reference:
    ``repro.noise.stages:gaussian_from_counter``."""
    if isinstance(base, torch.Tensor):
        device = base.device
    n = math.prod(shape)
    ctr = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return gaussian_from_ctr(base, ctr & U32)


def tweak_word(a: torch.Tensor) -> torch.Tensor:
    """The content word ``sum(uint32(a) * S1) mod 2^32`` of one operand
    (0-dim int64).  Zero padding contributes nothing, so a padded weight
    gives the same word as its logical region."""
    return _mul32(a.to(torch.int64) & U32, _S1).sum() & U32


def tweak_words(a: torch.Tensor) -> torch.Tensor:
    """:func:`tweak_word` of each ``a[i]`` along the leading axis (int64
    ``(a.shape[0],)``), bitwise the per-slice values."""
    return _mul32(a.to(torch.int64) & U32, _S1).reshape(a.shape[0], -1).sum(dim=1) & U32


def fold_words(seed: UInt, *words: UInt) -> UInt:
    """Fold precomputed content words into a seed (the second half of
    :func:`data_tweak`)."""
    s = _u32(seed)
    for w in words:
        s = hash_mix32(s ^ w)
    return s


def data_tweak(seed: UInt, *arrays: torch.Tensor) -> UInt:
    """Fold a content hash of the operands into a stream seed.  Reference:
    ``repro.noise.stages:data_tweak``."""
    return fold_words(seed, *(tweak_word(a) for a in arrays))


def seed_from_key(prng_key) -> Optional[int]:
    """Collapse a PRNG key to a uint32 seed (a Python int).  ``prng_key``
    is a port key (:mod:`repro_torch.prng`, a uint32 array of shape
    ``(2,)``), a raw JAX key as numpy, a torch tensor or a sequence of
    key words.  Reference: ``repro.noise.stages:seed_from_key`` (which
    first unwraps a typed JAX key to these words)."""
    if prng_key is None:
        return None
    if isinstance(prng_key, torch.Tensor):
        prng_key = prng_key.detach().cpu().numpy()
    return seed_from_key_words(*(int(w) for w in np.asarray(prng_key).reshape(-1)))


def seed_from_key_words(*words: UInt) -> UInt:
    """:func:`seed_from_key` of the key whose words are ``words``: Python
    ints, or int64 tensors holding many keys' words elementwise."""
    seed = 0
    for i, w in enumerate(words):
        seed = hash_mix32(seed ^ _u32(w) ^ (i * _GOLDEN & U32))
    return seed


def neighbor_sum(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Sum of the two adjacent channels along ``axis``, zero at the edges.
    Reference: ``repro.noise.stages:neighbor_sum``."""
    axis = axis % x.dim()
    n = x.shape[axis]
    zero = torch.zeros_like(x.narrow(axis, 0, 1))
    up = torch.cat([x.narrow(axis, 1, n - 1), zero], dim=axis)
    dn = torch.cat([zero, x.narrow(axis, 0, n - 1)], dim=axis)
    return up + dn


class _RoundSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def round_ste(x: torch.Tensor) -> torch.Tensor:
    """``torch.round`` (half to even) with an identity (straight-through)
    gradient.  Reference: ``repro.noise.stages:round_ste``."""
    return _RoundSTE.apply(x)


def adc_quantize(
    a: torch.Tensor, adc_bits: Optional[int], *, differentiable: bool = False
) -> torch.Tensor:
    """ADC: round half-to-even to psum LSBs, saturate to ``adc_bits``.
    The default is the integer datapath's int32; ``differentiable=True``
    keeps the float dtype and rounds through :func:`round_ste` (the clip
    keeps its usual subgradient).  Reference:
    ``repro.noise.stages:adc_quantize``."""
    q = round_ste(a) if differentiable else torch.round(a)
    if adc_bits is not None:
        lim = 2 ** (adc_bits - 1) - 1
        q = torch.clamp(q, -lim, lim)
    return q if differentiable else q.to(torch.int32)


def filter_truncation(a: torch.Tensor, alpha: float) -> torch.Tensor:
    """Aggregation-filter truncation, the amplitude compression ``1 - alpha``
    (one f32 multiply).  Reference: ``repro.noise.stages:filter_truncation``."""
    return a * f32(1.0 - alpha, a.device)


def detector_noise(a: torch.Tensor, sigma: float, base: UInt, ctr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Additive detector noise, ``sigma`` psum LSBs of the counter-based
    normal stream ``base`` over ``a``'s row-major index (or the element
    counters ``ctr``, broadcastable to ``a``).  The draw does not depend on
    ``a``, so the gradient passes through exactly.  Reference:
    ``repro.noise.stages:detector_noise``."""
    if sigma <= 0.0:
        return a
    if ctr is None:
        z = gaussian_from_counter(base, tuple(a.shape), device=a.device)
    else:
        z = gaussian_from_ctr(base, ctr & U32)
    return a + f32(sigma, a.device) * z
