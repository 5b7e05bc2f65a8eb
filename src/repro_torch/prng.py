"""JAX's ``threefry2x32`` PRNG, bit for bit, in PyTorch.

Port of the key discipline of ``jax.random`` (``jax._src.prng`` and
``jax._src.random``) that the reference threads through its noise streams
and its samplers: ``PRNGKey``, ``fold_in``, ``split``, ``random_bits``,
``uniform``, ``gumbel`` and ``categorical`` on the default
``threefry2x32`` implementation.

A key is what ``jax.random.PRNGKey`` returns: two uint32 words, here a
numpy ``uint32`` array of shape ``(..., 2)`` (``np.asarray`` of a raw JAX
key is one, and so is ``jax.random.key_data`` of a typed key).  Scalar key
work (``PRNGKey``, ``fold_in``, ``split``) runs in Python integers on the
host, so deriving a key costs no device launch.  Bulk bits run on a
device in int64 tensors holding uint32 values in ``[0, 2^32)``, masked
after every add and rotated with shifts (torch has no usable uint32
``>>``/``+`` on the CPU).

``partitionable`` is JAX's ``jax_threefry_partitionable`` flag: ``True``
(the default from JAX 0.5 on) counts bits with a 64-bit iota split into
two words and makes ``split`` a vector of ``fold_in``s; ``False`` is the
0.4.x scheme (one flat counter halved across the two words, 8/16-bit
draws packed little-endian into 32-bit words).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

U32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

UInt = Union[int, torch.Tensor]  # uint32 value(s): Python int or int64 tensor
KeyLike = Union[np.ndarray, torch.Tensor, Sequence[int]]

# dtype -> (bits, mantissa bits), as ``jnp.finfo`` gives them
_FINFO = {torch.float32: (32, 23), torch.bfloat16: (16, 7)}
_INT_VIEW = {32: torch.int32, 16: torch.int16}


def _rotl(x: UInt, r: int) -> UInt:
    return ((x << r) & U32) | (x >> (32 - r))


def threefry2x32(k1: UInt, k2: UInt, x1: UInt, x2: UInt) -> Tuple[UInt, UInt]:
    """The Threefry-2x32 block function (20 rounds) on uint32 words,
    elementwise and broadcasting.  Reference: ``jax._src.prng:
    _threefry2x32_lowering``."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & U32
    x2 = (x2 + ks[1]) & U32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & U32
            x2 = x1 ^ _rotl(x2, r)
        x1 = (x1 + ks[(i + 1) % 3]) & U32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & U32
    return x1, x2


def key_data(key: KeyLike) -> np.ndarray:
    """The key(s) as a uint32 numpy array of shape ``(..., 2)``.  Accepts
    a numpy array, a torch tensor or a pair of ints.  Reference:
    ``jax.random.key_data``."""
    if isinstance(key, torch.Tensor):
        key = key.detach().cpu().numpy()
    a = np.asarray(key)
    if a.shape[-1:] != (2,):
        raise ValueError(f"a threefry key has trailing shape (2,); got {a.shape}")
    if a.dtype != np.uint32:
        a = (a.astype(np.int64) & U32).astype(np.uint32)
    return a


def _words(key: KeyLike) -> Tuple[int, int]:
    a = key_data(key)
    if a.shape != (2,):
        raise ValueError(f"expected a single key of shape (2,); got {a.shape}")
    return int(a[0]), int(a[1])


def _key(k1: int, k2: int) -> np.ndarray:
    return np.array([k1, k2], dtype=np.uint32)


def PRNGKey(seed: int) -> np.ndarray:
    """A legacy raw key from an integer seed.  Reference:
    ``jax.random.PRNGKey`` under 32-bit JAX: the seed becomes an int32
    (its low 32 bits), the high word is its logical shift by 32 (zero) and
    the low word its uint32 image."""
    return _key(0, int(seed) & U32)


def fold_in(key: KeyLike, data: int) -> np.ndarray:
    """A new key from ``key`` and a 32-bit integer: the block function of
    ``threefry_seed(data) = (0, uint32(data))`` under ``key``.  Negative
    data wrap to their uint32 image.  Reference: ``jax.random.fold_in``."""
    k1, k2 = _words(key)
    return _key(*threefry2x32(k1, k2, 0, int(data) & U32))


def _threefry_2x32_flat(k1: UInt, k2: UInt, count: torch.Tensor) -> torch.Tensor:
    """``jax._src.prng:threefry_2x32`` over a flat counter: zero-padded to
    even length, its halves hashed as the two words, the two output words
    concatenated."""
    n = count.shape[-1]
    if n % 2:
        count = torch.cat([count, count.new_zeros(count.shape[:-1] + (1,))], dim=-1)
    h = count.shape[-1] // 2
    o1, o2 = threefry2x32(k1, k2, count[..., :h], count[..., h:])
    return torch.cat([o1, o2], dim=-1)[..., :n]


def split(key: KeyLike, num: Union[int, Tuple[int, ...]] = 2, *, partitionable: bool = True) -> np.ndarray:
    """``num`` new keys (shape ``(*num, 2)``).  Partitionable: key ``i`` is
    the block of ``(0, i)``, a ``fold_in`` of ``i``; otherwise the 0.4.x
    scheme hashes the flat counter ``0 .. 2n-1``.  Reference:
    ``jax.random.split``."""
    shape = tuple(num) if isinstance(num, (tuple, list)) else (int(num),)
    n = math.prod(shape)
    k1, k2 = _words(key)
    if partitionable:
        ctr = torch.arange(n, dtype=torch.int64)
        b1, b2 = threefry2x32(k1, k2, torch.zeros_like(ctr), ctr)
        out = torch.stack([b1, b2], dim=-1)
    else:
        out = _threefry_2x32_flat(k1, k2, torch.arange(2 * n, dtype=torch.int64)).reshape(n, 2)
    return out.numpy().astype(np.uint32).reshape(*shape, 2)


def _key_tensors(key: KeyLike, device) -> Tuple[UInt, UInt, Tuple[int, ...]]:
    """Key words ready to broadcast against a trailing counter axis: Python
    ints for one key, int64 ``(..., 1)`` tensors on ``device`` for a
    batch; and the batch shape."""
    a = key_data(key)
    if a.shape == (2,):
        return int(a[0]), int(a[1]), ()
    t = torch.as_tensor(a.astype(np.int64), device=device)
    return t[..., 0:1], t[..., 1:2], tuple(a.shape[:-1])


def random_bits(
    key: KeyLike,
    bit_width: int,
    shape: Sequence[int],
    *,
    partitionable: bool = True,
    device=None,
) -> torch.Tensor:
    """Uniform random ``bit_width``-bit words (8, 16 or 32) of ``shape``, as
    int64 values in ``[0, 2^bit_width)`` on ``device``.  A batch of keys
    (``(*B, 2)``) draws ``(*B, *shape)``, each key its own stream, as
    ``jax.vmap`` over the keys would.  Reference: ``jax._src.prng:
    threefry_random_bits``."""
    if bit_width not in (8, 16, 32):
        raise ValueError(f"bit_width must be 8, 16 or 32; got {bit_width}")
    shape = tuple(int(s) for s in shape)
    k1, k2, batch = _key_tensors(key, device)
    n = math.prod(shape)
    mask = (1 << bit_width) - 1
    if partitionable:
        if n >= 1 << 32:
            raise NotImplementedError("random bits of 2^32 or more elements")
        ctr = torch.arange(n, dtype=torch.int64, device=device)
        b1, b2 = threefry2x32(k1, k2, torch.zeros_like(ctr), ctr)
        bits = (b1 ^ b2) & mask
    else:
        per = 32 // bit_width
        count = -(-n // per)
        if count >= U32:
            raise NotImplementedError("random bits of 2^32 - 1 words or more")
        words = _threefry_2x32_flat(k1, k2, torch.arange(count, dtype=torch.int64, device=device))
        if per == 1:
            bits = words
        else:
            shifts = torch.arange(per, dtype=torch.int64, device=device) * bit_width
            bits = ((words[..., :, None] >> shifts) & mask).flatten(-2)[..., :n]
    return bits.reshape(*batch, *shape)


def _bitcast_float(bits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    nbits = _FINFO[dtype][0]
    return bits.to(_INT_VIEW[nbits]).view(dtype)


def uniform(
    key: KeyLike,
    shape: Sequence[int] = (),
    dtype: torch.dtype = torch.float32,
    minval: float = 0.0,
    maxval: float = 1.0,
    *,
    partitionable: bool = True,
    device=None,
) -> torch.Tensor:
    """Uniform draws in ``[minval, maxval)``: the top mantissa bits of a
    random word under the exponent of 1.0, minus 1, scaled, shifted and
    clamped to ``minval``, each step in ``dtype``.  Dtypes with fewer than
    8 mantissa bits (bf16) draw 8-bit words.  Reference:
    ``jax.random.uniform``."""
    if dtype not in _FINFO:
        raise TypeError(f"uniform supports {sorted(map(str, _FINFO))}; got {dtype}")
    nbits, nmant = _FINFO[dtype]
    rng_bits = 8 if nmant < 8 else nbits
    bits = random_bits(key, rng_bits, shape, partitionable=partitionable, device=device)
    one = int(torch.ones((), dtype=dtype).view(_INT_VIEW[nbits])) & ((1 << nbits) - 1)
    floats = _bitcast_float((bits >> (rng_bits - nmant)) | one, dtype) - 1.0
    lo = torch.full((), minval, dtype=dtype, device=floats.device)
    hi = torch.full((), maxval, dtype=dtype, device=floats.device)
    span = hi - lo
    if dtype == torch.float32:
        # XLA contracts the f32 ``floats * span + lo`` into one fused
        # multiply-add: the product exact in f64, then one rounding.
        y = (floats.to(torch.float64) * span.to(torch.float64) + lo.to(torch.float64)).to(dtype)
    else:
        y = floats * span + lo  # 16-bit types round after each op
    return torch.maximum(lo, y)


def gumbel(
    key: KeyLike,
    shape: Sequence[int] = (),
    dtype: torch.dtype = torch.float32,
    *,
    partitionable: bool = True,
    device=None,
) -> torch.Tensor:
    """Standard Gumbel draws ``-log(-log(u))``, ``u`` uniform on
    ``[tiny, 1)``, each op in ``dtype``.  Reference: ``jax.random.gumbel``
    in its default ``mode="low"``."""
    tiny = torch.finfo(dtype).tiny
    u = uniform(key, shape, dtype, tiny, 1.0, partitionable=partitionable, device=device)
    return -torch.log(-torch.log(u))


def categorical(
    key: KeyLike,
    logits: torch.Tensor,
    axis: int = -1,
    *,
    partitionable: bool = True,
) -> torch.Tensor:
    """Samples from ``softmax(logits)`` along ``axis`` by the Gumbel-max
    trick, the Gumbel noise drawn in the logits' own dtype.  With one key
    the noise has the logits' shape; with a batch of keys ``(B, 2)`` the
    logits are ``(B, V)`` and row ``b`` draws under key ``b``, as
    ``jax.vmap(categorical)`` over keys and rows does.  Reference:
    ``jax.random.categorical`` (``replace=True``, no ``shape``)."""
    a = key_data(key)
    if a.shape == (2,):
        g = gumbel(a, logits.shape, logits.dtype, partitionable=partitionable, device=logits.device)
    else:
        if logits.dim() != 2 or a.shape != (logits.shape[0], 2) or axis not in (-1, 1):
            raise ValueError(
                f"batched keys {a.shape} take (B, V) logits along the last axis; "
                f"got {tuple(logits.shape)}, axis={axis}"
            )
        g = gumbel(a, logits.shape[1:], logits.dtype, partitionable=partitionable, device=logits.device)
    return torch.argmax(g + logits, dim=axis)
