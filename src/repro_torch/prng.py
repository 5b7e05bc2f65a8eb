"""JAX's ``threefry2x32`` PRNG, bit for bit, in PyTorch.

Port of the key discipline of ``jax.random`` (``jax._src.prng`` and
``jax._src.random``) that the reference threads through its noise streams
and its samplers and weight init: ``PRNGKey``, ``fold_in``, ``split``,
``random_bits``, ``uniform``, ``normal``, ``randint``, ``gumbel`` and
``categorical`` on the default ``threefry2x32`` implementation.

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
two words (drawn :data:`CHUNK` elements at a time) and makes ``split`` a
vector of ``fold_in``s; ``False`` is the
0.4.x scheme (one flat counter halved across the two words, 8/16-bit
draws packed little-endian into 32-bit words).

``normal`` reproduces the bits of XLA's CPU backend, the reference's
platform: its own f32 ``log`` and ``log1p`` and the FMAs that LLVM
contracts, spelled in IEEE operations that round alike on every device.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Sequence, Tuple, Union

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


# Elements a partitionable draw computes at once: its int64 and f64
# temporaries stay near 32 MiB each whatever the draw's size.
CHUNK = 1 << 22


def _mapped(
    keys: Sequence[KeyLike],
    bit_width: int,
    shape: Sequence[int],
    dtype: torch.dtype,
    fn: Callable[..., torch.Tensor],
    *,
    partitionable: bool,
    device,
) -> torch.Tensor:
    """``fn`` of the ``bit_width``-bit words that each of ``keys`` draws
    for ``shape`` (all keys of one batch shape), as a ``dtype`` tensor.
    On the partitionable path the flat index range is drawn in pieces of
    :data:`CHUNK` elements, each counter the 64-bit flat index split into
    two words as ``jax._src.prng:iota_2x32_shape`` does; ``fn`` is
    elementwise, so a chunked draw is bitwise the whole draw."""
    if bit_width not in (8, 16, 32):
        raise ValueError(f"bit_width must be 8, 16 or 32; got {bit_width}")
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if not partitionable:
        return fn(*(_original_bits(k, bit_width, shape, device) for k in keys))
    if n > 1 << 64:
        raise NotImplementedError("random bits of more than 2^64 elements")
    words = [_key_tensors(k, device) for k in keys]
    batch = words[0][2]
    mask = (1 << bit_width) - 1
    out = torch.empty(batch + (n,), dtype=dtype, device=device)
    for start in range(0, n, CHUNK):
        stop = min(n, start + CHUNK)
        out[..., start:stop] = fn(*(_block_bits(k1, k2, start, stop, device) & mask for k1, k2, _ in words))
    return out.reshape(batch + shape)


def _block_bits(k1: UInt, k2: UInt, start: int, stop: int, device) -> torch.Tensor:
    """The partitionable path's 32-bit words of flat indices ``[start,
    stop)``: the XOR of the two words of the block of each index, split
    into a high and a low word (``jax._src.prng:iota_2x32_shape``)."""
    i = torch.arange(start, stop, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(k1, k2, i >> 32, i & U32)
    return b1 ^ b2


def _original_bits(key: KeyLike, bit_width: int, shape: Tuple[int, ...], device) -> torch.Tensor:
    """The 0.4.x scheme: one flat counter halved across the two words,
    8/16-bit draws packed little-endian into 32-bit words."""
    k1, k2, batch = _key_tensors(key, device)
    n = math.prod(shape)
    per = 32 // bit_width
    count = -(-n // per)
    if count >= U32:
        raise NotImplementedError("random bits of 2^32 - 1 words or more")
    words = _threefry_2x32_flat(k1, k2, torch.arange(count, dtype=torch.int64, device=device))
    if per == 1:
        bits = words
    else:
        mask = (1 << bit_width) - 1
        shifts = torch.arange(per, dtype=torch.int64, device=device) * bit_width
        bits = ((words[..., :, None] >> shifts) & mask).flatten(-2)[..., :n]
    return bits.reshape(*batch, *shape)


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
    return _mapped([key], bit_width, shape, torch.int64, lambda b: b, partitionable=partitionable, device=device)


def _bitcast_float(bits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    nbits = _FINFO[dtype][0]
    return bits.to(_INT_VIEW[nbits]).view(dtype)


def _uniform_of(bits: torch.Tensor, rng_bits: int, dtype: torch.dtype, minval: float, maxval: float) -> torch.Tensor:
    nbits, nmant = _FINFO[dtype]
    one = int(torch.ones((), dtype=dtype).view(_INT_VIEW[nbits])) & ((1 << nbits) - 1)
    floats = _bitcast_float((bits >> (rng_bits - nmant)) | one, dtype) - 1.0
    lo = torch.full((), minval, dtype=dtype, device=floats.device)
    hi = torch.full((), maxval, dtype=dtype, device=floats.device)
    span = hi - lo
    if dtype == torch.float32:
        y = _fma(floats, span, lo)  # XLA contracts the f32 ``floats * span + lo``
    else:
        y = floats * span + lo  # 16-bit types round after each op
    return torch.maximum(lo, y)


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
    return _mapped([key], rng_bits, shape, dtype, lambda b: _uniform_of(b, rng_bits, dtype, minval, maxval),
                   partitionable=partitionable, device=device)


def _fma(a: torch.Tensor, b: torch.Tensor, c: Union[torch.Tensor, float]) -> torch.Tensor:
    """``a * b + c`` in f32 with one rounding, as the FMA that LLVM
    contracts an f32 multiply and add into (operands f32 values, in f32 or
    already widened to f64).  The product is exact in f64;
    the f64 sum is rounded to odd (its own rounding error, from TwoSum,
    moves an even sum one f64 ulp towards the exact value), and an f64
    value rounded to odd rounds to f32 as the exact value would (53 >= 24
    + 2 bits)."""
    p = a.double() * b.double()
    c = (c if isinstance(c, torch.Tensor) else _f32(c, p)).double()
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)
    bits = s.view(torch.int64)
    inexact_even = (err != 0) & ((bits & 1) == 0)
    outward = (err > 0) == (s > 0)  # the exact value lies further from zero
    step = torch.where(outward, 1, -1) * inexact_even
    return (bits + step).view(torch.float64).float()


@functools.lru_cache(maxsize=None)
def _const(v: float, device: torch.device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    """``v`` rounded to f32, a 0-dim tensor on ``like``'s device."""
    return _const(float(v), like.device)


_SQRT2 = float(np.float32(math.sqrt(2.0)))
# XLA CPU's f32 log (Cephes' logf): the mantissa in [sqrt(1/2), sqrt(2)) as
# 1 + f, a degree-9 polynomial in f evaluated in three interleaved strands,
# and the exponent times ln 2 split into 0.693359375 - 2.12194440e-4.
_LOG_P = ((0.07037683576345444, -0.11514610052108765, 0.11676998436450958),
          (-0.12420140951871872, 0.14249323308467865, -0.16668057441711426),
          (0.2000071406364441, -0.24999994039535522, 0.3333333134651184))
_LOG_LN2 = (-0.00021219444170128554, 0.693359375)
# XLA's log1p for |x| < sqrt(2) - 1: Cephes' rational x - x^2/2 + x^3 P(x)/Q(x).
_LOG1P_Q = (15.062909126281738, 83.04756927490234, 221.7624053955078, 309.0987243652344,
            216.42788696289062, 60.11865997314453)
_LOG1P_P = (4.527000055531971e-05, 0.4985410273075104, 6.578732490539551, 29.91191864013672,
            60.949668884277344, 57.11296463012695, 20.039552688598633)
# Giles' single-precision erfinv: (w < 5, w >= 5) coefficient pairs, highest first.
_ERF_INV = ((2.81022636e-08, -0.000200214257), (3.43273939e-07, 0.000100950558),
            (-3.5233877e-06, 0.00134934322), (-4.39150654e-06, -0.00367342844),
            (0.00021858087, 0.00573950773), (-0.00125372503, -0.0076224613),
            (-0.00417768164, 0.00943887047), (0.246640727, 1.00167406), (1.50140941, 2.83297682))


def _div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 ``a / b`` correctly rounded on every device: the f64 quotient
    rounded once more loses nothing (53 >= 2 x 24 + 2 bits)."""
    return (a.double() / b.double()).float()


def _sqrt(a: torch.Tensor) -> torch.Tensor:
    """f32 ``sqrt`` correctly rounded on every device (torch's vectorized
    f32 ``sqrt`` on the CPU is not), by way of f64 as :func:`_div`."""
    return torch.sqrt(a.double()).float()


def _log(t: torch.Tensor) -> torch.Tensor:
    """XLA CPU's f32 ``log``, op for op as it compiles (x86-64 with FMA)."""
    bits = torch.clamp_min(t, torch.finfo(torch.float32).tiny).view(torch.int32)
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)  # mantissa in [1/2, 1)
    e = ((bits >> 23) - 127).float() + 1.0
    low = m < _f32(0.7071067690849304, t)
    f = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    e = torch.where(low, e - 1.0, e)
    z = f * f
    f3 = z * f
    (a0, a1, a2), (b0, b1, b2), (c0, c1, c2) = _LOG_P
    f64, f3_64 = f.double(), f3.double()
    pa = _fma(_fma(f64, _f32(a0, t), a1), f64, a2)
    pb = _fma(_fma(f64, _f32(b0, t), b1), f64, b2)
    pc = _fma(_fma(f64, _f32(c0, t), c1), f64, c2)
    q = _fma(f3_64, _fma(f3_64, pa, pb), pc)
    r = _fma(q, f3_64, e * _f32(_LOG_LN2[0], t))
    y = _fma(_f32(-0.5, t), z, f) + r
    y = _fma(e, _f32(_LOG_LN2[1], t), y)
    y = torch.where(t == 0, _f32(-math.inf, t), y)
    return torch.where(t >= 0, y, _f32(math.nan, t))


def _log1p(a: torch.Tensor) -> torch.Tensor:
    """XLA CPU's f32 ``log-plus-one``: ``log(a + 1)``, or for
    ``|a| < sqrt(2) - 1`` a Cephes rational, with the FMAs its compiled
    code contracts."""
    a2 = a * a
    zero = a * 0.0
    a64 = a.double()
    den = zero + 1.0
    for c in _LOG1P_Q:
        den = _fma(den, a64, c)
    num = zero + _f32(_LOG1P_P[0], a)
    for c in _LOG1P_P[1:]:
        num = _fma(num, a64, c)
    v = _fma(a2, _f32(-0.5, a), (a * a2) * _div(num, den))
    return torch.where(a.abs() < _f32(0.4142135679721832, a), a + v, _log(a + 1.0))


def _erf_inv(x: torch.Tensor) -> torch.Tensor:
    """``lax.erf_inv`` of f32 ``x`` as XLA CPU computes it: Giles'
    single-precision polynomial in ``w = -log1p(-x^2)``, each Horner step
    one FMA, ``x * inf`` where ``|x| == 1``."""
    lg = _log1p((-x) * x)
    near = lg > _f32(-5.0, x)  # w < 5
    w = torch.where(near, _f32(-2.5, x) - lg, _sqrt(-lg) - 3.0).double()
    coef = [torch.where(near, _f32(c, x).double(), _f32(d, x).double()) for c, d in _ERF_INV]
    p = _fma(coef[0], w, coef[1])
    for c in coef[2:]:
        p = _fma(w, p, c)
    return x * torch.where(x.abs() == 1.0, _f32(math.inf, x), p)


def normal(
    key: KeyLike,
    shape: Sequence[int] = (),
    dtype: torch.dtype = torch.float32,
    *,
    partitionable: bool = True,
    device=None,
) -> torch.Tensor:
    """Standard normal f32 draws: ``sqrt(2) * erf_inv(u)``, ``u`` uniform
    on ``[nextafter(-1, 0), 1)``, bit for bit as XLA's CPU backend
    computes them.  Reference: ``jax._src.random:_normal_real``."""
    if dtype != torch.float32:
        raise TypeError(f"normal draws float32; got {dtype}")
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))

    def fn(bits):
        return _erf_inv(_uniform_of(bits, 32, torch.float32, lo, 1.0)) * _f32(_SQRT2, bits)

    return _mapped([key], 32, shape, torch.float32, fn, partitionable=partitionable, device=device)


def _urem(a: UInt, span: int) -> UInt:
    """uint32 ``rem`` as XLA defines it: by zero, the dividend."""
    return a % span if span else a


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """uint32 ``a * b`` modulo 2^32 without overflowing int64: ``b`` in
    16-bit halves."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & U32


def randint(
    key: KeyLike,
    shape: Sequence[int],
    minval: int,
    maxval: int,
    dtype: torch.dtype = torch.int32,
    *,
    partitionable: bool = True,
    device=None,
) -> torch.Tensor:
    """Integers in ``[minval, maxval)`` of ``shape``: two 32-bit words per
    element under the two halves of ``split(key)``, folded into the span
    by uint32 remainders (``2^32 % span`` as the square of
    ``2^16 % span``), emulated in int64.  Reference:
    ``jax._src.random:_randint``."""
    if dtype != torch.int32:
        raise TypeError(f"randint draws int32; got {dtype}")
    info = torch.iinfo(dtype)
    lo, hi = (min(max(int(v), info.min), info.max) for v in (minval, maxval))
    span = (hi - lo) & U32
    if hi <= lo:
        span = 1
    elif int(maxval) > info.max:
        span = (span + 1) & U32
    mult = _urem(_urem(1 << 16, span) ** 2 & U32, span)

    def fn(high, low):
        off = _urem((_mul32(_urem(high, span), mult) + _urem(low, span)) & U32, span)
        v = (off + lo) & U32
        return (v - ((v >> 31) << 32)).to(dtype)

    k1, k2 = split(key, 2, partitionable=partitionable)
    return _mapped([k1, k2], 32, shape, dtype, fn, partitionable=partitionable, device=device)


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
