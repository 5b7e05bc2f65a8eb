"""The port's weight init from a threefry key against the reference's, on
the same keys: ``repro_torch.prng.normal`` / ``randint`` against
``jax.random``, and ``init_params(cfg, PRNGKey(0))`` against the
reference's ``init_tree`` for the smoke config of every registered arch.

Tolerances, fixed before the first run: everything bitwise.  ``normal``
reproduces XLA's CPU backend (its own f32 ``log`` / ``log1p`` and the FMAs
LLVM contracts); a draw in :data:`prng.CHUNK`-sized pieces is bitwise the
whole draw.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402
from jax._src import prng as jprng  # noqa: E402

from repro.models import registry as jreg  # noqa: E402
from repro.models.common import init_tree as jinit_tree  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models.common import init_params, reference_defs  # noqa: E402
from repro_torch.weights import params_to_reference  # noqa: E402


def _bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32).view(np.uint32)


def _mismatches(got: torch.Tensor, want) -> int:
    return int((_bits(got.numpy()) != _bits(want)).sum())


KEYS = {
    "PRNGKey(0)": (lambda: jax.random.PRNGKey(0), 1 << 20),
    "folded, odd length": (lambda: jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(3), 17), 2), (1 << 20) + 3),
}


@pytest.mark.parametrize("name", sorted(KEYS))
def test_normal_matches_jax_bitwise(name):
    make, n = KEYS[name]
    key = make()
    want = np.asarray(jax.random.normal(key, (n,)))
    got = prng.normal(np.asarray(key), (n,), device="cpu")
    assert got.dtype == torch.float32 and got.shape == (n,)
    assert _mismatches(got, want) == 0
    # a shaped draw is the flat draw reshaped
    np.testing.assert_array_equal(prng.normal(np.asarray(key), (4, 5), device="cpu").numpy(),
                                  np.asarray(jax.random.normal(key, (4, 5))))


def _around(x: float, ulps: int) -> np.ndarray:
    """``x`` and ``ulps`` f32 neighbours on each side, both signs."""
    out = [np.float32(x)]
    for direction in (np.inf, -np.inf):
        v = np.float32(x)
        for _ in range(ulps):
            v = np.nextafter(v, np.float32(direction))
            out.append(v)
    out = np.array(out, dtype=np.float32)
    return np.concatenate([out, -out])


def test_erf_inv_edges():
    edge = np.array([np.nextafter(np.float32(-1), np.float32(0)), 0.0, -0.0, 1.0, -1.0,
                     np.nextafter(np.float32(1), np.float32(0)), 1e-30, 1e-7], dtype=np.float32)
    w5 = np.sqrt(1.0 - np.exp(-5.0))  # w = -log1p(-x^2) crosses 5 here
    small = np.sqrt(np.sqrt(2.0) - 1.0)  # log1p's rational path ends at |x^2| = sqrt(2) - 1
    x = np.concatenate([edge, _around(w5, 200), _around(small, 200)])
    want = np.asarray(jax.jit(lax.erf_inv)(x))
    got = prng._erf_inv(torch.from_numpy(x))
    lg = prng._log1p(torch.from_numpy(-x * x))
    assert bool((lg > -5).any()) and bool((lg <= -5).any())  # both sides of w = 5
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    assert np.isinf(got.numpy()[[3, 4]]).all()


BOUNDS = [(-127, 128), (0, 10), (5, 3), (-(2**31), 2**31 - 1), (-1000, 70000)]


@pytest.mark.parametrize("lo,hi", BOUNDS, ids=[f"{a}_{b}" for a, b in BOUNDS])
def test_randint_matches_jax(lo, hi):
    key = jax.random.fold_in(jax.random.PRNGKey(4), 9)
    want = np.asarray(jax.random.randint(key, (3, 1001), lo, hi, jnp.int32))
    got = prng.randint(np.asarray(key), (3, 1001), lo, hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_counter_high_word_matches_threefry_2x32():
    """Flat indices from 2^32 on: the counter's high word is 1, as JAX's
    64-bit iota makes it."""
    key = jax.random.fold_in(jax.random.PRNGKey(1), 5)
    n = 1001
    count = jnp.concatenate([jnp.ones(n, jnp.uint32), jnp.arange(n, dtype=jnp.uint32)])
    out = np.asarray(jprng.threefry_2x32(key, count)).astype(np.int64)
    k1, k2 = (int(v) for v in np.asarray(key))
    got = prng._block_bits(k1, k2, 2**32, 2**32 + n, "cpu")
    np.testing.assert_array_equal(got.numpy(), out[:n] ^ out[n:])


DRAWS = {
    "random_bits": lambda k: prng.random_bits(k, 32, (4099,), device="cpu"),
    "random_bits batched keys": lambda k: prng.random_bits(prng.split(k, 3), 8, (4099,), device="cpu"),
    "uniform bf16": lambda k: prng.uniform(k, (4099,), torch.bfloat16, device="cpu"),
    "normal": lambda k: prng.normal(k, (4099,), device="cpu"),
    "randint": lambda k: prng.randint(k, (4099,), -127, 128),
}


@pytest.mark.parametrize("name", sorted(DRAWS))
def test_chunked_draw_is_the_whole_draw(name, monkeypatch):
    key = prng.fold_in(prng.PRNGKey(6), 1)
    whole = DRAWS[name](key)
    monkeypatch.setattr(prng, "CHUNK", 1000)
    chunked = DRAWS[name](key)
    assert torch.equal(whole.view(torch.uint8) if whole.is_floating_point() else whole,
                       chunked.view(torch.uint8) if chunked.is_floating_point() else chunked)


def _flat(tree, pre=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], pre + (k,))
    else:
        yield "/".join(pre), tree


@pytest.mark.parametrize("name", treg.names())
def test_init_params_from_key_matches_init_tree(name):
    jarch, tarch = jreg.get(name), treg.get(name)
    jcfg, tcfg = jarch.smoke_config, tarch.smoke_config
    want = dict(_flat(jinit_tree(jarch.param_defs(jcfg), jax.random.PRNGKey(0), jcfg.param_dtype)))
    tree = init_params(tcfg, prng.PRNGKey(0), "cpu")
    got = dict(_flat(params_to_reference(tree)))
    assert got.keys() == want.keys()
    raw = dict(_flat(reference_defs(tarch.param_defs(tcfg))))
    assert raw.keys() == want.keys()
    for path, w in want.items():
        w = np.asarray(w)
        g = got[path]
        assert g.shape == w.shape, path
        if w.dtype == jnp.bfloat16:  # params_to_reference widens bf16 to f32 exactly
            w = w.astype(np.float32)
        assert g.dtype == w.dtype, path
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8), err_msg=path)
