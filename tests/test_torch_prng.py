"""The port's threefry PRNG (``repro_torch.prng``) against the installed
``jax.random``, on the same keys.

Tolerances, fixed before the first run:

* keys (``PRNGKey``, ``fold_in``, ``split``) and ``random_bits``: bitwise;
* ``uniform``: bitwise (integer bit moves and one exact subtraction);
* ``gumbel``: bf16 bitwise; f32 within one ulp plus 2^-23 absolute
  (torch's and XLA's f32 ``log`` may round apart; near the outer log's
  zero, at ``-log(u)`` close to 1, XLA's result is accurate to an absolute
  error, not to an ulp of the tiny result);
* ``categorical``: equal on every row except rows whose top two Gumbel
  scores lie within 1e-5 relative of each other; the test reports their
  count (zero in every case here).

Every case runs under both settings of ``jax_threefry_partitionable``
(toggled and restored), the port's ``partitionable`` argument following
it, and with f32 and bf16 logits.  The known answers that
``chip_smoke.py`` embeds for the card (which has no JAX) are recomputed
here from JAX, so they cannot drift.
"""

import ast
import hashlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro_torch import prng  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
UINT = {8: jnp.uint8, 16: jnp.uint16, 32: jnp.uint32}


@pytest.fixture(params=[True, False], ids=["partitionable", "original"])
def part(request):
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", request.param)
    try:
        yield request.param
    finally:
        jax.config.update("jax_threefry_partitionable", old)


def _np(a):
    return np.asarray(a)


def test_known_answer_and_seeds():
    assert prng.fold_in(prng.PRNGKey(7), 3).tolist() == [276534068, 1641862660]
    for seed in (0, 1, 7, 2**31 - 1, -1, -5, 2**33 + 5):
        np.testing.assert_array_equal(prng.PRNGKey(seed), _np(jax.random.PRNGKey(seed)))
    assert prng.PRNGKey(3).dtype == np.uint32
    # key_data accepts the raw words of a typed JAX key, a tensor or a pair
    typed = jax.random.key(11)
    np.testing.assert_array_equal(prng.key_data(_np(jax.random.key_data(typed))), prng.PRNGKey(11))
    np.testing.assert_array_equal(prng.key_data(torch.tensor([0, 11])), prng.PRNGKey(11))


def test_fold_in_and_split(part):
    key = jax.random.PRNGKey(11)
    tk = prng.PRNGKey(11)
    for d in (0, 5, 2**31 - 1, 2**32 - 1):
        np.testing.assert_array_equal(prng.fold_in(tk, d), _np(jax.random.fold_in(key, d)))
    # A negative int32 folds through its uint32 image, as JAX converts it.
    np.testing.assert_array_equal(prng.fold_in(tk, -3), _np(jax.random.fold_in(key, jnp.int32(-3))))
    for num in (2, 3, 5, (2, 3)):
        np.testing.assert_array_equal(prng.split(tk, num, partitionable=part), _np(jax.random.split(key, num)))


@pytest.mark.parametrize("bits", [8, 16, 32])
def test_random_bits(part, bits):
    key = jax.random.fold_in(jax.random.PRNGKey(2), 9)
    for shape in ((7,), (3, 5), (1001,)):
        want = _np(jax.random.bits(key, shape, dtype=UINT[bits])).astype(np.int64)
        got = prng.random_bits(_np(key), bits, shape, partitionable=part, device="cpu")
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_uniform_and_gumbel(part, dt):
    jdt, tdt = DTYPES[dt]
    key = jax.random.PRNGKey(5)
    u = prng.uniform(_np(key), (4001,), tdt, partitionable=part)
    assert u.dtype == tdt
    np.testing.assert_array_equal(u.float().numpy(), _np(jax.random.uniform(key, (4001,), jdt).astype(jnp.float32)))
    u2 = prng.uniform(_np(key), (64,), tdt, -2.0, 3.0, partitionable=part)
    np.testing.assert_array_equal(
        u2.float().numpy(), _np(jax.random.uniform(key, (64,), jdt, -2.0, 3.0).astype(jnp.float32)))
    g = prng.gumbel(_np(key), (20001,), tdt, partitionable=part).float().numpy()
    want = _np(jax.random.gumbel(key, (20001,), jdt).astype(jnp.float32))
    if dt == "bf16":
        np.testing.assert_array_equal(g, want)
    else:
        ulp = np.spacing(np.abs(want).astype(np.float32))
        assert (np.abs(g - want) <= ulp + 2.0**-23).all()


def _near_ties(keys, logits_t, part):
    """Rows whose top two Gumbel scores lie within 1e-5 relative."""
    g = prng.gumbel(keys, logits_t.shape[-1:], logits_t.dtype, partitionable=part)
    s = (g + logits_t).float()
    top = torch.topk(s, 2, dim=-1).values
    return ((top[..., 0] - top[..., 1]).abs() <= 1e-5 * top[..., 0].abs()).numpy()


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_categorical_single_key_and_vmapped_rows(part, dt):
    jdt, tdt = DTYPES[dt]
    rng = np.random.default_rng(0)
    rows = (rng.standard_normal((32, 3001)) * 3).astype(np.float32)
    jr = jnp.asarray(rows).astype(jdt)
    # JAX divides by the temperature rounded to the logits' dtype (a weak
    # type); so do the port's samplers.
    tr = torch.from_numpy(rows).to(tdt)
    temp = torch.full((), 0.8, dtype=tdt)
    # One key over a (B, V) batch, as LegacyEngine draws.
    key = jax.random.PRNGKey(5)
    want = _np(jax.random.categorical(key, jr / 0.8, axis=-1))
    got = prng.categorical(_np(key), tr / temp, axis=-1, partitionable=part).numpy()
    np.testing.assert_array_equal(got, want)
    # One key per row under jit(vmap), as the paged Scheduler draws.
    base = jax.random.PRNGKey(3)
    uids = np.arange(32, dtype=np.int32) * 7 + 1
    ns = np.arange(32, dtype=np.int32) % 5

    def sample(r, u, n):
        keys = jax.vmap(lambda a, b: jax.random.fold_in(jax.random.fold_in(base, a), b))(u, n)
        return jax.vmap(lambda k, row: jax.random.categorical(k, row / 0.8))(keys, r)

    want = _np(jax.jit(sample)(jr, jnp.asarray(uids), jnp.asarray(ns)))
    tkeys = np.stack([prng.fold_in(prng.fold_in(prng.PRNGKey(3), int(u)), int(n)) for u, n in zip(uids, ns)])
    got = prng.categorical(tkeys, tr / temp, partitionable=part).numpy()
    ties = _near_ties(tkeys, tr / temp, part)
    print(f"categorical {dt}: {int(ties.sum())} of {len(ties)} rows within 1e-5 of a tie")
    np.testing.assert_array_equal(got[~ties], want[~ties])


def _chip_smoke_constants() -> dict:
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "KEY_ANSWERS" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError("chip_smoke.py has no KEY_ANSWERS")


def test_chip_smoke_known_answers_are_jax_s():
    """The constants the card's keys and init phases check, recomputed from
    JAX.  The init digests draw the reference's ``init_tree`` of full-width
    qwen2-0.5b (494,032,768 bf16 elements, about 1 GB held; about 10-20 s
    on a CPU)."""
    c = _chip_smoke_constants()
    assert jax.config.jax_threefry_partitionable
    key = jax.random.PRNGKey(c["seed"])
    assert c["fold_in"] == _np(jax.random.fold_in(key, c["fold"])).tolist()
    assert c["split"] == _np(jax.random.split(key, 3)).tolist()
    for bits in (8, 16, 32):
        assert c[f"bits{bits}"] == _np(jax.random.bits(key, (c["n_bits"],), dtype=UINT[bits])).astype(int).tolist()
    u = _np(jax.random.uniform(key, (c["n_bits"],), jnp.float32)).view(np.uint32).astype(int).tolist()
    assert c["uniform_f32_bits"] == u
    # categorical of a bf16 row of 151,936 logits (qwen2's vocabulary),
    # at temperature 0.8, under fold_in(fold_in(PRNGKey(seed), uid), n).
    row = jnp.asarray(np.random.default_rng(c["row_seed"]).standard_normal(c["vocab"]).astype(np.float32) * 3)
    row = row.astype(jnp.bfloat16)
    draws = []
    for uid, n in c["uid_n"]:
        k = jax.random.fold_in(jax.random.fold_in(key, uid), n)
        draws.append(int(jax.random.categorical(k, row / 0.8)))
    assert c["categorical"] == draws
    # and the port gives the same answers on the CPU
    tk = prng.PRNGKey(c["seed"])
    tr = torch.from_numpy(np.random.default_rng(c["row_seed"]).standard_normal(c["vocab"]).astype(np.float32) * 3)
    tr = tr.to(torch.bfloat16) / torch.full((), 0.8, dtype=torch.bfloat16)
    keys = np.stack([prng.fold_in(prng.fold_in(tk, u), n) for u, n in c["uid_n"]])
    assert prng.categorical(keys, tr[None, :].expand(len(keys), -1)).tolist() == draws
    # the weight init's draws: f32 normal bits, 2^20 of them hashed, int8 randint
    n = c["n_bits"]
    assert c["normal_f32_bits"] == _np(jax.random.normal(key, (n,))).view(np.uint32).astype(int).tolist()
    assert c["normal_sha256"] == hashlib.sha256(_np(jax.random.normal(key, (c["n_normal"],))).tobytes()).hexdigest()
    assert c["randint8"] == _np(jax.random.randint(key, (n,), -127, 128, jnp.int32).astype(jnp.int8)).astype(int).tolist()
    assert (prng.normal(tk, (n,)).view(torch.int32).numpy().view(np.uint32).astype(int).tolist()
            == c["normal_f32_bits"])
    assert prng.randint(tk, (n,), -127, 128).to(torch.int8).tolist() == c["randint8"]
    # each leaf of the reference's init_tree of full-width qwen2-0.5b under PRNGKey(0)
    from repro.models import registry
    from repro.models.common import init_tree

    arch = registry.get("qwen2-0.5b")
    tree = init_tree(arch.param_defs(arch.config), jax.random.PRNGKey(0), arch.config.param_dtype)
    digests = {}
    stack = [((), tree)]
    while stack:
        path, node = stack.pop()
        if isinstance(node, dict):
            stack.extend((path + (k,), v) for k, v in node.items())
        else:
            digests["/".join(path)] = hashlib.sha256(_np(node).view(np.uint8).tobytes()).hexdigest()
    assert c["qwen2_init_sha256"] == digests
