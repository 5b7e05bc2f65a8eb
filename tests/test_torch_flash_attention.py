"""The port's flash-attention kernel module against the JAX reference.

* the plain twin and ``ops.flash_attention`` against the reference's
  ``flash_attention`` (its Pallas kernel in interpret mode on the CPU) and
  against the exact-softmax oracles, over GQA ratios 1, 2 and 7, causal and
  not, ``q_offset > 0``, ``kv_valid < Tk`` and lengths off the blocks;
* the CPU route takes the twin and counts no launch;
* the bf16 gate of the CUDA kernel, ``ref.oracle_and_bound``: its f64
  oracle against the reference kernel, the twin within the bound at every
  element, and two negative controls that must fail it (P rounded to one
  bf16 term before P.V; the causal mask shifted by one key);
* on a card, the CUDA kernel (skips without one): the served shapes,
  hd=128, every key masked, one query and key, a query offset, lengths off
  the CTA's rows and off the key blocks; and the one-term-P control at the
  ``lm_logits`` shape.

JAX is imported by the tests that compare with it (the ``jx`` fixture), so
the ``cuda``-marked test also runs where JAX is not installed, as on the
machine with the card: ``python -m pytest -m cuda
tests/test_torch_flash_attention.py``.

f32 is held at ``rtol = atol = 2e-5``, the reference's own tolerance for
its flash core (``tests/test_fused_hotpath.py``): both sides run the same
online softmax over the same key blocks, and only the order of the sums
inside a block differs.  The twin's bf16 outputs are held within one bf16
ulp of the reference's: both round an f32 result that agrees to ~1e-7,
which can flip a last bit.  The CUDA kernel's bf16 outputs sum on the
tensor cores in another order than the twin, so they are held instead to
the f64 oracle within the forward-error bound of f32 summation
(``ref.oracle_and_bound``, whose constants are fixed): the reference's own
bf16 contract is ``2e-2`` against its oracle (``tests/test_flash_attention.py``).
"""

import types
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import kernel as F  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref,
    bf16_ulp,
    gate_ratio,
    oracle_and_bound,
)
from repro_torch.photonic.flash import flash_attention as surface_flash  # noqa: E402

CASES = [
    # (B, Tq, Tk, H, KV, hd, causal, q_offset, kv_valid, bq, bk)
    (2, 37, 37, 4, 4, 16, True, 0, None, 16, 16),  # n_rep 1, ragged edge
    (1, 9, 53, 14, 2, 16, True, 44, None, 8, 16),  # n_rep 7, q_offset
    (2, 20, 40, 4, 2, 8, False, 0, 29, 8, 16),  # n_rep 2, kv_valid < Tk
    (1, 64, 64, 7, 1, 16, True, 0, None, 32, 32),  # n_rep 7, exact blocks
    (2, 30, 50, 4, 2, 16, False, 0, None, 128, 128),  # default blocks (cut to T)
    (1, 24, 100, 6, 3, 16, True, 76, 90, 8, 32),  # n_rep 2, offset and kv_valid
]
IDS = [f"B{c[0]}-Tq{c[1]}-Tk{c[2]}-H{c[3]}-KV{c[4]}-{'causal' if c[6] else 'full'}-qo{c[7]}-kv{c[8]}" for c in CASES]


@pytest.fixture(scope="module")
def jx():
    """The reference's flash core and oracle (JAX on the CPU)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels.flash_attention.ops import flash_attention
    from repro.kernels.flash_attention.ref import attention_ref

    return types.SimpleNamespace(jnp=jnp, flash=flash_attention, ref=attention_ref)


def _inputs(case, dtype, jnp):
    b, tq, tk, h, kv, hd = case[:6]
    rng = np.random.default_rng(zlib.crc32(repr(case).encode()))
    arrs = [rng.normal(size=s).astype(np.float32) for s in ((b, tq, h, hd), (b, tk, kv, hd), (b, tk, kv, hd))]
    if dtype == "bf16":
        j = [jnp.asarray(a, jnp.bfloat16) for a in arrs]
        t = [torch.from_numpy(a).to(torch.bfloat16) for a in arrs]
        # the same bf16 values on both sides
        assert all(np.array_equal(np.asarray(x, np.float32), y.float().numpy()) for x, y in zip(j, t))
    else:
        j = [jnp.asarray(a) for a in arrs]
        t = [torch.from_numpy(a) for a in arrs]
    return j, t


def _kw(case):
    _, _, _, _, _, _, causal, q_offset, kv_valid, bq, bk = case
    return dict(causal=causal, q_offset=q_offset, kv_valid=kv_valid, bq=bq, bk=bk)


def _assert_bf16_within_one_ulp(got: np.ndarray, want: np.ndarray):
    got, want = torch.tensor(got), torch.tensor(want)
    ulp = torch.maximum(bf16_ulp(want), bf16_ulp(got))
    assert bool(((got - want).abs() <= ulp).all()), float(((got - want).abs() / ulp).max())


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ops_flash_attention_matches_reference_flash(jx, case, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(case, dtype, jx.jnp)
    want = np.asarray(jx.flash(jq, jk, jv, **_kw(case)).astype(jx.jnp.float32))
    got = flash_attention(tq, tk, tv, **_kw(case))
    assert got.dtype == tq.dtype and tuple(got.shape) == tuple(tq.shape)
    got = got.float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    else:
        _assert_bf16_within_one_ulp(got, want)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_twin_matches_exact_softmax_oracles(jx, case):
    (jq, jk, jv), (tq, tk, tv) = _inputs(case, "f32", jx.jnp)
    b, t_q, t_k, h, kv, hd, causal, q_offset, kv_valid, bq, bk = case
    twin = F.flash_attention_fwd_twin(
        tq, tk, tv, scale=hd**-0.5, causal=causal, q_offset=q_offset,
        kv_valid=t_k if kv_valid is None else kv_valid, n_rep=h // kv, bq=bq, bk=bk,
    ).numpy()
    oracle_kw = dict(causal=causal, q_offset=q_offset, kv_valid=kv_valid)
    port_ref = attention_ref(tq, tk, tv, **oracle_kw).numpy()
    jax_ref = np.asarray(jx.ref(jq, jk, jv, **oracle_kw))
    np.testing.assert_allclose(port_ref, jax_ref, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(twin, port_ref, rtol=2e-5, atol=2e-5)


def test_fully_masked_rows_follow_the_reference_kernel(jx):
    """kv_valid = 0 masks every key: the reference's online softmax then
    averages V over every key of every block it walks, zero padding
    included (not the exact oracle's uniform softmax over Tk)."""
    case = (1, 5, 13, 4, 2, 16, False, 0, 0, 8, 8)
    (jq, jk, jv), (tq, tk, tv) = _inputs(case, "f32", jx.jnp)
    want = np.asarray(jx.flash(jq, jk, jv, **_kw(case)))
    got = flash_attention(tq, tk, tv, **_kw(case)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    padded = np.pad(tv.numpy(), ((0, 0), (0, 3), (0, 0), (0, 0))).mean(axis=1)  # 16 keys, 13 real
    np.testing.assert_allclose(got[:, 0], np.repeat(padded, 2, axis=1), rtol=2e-5, atol=2e-5)


def _bf16_case(case):
    """bf16 inputs of ``case`` and the twin's arguments at the block sizes
    ``ops.flash_attention`` picks."""
    b, t_q, t_k, h, kv, hd, causal, q_offset, kv_valid, bq, bk = case
    rng = np.random.default_rng(zlib.crc32(repr(case).encode()))
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(torch.bfloat16)
               for s in ((b, t_q, h, hd), (b, t_k, kv, hd), (b, t_k, kv, hd)))
    args = dict(scale=hd**-0.5, causal=causal, q_offset=q_offset,
                kv_valid=t_k if kv_valid is None else kv_valid, n_rep=h // kv,
                bq=min(bq, -(-t_q // 8) * 8), bk=min(bk, -(-t_k // 8) * 8))
    o, bound = oracle_and_bound(q, k, v, scale=args["scale"], causal=causal, q_offset=q_offset,
                                kv_valid=args["kv_valid"], bk=args["bk"])
    return (q, k, v), args, o, bound


EMPTY_CASE = (1, 5, 13, 4, 2, 16, False, 0, 0, 8, 8)  # kv_valid = 0: no live key


@pytest.mark.parametrize("case", CASES + [EMPTY_CASE], ids=IDS + ["no-live-key"])
def test_oracle_matches_the_reference_kernel(jx, case):
    """The gate's f64 oracle is the reference kernel's function: exact
    softmax attention, and the mean of the padded V on rows with no live
    key."""
    (q, k, v), args, o, bound = _bf16_case(case)
    jq, jk, jv = (jx.jnp.asarray(t.float().numpy()) for t in (q, k, v))
    want = np.asarray(jx.flash(jq, jk, jv, **_kw(case)))
    np.testing.assert_allclose(o.numpy(), want, rtol=2e-5, atol=2e-5)
    assert o.dtype == bound.dtype == torch.float64 and bool((bound > 0).all())


@pytest.mark.parametrize("case", CASES + [EMPTY_CASE], ids=IDS + ["no-live-key"])
def test_twin_holds_the_f64_bound_in_bf16(case):
    (q, k, v), args, o, bound = _bf16_case(case)
    got = F.flash_attention_fwd_twin(q, k, v, **args)
    assert got.dtype == torch.bfloat16
    ratio = gate_ratio(got, o, bound)
    assert float(ratio.max()) <= 1.0, float(ratio.max())


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_one_bf16_term_of_p_fails_the_bound(case):
    """Negative control: P rounded to one bf16 term before P.V (8 bits of
    each weight) is beyond the bound somewhere in every case."""
    (q, k, v), args, o, bound = _bf16_case(case)
    ratio = gate_ratio(F.flash_attention_fwd_twin(q, k, v, **args, round_p=True), o, bound)
    assert float(ratio.max()) > 1.0


CAUSAL = [c for c in CASES if c[6]]


@pytest.mark.parametrize("case", CAUSAL, ids=[i for c, i in zip(CASES, IDS) if c[6]])
def test_causal_mask_shifted_by_one_key_fails_the_bound(case):
    """Negative control: each row seeing one key too many (q_offset + 1)
    is beyond the bound in every causal case."""
    (q, k, v), args, o, bound = _bf16_case(case)
    shifted = dict(args, q_offset=args["q_offset"] + 1)
    ratio = gate_ratio(F.flash_attention_fwd_twin(q, k, v, **shifted), o, bound)
    assert float(ratio.max()) > 1.0


def test_cpu_route_takes_the_twin_and_counts_no_launch():
    b, t_q, t_k, h, kv, hd = CASES[1][:6]
    rng = np.random.default_rng(0)
    tq, tk, tv = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                  for s in ((b, t_q, h, hd), (b, t_k, kv, hd), (b, t_k, kv, hd)))
    args = dict(scale=16**-0.5, causal=True, q_offset=44, kv_valid=53, n_rep=7, bq=8, bk=16)
    F.reset_launches()
    got = F.flash_attention_fwd(tq, tk, tv, **args)
    assert torch.equal(got, F.flash_attention_fwd_twin(tq, tk, tv, **args))
    assert torch.equal(surface_flash(tq, tk, tv, causal=True, q_offset=44, bq=8, bk=16), got)
    assert F.LAUNCHES == {"flash_attention": 0}  # the twin is no launch
    with pytest.raises(ValueError, match="CPU \\(twin\\) or CUDA"):
        F.flash_attention_fwd(tq.to("meta"), tk.to("meta"), tv.to("meta"), **args)
    with pytest.raises(ValueError, match="n_rep"):
        F.flash_attention_fwd(tq, tk, tv, **dict(args, n_rep=2))


def test_library_is_keyed_by_source_in_the_build_dir():
    from repro_torch.kernels import _build

    path = F.LIBRARY.path()
    assert path.parent == _build.build_dir() and path.name.startswith("flash_attention_")
    assert F.SOURCE.exists() and F.SOURCE.suffix == ".cu"


def _assert_within_f64_bound(got, q, k, v, args):
    """The CUDA kernel's bf16 output against the f64 oracle and bound of
    ``ref.oracle_and_bound`` (the tensor cores sum in another order than
    the twin)."""
    o, bound = oracle_and_bound(q, k, v, scale=args["scale"], causal=args["causal"],
                                q_offset=args["q_offset"], kv_valid=args["kv_valid"], bk=args["bk"])
    assert got.dtype == torch.bfloat16
    ratio = gate_ratio(got, o, bound)
    assert float(ratio.max()) <= 1.0, (float(ratio.max()), int((ratio > 1).sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("hd,dtype", [(64, "bf16"), (128, "bf16"), (64, "f32")])
def test_cuda_kernel_matches_twin(hd, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for b, tq, tk, h, kv, causal, q_offset, kv_valid in (
        (2, 100, 100, 14, 2, True, 0, 100), (1, 16, 300, 6, 3, True, 284, 300),
        (2, 77, 77, 4, 4, False, 0, 50),
    ):
        q = torch.randn((b, tq, h, hd), generator=gen, device="cuda").to(dt)
        k = torch.randn((b, tk, kv, hd), generator=gen, device="cuda").to(dt)
        v = torch.randn((b, tk, kv, hd), generator=gen, device="cuda").to(dt)
        args = dict(scale=hd**-0.5, causal=causal, q_offset=q_offset, kv_valid=kv_valid,
                    n_rep=h // kv, bq=min(128, -(-tq // 8) * 8), bk=min(128, -(-tk // 8) * 8))
        n0 = F.LAUNCHES["flash_attention"]
        got = F.flash_attention_fwd(q, k, v, **args)
        assert F.LAUNCHES["flash_attention"] == n0 + 1
        if dtype == "f32":
            want = F.flash_attention_fwd_twin(q, k, v, **args)
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=0, atol=2e-5)
        else:
            _assert_within_f64_bound(got, q, k, v, args)


# (label, B, Tq, Tk, H, KV, hd, causal, q_offset, kv_valid, bk)
CARD_EDGE_CASES = [
    ("hd128 ragged", 1, 70, 70, 4, 2, 128, True, 0, 70, 72),
    ("kv_valid=0", 1, 40, 56, 4, 2, 64, False, 0, 0, 56),
    ("Tq=Tk=1", 2, 1, 1, 14, 2, 64, True, 0, 1, 8),
    ("q_offset", 1, 16, 300, 6, 3, 64, True, 284, 300, 128),
    ("T=130 (not a multiple of the CTA rows)", 2, 130, 130, 14, 2, 64, True, 0, 130, 128),
    ("bk=40, three blocks", 1, 100, 100, 2, 1, 64, True, 0, 100, 40),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_EDGE_CASES, ids=[c[0] for c in CARD_EDGE_CASES])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_cuda_kernel_edge_cases(case, dtype):
    """The kernel at the edges of its tiling: hd=128, every key masked
    (kv_valid = 0), a single query and key, a query offset, lengths that
    are not a multiple of the CTAs' rows (32 in f32; 64 packed query x head
    rows in bf16) or key tiles, and logical key blocks that are not a
    multiple of 16 keys.  f32 against the twin, bf16 against the f64
    bound."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    label, b, tq, tk, h, kv, hd, causal, q_offset, kv_valid, bk = case
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    gen = torch.Generator(device="cuda")
    gen.manual_seed(len(label))
    q = torch.randn((b, tq, h, hd), generator=gen, device="cuda").to(dt)
    k = torch.randn((b, tk, kv, hd), generator=gen, device="cuda").to(dt)
    v = torch.randn((b, tk, kv, hd), generator=gen, device="cuda").to(dt)
    args = dict(scale=hd**-0.5, causal=causal, q_offset=q_offset, kv_valid=kv_valid,
                n_rep=h // kv, bq=min(128, -(-tq // 8) * 8), bk=bk)
    got = F.flash_attention_fwd(q, k, v, **args)
    assert bool(torch.isfinite(got.float()).all())
    if dtype == "f32":
        want = F.flash_attention_fwd_twin(q, k, v, **args)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=0, atol=2e-5)
    else:
        _assert_within_f64_bound(got, q, k, v, args)


@pytest.mark.cuda
def test_cuda_one_bf16_term_of_p_fails_the_bound():
    """At the ``lm_logits`` shape on the card, the kernel holds the bound
    and the twin with P rounded to one bf16 term does not."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    b, t, h, kv, hd = 2, 1000, 14, 2, 64
    q, k, v = (torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)
               for s in ((b, t, h, hd), (b, t, kv, hd), (b, t, kv, hd)))
    args = dict(scale=hd**-0.5, causal=True, q_offset=0, kv_valid=t, n_rep=h // kv, bq=128, bk=128)
    o, bound = oracle_and_bound(q, k, v, scale=args["scale"], causal=True, q_offset=0, kv_valid=t, bk=128)
    assert float(gate_ratio(F.flash_attention_fwd(q, k, v, **args), o, bound).max()) <= 1.0
    assert float(gate_ratio(F.flash_attention_fwd_twin(q, k, v, **args, round_p=True), o, bound).max()) > 1.0
