"""``prng_key`` through the port against the reference, with the same key.

A key wins over ``DPUConfig.noise_seed`` wherever noise is drawn, and the
samplers draw the reference's tokens.  Held here, on the same numpy
inputs and the same key on both sides:

* ``seed_from_key`` of raw and typed keys, ``DPUConfig.noise_seed_array``
  and ``noise_sigma_from_snr``: bitwise;
* ``PhotonicEngine.stream_seed`` with a key (site, layer, plane folded as
  ``jax.random.fold_in``): bitwise;
* ``dpu_int_gemm`` / ``photonic_matmul``, ``PhotonicEngine.int_gemm`` and
  ``matmul`` (prepacked) on the ``kernel`` (twin) and ``ref`` backends,
  bit-sliced calls under the ideal, SMWA and ASMW channels, and
  ``models.common.dense(prng_key=)``: the tiers of the existing engine
  tests — ideal bitwise; under noise the psums may round one LSB apart at
  <= 1% of elements (ulp-close Box-Muller draws; the reference's
  interpret mode contracts crosstalk adds into an FMA), sliced by at most
  two LSBs of the top plane pass; float outputs within 1e-5 relative (the
  bias tail's FMA contraction) except at <= 1% of elements, those within
  1e-2 of the output's max;
* the paged ``Scheduler`` and the one-shot ``LegacyEngine`` at
  temperature 0.8: tokens equal the reference's.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import dpu as jdpu  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models.common import init_tree  # noqa: E402
from repro.noise import stages as jst  # noqa: E402
from repro.noise.channel import build_channel_model as jbuild  # noqa: E402
from repro.photonic import engine_for as jengine_for  # noqa: E402
from repro.photonic.packing import pack_dense as jpack  # noqa: E402
from repro.runtime import serve as jserve  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import Scheduler as JScheduler  # noqa: E402
from repro.serving import ServingConfig as JServingConfig  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import dpu as tdpu  # noqa: E402
from repro_torch.models import common as tcm  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.noise import stages as tst  # noqa: E402
from repro_torch.noise.channel import build_channel_model as tbuild  # noqa: E402
from repro_torch.photonic import SlicingSpec, engine_for  # noqa: E402
from repro_torch.photonic.packing import pack_dense as tpack  # noqa: E402
from repro_torch.runtime import serve as tserve  # noqa: E402
from repro_torch.serving import Request as TRequest  # noqa: E402
from repro_torch.serving import Scheduler as TScheduler  # noqa: E402
from repro_torch.serving import ServingConfig as TServingConfig  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

BACKEND = {"kernel": "pallas", "ref": "ref"}
JKEY, TKEY = jax.random.PRNGKey(21), prng.PRNGKey(21)


def _dpus(org="SMWA", n=64, seed=3):
    if org == "ideal":
        return jdpu.DPUConfig(organization="SMWA", bits=4, dpe_size=16), tdpu.DPUConfig(
            organization="SMWA", bits=4, dpe_size=16)
    return (
        jdpu.DPUConfig(organization=org, bits=4, dpe_size=n, channel=jbuild(org, n=n, bits=4), noise_seed=seed),
        tdpu.DPUConfig(organization=org, bits=4, dpe_size=n, channel=tbuild(org, n=n, bits=4), noise_seed=seed),
    )


def _ints(seed=1, r=9, k=72, c=40):
    rng = np.random.default_rng(seed)
    return rng.integers(-127, 128, (r, k)).astype(np.int8), rng.integers(-127, 128, (k, c)).astype(np.int8)


def _psum_tier(got, want, lsb_max):
    d = np.abs(np.asarray(got, np.int64) - np.asarray(want, np.int64))
    assert (d > 0).mean() <= 0.01 and d.max() <= lsb_max, (int((d > 0).sum()), int(d.max()))


def _float_tier(got, want):
    """Outside the bias tail's 1e-5 relative, at most 1% of elements (a
    psum one LSB apart), each within 1e-2 of the output's max."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d = np.abs(got - want)
    assert (d > 1e-5 * np.abs(want) + 1e-6).mean() <= 0.01
    assert d.max() <= 1e-2 * np.abs(want).max()


def test_seed_from_key_noise_seed_array_and_sigma():
    for key in (jax.random.PRNGKey(0), jax.random.PRNGKey(2**31 - 1), jax.random.fold_in(JKEY, 9)):
        want = int(jst.seed_from_key(key))
        assert tst.seed_from_key(np.asarray(key)) == want
        assert tst.seed_from_key(torch.from_numpy(np.asarray(key).astype(np.int64))) == want
    typed = jax.random.key(4)
    assert tst.seed_from_key(prng.key_data(np.asarray(jax.random.key_data(typed)))) == int(jst.seed_from_key(typed))
    jd, td = _dpus()
    assert td.noise_seed_array(TKEY) == int(jd.noise_seed_array(JKEY))  # the key wins
    assert td.noise_seed_array(None) == int(jd.noise_seed_array(None)) == 3
    with pytest.raises(ValueError, match="pass prng_key or set"):
        dataclasses.replace(td, noise_seed=None).noise_seed_array(None)
    for org, n in (("SMWA", None), ("ASMW", 16)):
        assert tdpu.noise_sigma_from_snr(tdpu.DPUConfig(organization=org, dpe_size=n)) == jdpu.noise_sigma_from_snr(
            jdpu.DPUConfig(organization=org, dpe_size=n))


@pytest.mark.parametrize("org", ["SMWA", "ASMW"])
def test_dpu_int_gemm_and_photonic_matmul_with_a_key(org):
    jd, td = _dpus(org, n=16, seed=5)
    xq, wq = _ints(2, 12, 40, 24)
    want = jdpu.dpu_int_gemm(jnp.asarray(xq), jnp.asarray(wq), jd, prng_key=JKEY)
    got = tdpu.dpu_int_gemm(torch.from_numpy(xq), torch.from_numpy(wq), td, prng_key=TKEY)
    seeded = tdpu.dpu_int_gemm(torch.from_numpy(xq), torch.from_numpy(wq), td)
    assert not torch.equal(got, seeded)  # the key, not noise_seed, drew the stream
    _psum_tier(got.numpy(), want, 512)
    rng = np.random.default_rng(3)
    x, w = rng.normal(size=(6, 40)).astype(np.float32), rng.normal(size=(40, 24)).astype(np.float32)
    _float_tier(tdpu.photonic_matmul(torch.from_numpy(x), torch.from_numpy(w), td, prng_key=TKEY).numpy(),
                jdpu.photonic_matmul(jnp.asarray(x), jnp.asarray(w), jd, prng_key=JKEY))


def test_stream_seed_with_a_key_folds_site_layer_and_plane():
    jd, td = _dpus()
    xq, wq = _ints(4, 6, 30, 20)
    for site, fold, plane in (("attn.wq", 2, None), ("ffn.wo", None, 5), (None, 7, 0), (None, None, None)):
        want = int(jengine_for(jd, "ref").stream_seed(site, None if fold is None else jnp.int32(fold), JKEY,
                                                      jnp.asarray(xq), jnp.asarray(wq), plane=plane))
        got = engine_for(td, "ref").stream_seed(site, fold, torch.from_numpy(xq), torch.from_numpy(wq),
                                                 prng_key=TKEY, plane=plane)
        assert int(got) == want


@pytest.mark.parametrize("backend", ["kernel", "ref"])
def test_engine_int_gemm_and_packed_matmul_with_a_key(backend):
    jd, td = _dpus()
    xq, wq = _ints(5)
    want = jengine_for(jd, BACKEND[backend]).int_gemm(jnp.asarray(xq), jnp.asarray(wq), site="attn.wo",
                                                     fold=jnp.int32(1), prng_key=JKEY)
    got = engine_for(td, backend).int_gemm(torch.from_numpy(xq), torch.from_numpy(wq), site="attn.wo", fold=1,
                                           prng_key=TKEY)
    _psum_tier(got.numpy(), want, 512)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(5, 72)).astype(np.float32)
    w = (rng.normal(size=(72, 40)) / np.sqrt(72)).astype(np.float32)
    jeng, teng = jengine_for(jd, BACKEND[backend]), engine_for(td, backend)
    want = jeng.matmul(jnp.asarray(x), jpack({"w": jnp.asarray(w)}, jeng)["w"], site="attn.wq",
                       fold=jnp.int32(0), prng_key=JKEY)
    got = teng.matmul(torch.from_numpy(x), tpack({"w": torch.from_numpy(w)}, teng)["w"], site="attn.wq", fold=0,
                      prng_key=TKEY)
    _float_tier(got.numpy(), want)


@pytest.mark.parametrize("org,plane_bits", [("ideal", 2), ("SMWA", 2), ("ASMW", 2), ("ASMW", 8)])
@pytest.mark.parametrize("backend", ["kernel", "ref"])
def test_sliced_call_with_a_key(org, plane_bits, backend):
    jd, td = _dpus(org)
    xq, wq = _ints(1)
    want = np.asarray(jengine_for(jd, BACKEND[backend], slicing=plane_bits).int_gemm(
        jnp.asarray(xq), jnp.asarray(wq), site="ffn.wo", fold=jnp.int32(1), prng_key=JKEY), np.int64)
    got = engine_for(td, backend, slicing=plane_bits).int_gemm(
        torch.from_numpy(xq), torch.from_numpy(wq), site="ffn.wo", fold=1, prng_key=TKEY).numpy()
    exact = xq.astype(np.int64) @ wq.astype(np.int64)
    if org == "ideal":
        np.testing.assert_array_equal(got, exact)
        np.testing.assert_array_equal(want, exact)
        return
    seeded = engine_for(td, backend, slicing=plane_bits).int_gemm(
        torch.from_numpy(xq), torch.from_numpy(wq), site="ffn.wo", fold=1).numpy()
    assert (got != seeded).any() and np.abs(got - exact).max() > 0
    planes = SlicingSpec(plane_bits).num_planes(8)
    _psum_tier(got, want, 2 * 2 ** (2 * plane_bits * (planes - 1)))


def test_dense_with_a_key():
    jd, td = _dpus()
    jc = jcm.ModelConfig(photonic=jd, photonic_backend="pallas")
    tc = tcm.ModelConfig(photonic=td, photonic_backend="kernel")
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 3, 72)).astype(np.float32)
    w = (rng.normal(size=(72, 40)) / np.sqrt(72)).astype(np.float32)
    b = rng.normal(size=40).astype(np.float32)
    want = jcm.dense({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x), jc, site="attn.wq",
                     layer=jnp.int32(1), prng_key=JKEY)
    p = {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
    got = tcm.dense(p, torch.from_numpy(x), tc, site="attn.wq", layer=1, prng_key=TKEY)
    assert not torch.equal(got, tcm.dense(p, torch.from_numpy(x), tc, site="attn.wq", layer=1))
    _float_tier(got.detach().numpy(), want)


# ---------------------------------------------------------------------------
# Sampling at temperature 0.8
# ---------------------------------------------------------------------------
JA, TA = jreg.get("qwen2-0.5b"), treg.get("qwen2-0.5b")
SMALL = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64)


@pytest.fixture(scope="module")
def models():
    jc = dataclasses.replace(JA.smoke_config, remat=False, **SMALL)
    tc = dataclasses.replace(TA.smoke_config, **SMALL)
    jp = init_tree(JA.param_defs(jc), jax.random.PRNGKey(0), jc.param_dtype)
    return jc, tc, jp, params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")


def _prompts(lengths):
    rng = np.random.default_rng(42)
    return [rng.integers(0, 64, n).astype(np.int32) for n in lengths]


def test_scheduler_sampled_tokens_match_reference(models):
    jc, tc, jp, tp = models
    sc = dict(batch_size=2, max_seq=32, block_size=8, chunk_tokens=8, greedy=False, temperature=0.8, seed=4)
    prompts = _prompts([9, 6, 5])
    js = JScheduler(JA, jc, jp, JServingConfig(**sc))
    jr = [JRequest(uid=10 + i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)]
    js.run(jr)
    ts = TScheduler(TA, tc, tp, TServingConfig(**sc), device="cpu")
    tr = [TRequest(uid=10 + i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)]
    ts.run(tr)
    assert [r.output for r in tr] == [r.output for r in jr]
    greedy = TScheduler(TA, tc, tp, TServingConfig(**dict(sc, greedy=True)), device="cpu")
    gr = [TRequest(uid=10 + i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)]
    greedy.run(gr)
    assert [r.output for r in gr] != [r.output for r in tr]  # the draw is live


def test_legacy_engine_sampled_tokens_match_reference(models):
    jc, tc, jp, tp = models
    prompts = _prompts([5, 12, 7])
    je = jserve.LegacyEngine(JA, jc, jp, jserve.ServeConfig(batch_size=2, max_seq=32, greedy=False,
                                                             temperature=0.8, seed=6))
    jr = [JRequest(uid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)]
    je.run(jr)
    te = tserve.LegacyEngine(TA, tc, tp, tserve.ServeConfig(batch_size=2, max_seq=32, greedy=False,
                                                            temperature=0.8, seed=6), device="cpu")
    tr = [TRequest(uid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)]
    te.run(tr)
    assert [r.output for r in tr] == [r.output for r in jr]
    np.testing.assert_array_equal(te._rng, np.asarray(je._rng))
