"""The port's bit-sliced execution mode against the JAX reference.

Ports ``tests/test_bit_slicing.py`` (DESIGN.md §15) and holds the port's
sliced engine, models and paged server to the reference on the same
numpy-seeded inputs.  Tolerances:

* ideal channel: bitwise, and equal to ``exact_int_gemm``, for every plane
  width on the ``kernel`` (the CUDA kernel's twin on CPU) and ``ref``
  backends;
* noisy channels (SMWA, ASMW, ``noise_seed``): the stream seeds are bitwise
  (site, layer, ``(PLANE_STREAM_TAG, plane)``, plane content words), the
  draws only ulp-close (f32 ``log``/``cos`` differ between XLA and torch),
  and the reference's interpret mode contracts the crosstalk adds into an
  FMA (ROADMAP Queue 3), so a plane pass's psum may round one LSB apart:
  at most 1% of outputs may differ, each by at most two LSBs of the top
  plane pass, ``2 * 2^(2 p (P - 1))``;
* model logits: ``atol=1e-5`` (the attention and digital head sum in other
  orders; ``tests/test_torch_serving.py``), greedy tokens equal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core.dpu import DPUConfig as JDPU  # noqa: E402
from repro.core.dpu import bit_slices as jbit_slices  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models.common import init_tree  # noqa: E402
from repro.noise.channel import build_channel_model as jbuild  # noqa: E402
from repro.noise.channel import sliced_channel as jsliced  # noqa: E402
from repro.photonic import engine_for as jengine_for  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import Scheduler as JScheduler  # noqa: E402
from repro.serving import ServingConfig as JServingConfig  # noqa: E402
from repro_torch.core.dpu import DPUConfig as TDPU  # noqa: E402
from repro_torch.core.dpu import bit_slices  # noqa: E402
from repro_torch.kernels.photonic_gemm import kernel as tk  # noqa: E402
from repro_torch.kernels.photonic_gemm.ref import exact_int_gemm  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models.common import ModelConfig  # noqa: E402
from repro_torch.noise.channel import ChannelModel  # noqa: E402
from repro_torch.noise.channel import build_channel_model as tbuild  # noqa: E402
from repro_torch.noise.channel import sliced_channel  # noqa: E402
from repro_torch.noise.stages import tweak_word  # noqa: E402
from repro_torch.photonic import (  # noqa: E402
    Epilogue,
    EpilogueSpec,
    PhotonicEngine,
    SlicingSpec,
    engine_for,
    pack_dense,
    resolve_slicing,
)
from repro_torch.photonic.engine import plane_operands  # noqa: E402
from repro_torch.serving import Request as TRequest  # noqa: E402
from repro_torch.serving import Scheduler as TScheduler  # noqa: E402
from repro_torch.serving import ServingConfig as TServingConfig  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

RNG = np.random.default_rng(7)
XQ = RNG.integers(-127, 128, (5, 40), dtype=np.int8)
WQ = RNG.integers(-127, 128, (40, 9), dtype=np.int8)
X = RNG.normal(size=(4, 40)).astype(np.float32)
W = RNG.normal(size=(40, 24)).astype(np.float32)
B = RNG.normal(size=(24,)).astype(np.float32)
TX, TW, TB, TXQ, TWQ = (torch.from_numpy(a) for a in (X, W, B, XQ, WQ))
BACKEND = {"kernel": "pallas", "ref": "ref"}


def _ideal(n=16):
    return TDPU(organization="SMWA", bits=4, dpe_size=n)


def _noisy(n=16, platform="SIN", seed=11, org="SMWA"):
    ch = tbuild(org, n=n, bits=4, datarate_gs=5.0, platform=platform)
    return TDPU(organization=org, bits=4, dpe_size=n, channel=ch, noise_seed=seed)


def _gold():
    return exact_int_gemm(TXQ, TWQ)


# ---------------------------------------------------------------------------
# Ideal channel: sliced == exact, bitwise
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["kernel", "ref"])
@pytest.mark.parametrize("plane_bits", [1, 2, 4, 8])
def test_ideal_sliced_equals_exact(backend, plane_bits):
    out = engine_for(_ideal(), backend, slicing=plane_bits).int_gemm(TXQ, TWQ)
    assert out.dtype == torch.int32
    assert torch.equal(out, _gold())


def test_per_call_override_and_none():
    eng = engine_for(_ideal(), "ref")
    assert torch.equal(eng.int_gemm(TXQ, TWQ, slicing=2), _gold())
    sliced = eng.with_slicing(2)
    assert torch.equal(sliced.int_gemm(TXQ, TWQ, slicing="none"), _gold())


def test_exact_backend_ignores_slicing():
    a = engine_for(_ideal(), "exact").int_gemm(TXQ, TWQ)
    b = engine_for(_ideal(), "exact", slicing=2).int_gemm(TXQ, TWQ)
    assert torch.equal(a, b)


@pytest.mark.parametrize("backend", ["kernel", "ref"])
def test_sliced_matmul_with_epilogue_equals_exact(backend):
    eng = engine_for(_ideal(), backend, slicing=2)
    ep = Epilogue(EpilogueSpec(bias=True, activation="gelu"), TB)
    out = eng.matmul_float(TX, TW, site="s", epilogue=ep)
    gold = engine_for(_ideal(), "exact").matmul_float(TX, TW, site="s", bias=TB, activation="gelu")
    assert torch.equal(out, gold)


# ---------------------------------------------------------------------------
# Noisy channel: deterministic, decorrelated planes, smaller noise
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["kernel", "ref"])
def test_same_seed_same_result(backend):
    eng = engine_for(_noisy(), backend, slicing=2)
    a = eng.int_gemm(TXQ, TWQ, site="s", fold=1)
    assert torch.equal(a, eng.int_gemm(TXQ, TWQ, site="s", fold=1))
    assert not torch.equal(a, _gold())


def test_different_seed_differs():
    a = engine_for(_noisy(seed=11), "ref", slicing=2).int_gemm(TXQ, TWQ)
    b = engine_for(_noisy(seed=12), "ref", slicing=2).int_gemm(TXQ, TWQ)
    assert not torch.equal(a, b)


def test_plane_stream_decorrelated():
    eng = engine_for(_noisy(), "ref")
    a = eng.int_gemm(TXQ, TWQ, site="s", plane=0)
    b = eng.int_gemm(TXQ, TWQ, site="s", plane=1)
    c = eng.int_gemm(TXQ, TWQ, site="s")
    assert not torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("backend,stages", [("ref", "all"), ("ref", "detector"), ("kernel", "detector")])
def test_sliced_noise_is_smaller(backend, stages):
    """The physics the mode buys: each plane pass sees the detector sigma
    re-referred to the plane full-scale.  SMWA's filter truncation, a
    (1 - alpha) gain on every pass, is the same sliced or not and at N=16
    is as large as the detector noise, so the kernel case (whose tiled
    stream draws other noise than ``ref``'s) keeps the detector alone."""
    gold = _gold().to(torch.float64)
    dpu = _noisy(platform="SOI")
    if stages == "detector":
        dpu = dataclasses.replace(dpu, channel=dpu.channel.disable("crosstalk"))
    base = engine_for(dpu, backend)
    err_full = (base.int_gemm(TXQ, TWQ).to(torch.float64) - gold).abs()
    err_sliced = (base.with_slicing(2).int_gemm(TXQ, TWQ).to(torch.float64) - gold).abs()
    assert err_sliced.mean() < err_full.mean()


# ---------------------------------------------------------------------------
# The port against the reference
# ---------------------------------------------------------------------------
def test_bit_slices_and_sliced_channel_match_reference():
    for p, planes in ((1, 8), (2, 4), (4, 2), (8, 1)):
        got = bit_slices(TWQ, p, planes)
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), np.asarray(jbit_slices(jnp.asarray(WQ), p, planes)))
        shifts = torch.tensor([1 << (p * s) for s in range(planes)], dtype=torch.int32)
        assert torch.equal((got.to(torch.int32) * shifts[:, None, None]).sum(0).to(torch.int8), TWQ)
    for org in ("SMWA", "ASMW", "MASW"):
        j = jbuild(org, n=24, bits=4, platform="SIN")
        t = tbuild(org, n=24, bits=4, platform="SIN")
        for p in (1, 2, 8):
            a, b = jsliced(j, p), sliced_channel(t, p)
            for f in ("bits", "n", "intermod_eps", "crossweight_eps", "filter_alpha", "detector_sigma_lsb", "adc_bits"):
                assert getattr(a, f) == getattr(b, f), (org, p, f)
    # Caller-set stages survive the rebuild; a sigma override is re-referred.
    t = dataclasses.replace(tbuild("SMWA", n=24, bits=4), adc_bits=10, detector_sigma_lsb=3.0, filter_alpha=0.0)
    s = sliced_channel(t, 2)
    assert (s.adc_bits, s.filter_alpha, s.detector_sigma_lsb) == (10, 0.0, 3.0 * 9 / 225)
    hand = ChannelModel(organization="SMWA", n=8, bits=4, detector_sigma_lsb=5.0)
    assert sliced_channel(hand, 2).detector_sigma_lsb == 5.0 * 9 / 225
    assert sliced_channel(hand, 4) is hand


@pytest.mark.parametrize("org,plane_bits", [("SMWA", 2), ("ASMW", 2), ("ASMW", 8)])
@pytest.mark.parametrize("backend", ["kernel", "ref"])
def test_noisy_sliced_matches_reference(org, plane_bits, backend):
    rng = np.random.default_rng(1)
    xq = rng.integers(-127, 128, (9, 72)).astype(np.int8)
    wq = rng.integers(-127, 128, (72, 40)).astype(np.int8)
    jd = JDPU(organization=org, bits=4, dpe_size=64, channel=jbuild(org, n=64, bits=4), noise_seed=3)
    want = np.asarray(jengine_for(jd, BACKEND[backend], slicing=plane_bits).int_gemm(
        jnp.asarray(xq), jnp.asarray(wq), site="ffn.wo", fold=jnp.int32(1)
    ), np.int64)
    td = _noisy(n=64, platform="SOI", seed=3, org=org)
    got = engine_for(td, backend, slicing=plane_bits).int_gemm(
        torch.from_numpy(xq), torch.from_numpy(wq), site="ffn.wo", fold=1
    ).numpy().astype(np.int64)
    exact = xq.astype(np.int64) @ wq.astype(np.int64)
    assert np.abs(got - exact).max() > 0  # the channel is live
    planes = SlicingSpec(plane_bits).num_planes(8)
    d = np.abs(got - want)
    assert (d > 0).mean() <= 0.01 and d.max() <= 2 * 2 ** (2 * plane_bits * (planes - 1))


def test_stream_seed_folds_the_plane_as_the_reference_does():
    rng = np.random.default_rng(2)
    xq = rng.integers(-7, 8, (6, 30)).astype(np.int8)
    wq = rng.integers(-7, 8, (30, 20)).astype(np.int8)
    jd = JDPU(organization="SMWA", bits=4, dpe_size=16, channel=jbuild("SMWA", n=16, bits=4), noise_seed=3)
    td = _noisy(n=16, platform="SOI", seed=3)
    for plane in (None, 0, 5):
        want = int(jengine_for(jd, "ref").stream_seed("attn.wq", jnp.int32(2), None, jnp.asarray(xq),
                                                      jnp.asarray(wq), plane=plane))
        got = engine_for(td, "ref").stream_seed("attn.wq", 2, torch.from_numpy(xq), torch.from_numpy(wq),
                                                 plane=plane)
        assert int(got) == want


# ---------------------------------------------------------------------------
# The surface
# ---------------------------------------------------------------------------
def test_resolve_slicing_round_trips_and_rejections():
    assert resolve_slicing(None) is None
    assert resolve_slicing("none") is None and resolve_slicing(" off ") is None and resolve_slicing("") is None
    assert resolve_slicing(2) == SlicingSpec(2) and resolve_slicing("4") == SlicingSpec(4)
    spec = SlicingSpec(2)
    assert resolve_slicing(spec) is spec
    for bad in (True, 3, "both"):
        with pytest.raises(ValueError):
            resolve_slicing(bad)
    with pytest.raises(ValueError):
        SlicingSpec(plane_bits=5)
    assert [SlicingSpec(p).num_planes(8) for p in (1, 2, 4, 8)] == [8, 4, 2, 1]
    eng = engine_for(_ideal(), "ref")
    assert eng.with_slicing(None) is eng
    sliced = eng.with_slicing(2)
    assert sliced.slicing == SlicingSpec(2) and sliced.with_slicing(SlicingSpec(2)) is sliced
    assert eng.slicing is None
    assert PhotonicEngine(dpu=_ideal(), slicing="2").slicing == SlicingSpec(2)
    with pytest.raises(ValueError):
        PhotonicEngine(dpu=_ideal(), slicing="both")


def test_engine_info_text_matches_reference():
    jd = JDPU(organization="SMWA", bits=4, dpe_size=21, channel=jbuild("SMWA", n=21, bits=4, platform="SIN"),
              noise_seed=11)
    want = str(jengine_for(jd, "ref", slicing=2).describe())
    info = engine_for(_noisy(n=21), "ref", slicing=2).describe()
    assert str(info) == want
    assert "channel=analog, platform=SIN, slicing=2b planes, sites" in str(info)
    assert info.to_dict()["slicing"] == 2
    assert engine_for(_ideal(), "kernel").describe().slicing is None


def test_model_config_resolves_slicing_eagerly():
    assert ModelConfig(photonic=_ideal(), photonic_slicing="2").photonic_slicing == SlicingSpec(2)
    assert ModelConfig(photonic=_ideal()).photonic_slicing is None
    with pytest.raises(ValueError):
        ModelConfig(photonic=_ideal(), photonic_slicing="both")


# ---------------------------------------------------------------------------
# The per-plane pack cache
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("plane_bits", [2, 8])
def test_pack_plane_cache_equals_per_call_values(plane_bits):
    eng = engine_for(_noisy(n=16), "kernel", slicing=plane_bits)
    pk = pack_dense({"w": TW}, eng)["w"]
    planes = SlicingSpec(plane_bits).num_planes(8)
    shape = tuple(pk.wq.shape)
    w_pl, words = pk.planes(plane_bits, planes, shape, True)
    assert pk.planes(plane_bits, planes, shape, True)[0] is w_pl  # computed once
    ref_pl, ref_words = plane_operands(pk.wq[: pk.k, : pk.c], plane_bits, planes, shape, True)
    assert torch.equal(w_pl, ref_pl) and torch.equal(words, ref_words)
    logical = bit_slices(pk.wq[: pk.k, : pk.c], plane_bits, planes)
    for i in range(planes):
        assert int(words[i]) == int(tweak_word(logical[i]))
        assert torch.equal(w_pl[i, : pk.k, : pk.c], logical[i])
    # The packed hot path on cached planes is bitwise the per-call path.
    tk.reset_launches()
    a = eng.matmul(TX, pk, site="attn.wq", fold=2, bias=TB)
    b = eng.matmul_float(TX, TW, site="attn.wq", fold=2, bias=TB)
    assert torch.equal(a, b) and sum(tk.LAUNCHES.values()) == 0  # the twin is no launch


# ---------------------------------------------------------------------------
# Models and the paged server at smoke size
# ---------------------------------------------------------------------------
JA = jreg.get("qwen2-0.5b")
TA = treg.get("qwen2-0.5b")
SMALL = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64)
SC = dict(batch_size=2, max_seq=32, block_size=8, chunk_tokens=8, record_logits=True)


def _cfgs(channel, t_backend):
    """(reference, port) configs with ``photonic_slicing=2``: the ideal
    channel (the port's kernel twin against the reference's ``ref``, both
    then exact) or SMWA with ``noise_seed=0`` on ``ref`` on both sides."""
    if channel == "ideal":
        jd, td = JDPU(organization="SMWA", bits=4, dpe_size=16), _ideal()
    else:
        jd = JDPU(organization="SMWA", bits=4, dpe_size=64, channel=jbuild("SMWA", n=64, bits=4), noise_seed=0)
        td = _noisy(n=64, platform="SOI", seed=0)
    jc = dataclasses.replace(JA.smoke_config, remat=False, **SMALL, photonic=jd, photonic_backend="ref",
                             photonic_slicing=2)
    tc = dataclasses.replace(TA.smoke_config, **SMALL, photonic=td, photonic_backend=t_backend, photonic_slicing=2)
    return jc, tc


@pytest.fixture(scope="module")
def jparams():
    jc, _ = _cfgs("ideal", "kernel")
    return init_tree(JA.param_defs(jc), jax.random.PRNGKey(0), jc.param_dtype)


def _tparams(jparams, tc):
    return params_from_jax(jax.tree.map(np.asarray, jparams), tc, "cpu")


@pytest.mark.parametrize("channel,t_backend", [("ideal", "kernel"), ("smwa", "ref")])
def test_lm_logits_sliced_matches_reference(jparams, channel, t_backend):
    jc, tc = _cfgs(channel, t_backend)
    toks = np.random.default_rng(0).integers(0, 64, (2, 8)).astype(np.int32)
    want, _ = jlm.lm_logits(jparams, jnp.asarray(toks), jc)
    with torch.no_grad():
        got, _ = tlm.lm_logits(_tparams(jparams, tc), torch.from_numpy(toks).long(), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    if channel == "ideal":  # sliced ideal == unsliced ideal
        with torch.no_grad():
            plain, _ = tlm.lm_logits(_tparams(jparams, tc), torch.from_numpy(toks).long(),
                                     dataclasses.replace(tc, photonic_slicing=None))
        assert torch.equal(got, plain)


@pytest.mark.parametrize("channel,t_backend,lengths", [("ideal", "kernel", (8, 8)), ("smwa", "ref", (8,))])
def test_scheduler_sliced_matches_reference(jparams, channel, t_backend, lengths):
    jc, tc = _cfgs(channel, t_backend)
    rng = np.random.default_rng(42)
    prompts = [rng.integers(0, 64, n).astype(np.int32) for n in lengths]
    new = 3 if channel == "ideal" else 2
    js = JScheduler(JA, jc, jparams, JServingConfig(**SC))
    jr = [JRequest(uid=i, prompt=p, max_new_tokens=new) for i, p in enumerate(prompts)]
    js.run(jr)
    ts = TScheduler(TA, tc, _tparams(jparams, tc), TServingConfig(**SC), device="cpu")
    tr = [TRequest(uid=i, prompt=p, max_new_tokens=new) for i, p in enumerate(prompts)]
    ts.run(tr)
    assert ts.photonic.describe().slicing == 2
    for a, b in zip(jr, tr):
        assert b.done and a.output == b.output
        for x, y in zip(a.logits, b.logits):
            np.testing.assert_allclose(y, np.asarray(x), atol=1e-5, rtol=1e-5)
    assert ts.decode_weight_rounds() == 0
