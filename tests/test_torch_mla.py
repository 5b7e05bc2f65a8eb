"""The port's MLA (DeepSeek-V2's multi-head latent attention) and its
one-shot serving against the reference, at deepseek-v2-lite-16b's smoke
config with the reference's weights carried over (``params_from_jax``).

* each MLA function (``mla_attention``, ``mla_prefill`` with its
  compressed cache, ``mla_decode`` expanded and absorbed) against its
  reference counterpart, digital and on the ideal channel (the port's
  kernel twin against the reference's ``ref``): outputs and caches within
  ``atol=1e-5`` (f32 products summed in other orders); absorbed decode
  also with prepacked and int8-stored up-projections (read dequantized);
* the reference's contracts for this family, ported: absorbed decode
  equals expanded decode within 1e-4 digitally
  (``tests/test_quantized_serving.py::test_mla_absorbed_decode_exact``);
  ``serve.Engine`` leaves ``wuk``/``wuv`` unpacked under ``mla_absorb``,
  so prepacked absorbed decode is bitwise the unpacked one
  (``tests/test_photonic_engine.py``); the paged ``Scheduler`` refuses MLA
  and ``Engine`` routes it to ``LegacyEngine`` (``tests/test_serving.py``);
* routed GEMMs per forward: 7 a layer + the head for prefill and expanded
  decode (``wuk``/``wuv`` over all ``B * max_seq`` cache rows, padding
  included), 5 a layer + the head for absorbed decode;
* ``LegacyEngine`` on the ideal channel, greedy and sampled at temperature
  0.8 under the reference's keys, expanded and absorbed: tokens equal the
  reference's ``serve.Engine``'s.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core.dpu import DPUConfig as JDPU  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models.common import init_tree  # noqa: E402
from repro.runtime import serve as jserve  # noqa: E402
from repro_torch.core.dpu import DPUConfig as TDPU  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models.common import quantize_params  # noqa: E402
from repro_torch.photonic import PackedDense, engine_for  # noqa: E402
from repro_torch.photonic.packing import pack_dense  # noqa: E402
from repro_torch.runtime import serve as tserve  # noqa: E402
from repro_torch.serving import Scheduler as TScheduler  # noqa: E402
from repro_torch.serving import ServingConfig as TServingConfig  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

NAME = "deepseek-v2-lite-16b"
JA, TA = jreg.get(NAME), treg.get(NAME)
MODES = pytest.mark.parametrize("photonic", [False, True], ids=["digital", "ideal-photonic"])


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(photonic: bool, **kw):
    jc = dataclasses.replace(JA.smoke_config, remat=False, **kw)
    tc = dataclasses.replace(TA.smoke_config, **kw)
    if photonic:
        jc = dataclasses.replace(jc, photonic=JDPU(organization="SMWA", bits=4, dpe_size=16), photonic_backend="ref")
        tc = dataclasses.replace(tc, photonic=TDPU(organization="SMWA", bits=4, dpe_size=16),
                                 photonic_backend="kernel")
    return jc, tc


@pytest.fixture(scope="module")
def jparams():
    # Jitted, the reference's calls here compile as one program each: a
    # tenth of their eager time on the CPU (the ref backend is many ops).
    return jax.jit(lambda k: init_tree(JA.param_defs(JA.smoke_config), k, jnp.float32))(jax.random.PRNGKey(0))


def _attn_params(jparams, tc):
    jp = jparams["layers"]["attn"]
    jp = jax.tree.map(lambda a: a[1], jp)  # layer 1 of the stacked list
    return jp, params_from_jax(_np_tree(jp), tc, "cpu")


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@MODES
def test_mla_attention_and_prefill_match_reference(jparams, photonic):
    jc, tc = _cfgs(photonic)
    jp, tp = _attn_params(jparams, tc)
    x = np.random.default_rng(1).normal(size=(2, 9, tc.d_model)).astype(np.float32)
    pos_j, pos_t = jnp.arange(9), torch.arange(9)
    want = jax.jit(lambda p, x: jattn.mla_attention(p, x, jc, positions=pos_j, layer=2))(jp, jnp.asarray(x))
    want_p, want_c = jax.jit(lambda p, x: jattn.mla_prefill(p, x, jc, positions=pos_j, max_seq=16, layer=2))(
        jp, jnp.asarray(x))
    with torch.no_grad():
        got = tattn.mla_attention(tp, torch.from_numpy(x), tc, positions=pos_t, layer=2)
        got_p, got_c = tattn.mla_prefill(tp, torch.from_numpy(x), tc, positions=pos_t, max_seq=16, layer=2)
    _close(got, want)
    _close(got_p, want_p)
    assert got_c.keys() == want_c.keys() == {"c_kv", "k_rope"}
    for k in got_c:
        assert tuple(got_c[k].shape) == want_c[k].shape
        _close(got_c[k], want_c[k])


def _decode_inputs(jparams, tc, jc, jp, tp):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 6, tc.d_model)).astype(np.float32)
    x1 = rng.normal(size=(2, 1, tc.d_model)).astype(np.float32)
    _, jcache = jax.jit(lambda p, x: jattn.mla_prefill(p, x, jc, positions=jnp.arange(6), max_seq=12, layer=2))(
        jp, jnp.asarray(x))
    tcache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    return x1, jcache, tcache


def _jdecode(jc):
    return jax.jit(lambda p, x, c: jattn.mla_decode(p, x, c, jnp.asarray(6, jnp.int32), jc, layer=2))


@MODES
@pytest.mark.parametrize("absorb", [False, True], ids=["expanded", "absorbed"])
def test_mla_decode_matches_reference(jparams, photonic, absorb):
    jc, tc = _cfgs(photonic, mla_absorb=absorb)
    jp, tp = _attn_params(jparams, tc)
    x1, jcache, tcache = _decode_inputs(jparams, tc, jc, jp, tp)
    want, wcache = _jdecode(jc)(jp, jnp.asarray(x1), jcache)
    with torch.no_grad():
        got, gcache = tattn.mla_decode(tp, torch.from_numpy(x1), tcache, 6, tc, layer=2)
    _close(got, want)
    for k in ("c_kv", "k_rope"):
        assert gcache[k] is tcache[k]  # written in place
        _close(gcache[k], wcache[k])


@pytest.mark.parametrize("layout", ["packed", "int8"])
def test_absorbed_decode_reads_packed_and_int8_up_projections(jparams, layout):
    """``_mla_up_weight`` dequantizes a prepacked or int8-stored ``wuk`` /
    ``wuv``: absorbed decode with those equals the reference's with the
    same layout (digital ``wo`` etc. aside, the products are f32)."""
    jc, tc = _cfgs(True, mla_absorb=True)
    jp, tp = _attn_params(jparams, tc)
    x1, jcache, tcache = _decode_inputs(jparams, tc, jc, jp, tp)
    if layout == "packed":
        from repro.photonic import engine_for as jengine_for
        from repro.photonic.packing import pack_dense as jpack

        jeng, teng = jengine_for(jc.photonic, "ref"), engine_for(tc.photonic, "kernel")
        for k in ("wuk", "wuv"):
            jp = {**jp, k: jpack(jp[k], jeng)}
            tp = {**tp, k: pack_dense(tp[k], teng)}
        assert isinstance(tp["wuk"]["w"], PackedDense)
    else:
        from repro.models.common import quantize_params as jquantize

        jq = dataclasses.replace(jc, photonic_scope="weights_int8")
        tq = dataclasses.replace(tc, photonic_scope="weights_int8")
        jp = jquantize(jp, jattn.mla_def(jq))
        tp = quantize_params(tp, tattn.mla_def(tq))
        assert tp["wuk"]["w"].dtype == torch.int8 and "w_scale" in tp["wuk"]
        jc, tc = jq, tq
    np.testing.assert_array_equal(tattn._mla_up_weight(tp["wuk"]).to(torch.float32).numpy(),
                                  np.asarray(jattn._mla_up_weight(jp["wuk"]), np.float32))
    want, _ = _jdecode(jc)(jp, jnp.asarray(x1), jcache)
    with torch.no_grad():
        got, _ = tattn.mla_decode(tp, torch.from_numpy(x1), tcache, 6, tc, layer=2)
    _close(got, want)


def _roundtrip(arch, cfg, params, toks, t, jit=lambda f: f):
    prefill = jit(lambda p, b: arch.prefill(p, b, cfg, t))
    decode = jit(lambda p, x, c: arch.decode(p, x, c, cfg))
    logits, cache = prefill(params, {"tokens": toks[:, : t - 4]})
    outs = [logits]
    for i in range(t - 4, t):
        logits, cache = decode(params, toks[:, i : i + 1], cache)
        outs.append(logits)
    return outs


def test_mla_absorbed_decode_exact(jparams):
    """Port of the reference's contract: weight-absorbed MLA decode equals
    expanded decode (a linear identity) within 1e-4, digitally; and each
    equals the reference's same mode within 1e-5."""
    jc, tc = _cfgs(False)
    tp = params_from_jax(_np_tree(jparams), tc, "cpu")
    toks = np.random.default_rng(0).integers(0, tc.vocab_size, (2, 16)).astype(np.int32)
    with torch.no_grad():
        a = torch.cat(_roundtrip(TA, tc, tp, torch.from_numpy(toks).long(), 16), dim=1)
        b = torch.cat(_roundtrip(TA, dataclasses.replace(tc, mla_absorb=True), tp,
                                 torch.from_numpy(toks).long(), 16), dim=1)
    assert float((a - b).abs().max()) < 1e-4
    want = jnp.concatenate(_roundtrip(JA, jc, jparams, jnp.asarray(toks), 16, jit=jax.jit), axis=1)
    _close(a, want)


def test_serve_prepack_preserves_absorbed_mla_decode_bitwise(jparams):
    """Port of the reference's contract: under ``mla_absorb``
    ``serve.Engine`` leaves ``wuk``/``wuv`` unpacked (absorbed decode reads
    them as floats), so decode on the prepacked params is bitwise decode
    on the float params."""
    _, tc = _cfgs(True, mla_absorb=True)
    tc = dataclasses.replace(tc, photonic=TDPU(organization="SMWA", bits=4, datarate_gs=5.0))
    tp = params_from_jax(_np_tree(jparams), tc, "cpu")
    eng = tserve.Engine(TA, tc, tp, tserve.ServeConfig(batch_size=1, max_seq=16), device="cpu")
    assert isinstance(eng.impl, tserve.LegacyEngine)
    assert not isinstance(eng.params["layers"][0]["attn"]["wuk"]["w"], PackedDense)
    assert isinstance(eng.params["layers"][0]["attn"]["wq"]["w"], PackedDense)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, tc.vocab_size, (1, 8))).long()
    with torch.no_grad():
        _, cache_a = TA.prefill(tp, {"tokens": toks}, tc, 16)
        _, cache_b = TA.prefill(eng.params, {"tokens": toks}, tc, 16)
        la, _ = TA.decode(tp, toks[:, :1], cache_a, tc)
        lb, _ = TA.decode(eng.params, toks[:, :1], cache_b, tc)
    assert torch.equal(la, lb)
    # Without mla_absorb the up-projections pack like every other site.
    eng2 = tserve.Engine(TA, dataclasses.replace(tc, mla_absorb=False), tp,
                         tserve.ServeConfig(batch_size=1, max_seq=16), device="cpu")
    assert isinstance(eng2.params["layers"][0]["attn"]["wuk"]["w"], PackedDense)


@pytest.mark.parametrize("absorb", [False, True], ids=["expanded", "absorbed"])
def test_routed_gemms_per_forward(jparams, absorb, monkeypatch):
    """7 routed GEMMs a layer + the head per prefill and expanded decode,
    with ``wuk``/``wuv`` over the whole padded cache (``B * max_seq`` rows);
    5 a layer + the head per absorbed decode.  The cache tree is the
    reference's: ``first``, ``layers.{c_kv, k_rope}`` stacked, ``pos``."""
    import repro_torch.photonic.engine as E

    _, tc = _cfgs(True, mla_absorb=absorb)
    tp = params_from_jax(_np_tree(jparams), tc, "cpu")
    calls = []
    inner = E.photonic_gemm_fused

    def counted(x, w, *a, **kw):
        calls.append(kw.get("rows") or x.shape[0])
        return inner(x, w, *a, **kw)

    monkeypatch.setattr(E, "photonic_gemm_fused", counted)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, tc.vocab_size, (2, 5))).long()
    with torch.no_grad():
        _, cache = TA.prefill(tp, {"tokens": toks}, tc, 12)
        n_prefill = len(calls)
        TA.decode(tp, toks[:, :1], cache, tc)
    assert set(cache) == {"first", "layers", "pos"} and set(cache["layers"]) == {"c_kv", "k_rope"}
    assert tuple(cache["layers"]["c_kv"].shape) == (tc.num_layers - 1, 2, 12, tc.kv_lora_rank)
    assert tuple(cache["first"]["k_rope"].shape) == (2, 12, tc.qk_rope_head_dim)
    decode = calls[n_prefill:]
    assert n_prefill == 7 * tc.num_layers + 1
    assert len(decode) == (5 if absorb else 7) * tc.num_layers + 1
    cache_rows = [r for r in decode if r != 2]  # every other decode GEMM has the B = 2 token rows
    assert cache_rows == ([] if absorb else [2 * 12] * (2 * tc.num_layers))


def test_scheduler_rejects_unsupported_families():
    """Port of the reference's contract: the paged scheduler refuses MLA
    and names the engine that serves it."""
    cfg = TA.smoke_config
    with pytest.raises(ValueError, match="LegacyEngine"):
        TScheduler(TA, cfg, {}, TServingConfig(batch_size=1, max_seq=16), device="cpu")


def test_mla_family_falls_back_to_legacy(jparams):
    """Port of the reference's contract: ``serve.Engine`` routes the MLA
    family to ``LegacyEngine``."""
    tp = params_from_jax(_np_tree(jparams), TA.smoke_config, "cpu")
    eng = tserve.Engine(TA, TA.smoke_config, tp, tserve.ServeConfig(batch_size=1, max_seq=16), device="cpu")
    assert isinstance(eng.impl, tserve.LegacyEngine)


@pytest.mark.parametrize("absorb", [False, True], ids=["expanded", "absorbed"])
@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "t0.8"])
def test_legacy_engine_tokens_match_reference(jparams, absorb, greedy):
    jc, tc = _cfgs(True, mla_absorb=absorb)
    tp = params_from_jax(_np_tree(jparams), tc, "cpu")
    rng = np.random.default_rng(42)
    prompts = [rng.integers(0, tc.vocab_size, n).astype(np.int32) for n in (5, 8, 6)]
    kw = dict(batch_size=2, max_seq=20, greedy=greedy, temperature=0.8, seed=0)
    # The reference's prefill jitted (its decode already is), one program a
    # prompt length instead of op-by-op compiles.
    ja = dataclasses.replace(JA, prefill=jax.jit(JA.prefill, static_argnums=(2, 3)))
    je = jserve.Engine(ja, jc, jparams, jserve.ServeConfig(**kw))
    jr = [jserve.Request(uid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
    je.run(jr)
    te = tserve.Engine(TA, tc, tp, tserve.ServeConfig(**kw), device="cpu")
    assert isinstance(te.impl, tserve.LegacyEngine)
    tr = [tserve.Request(uid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
    te.run(tr)
    for a, b in zip(jr, tr):
        assert b.done and len(b.output) == 4 and a.output == b.output, (a.output, b.output)
