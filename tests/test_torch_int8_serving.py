"""The port's int8 serving layout against the JAX reference: the int8 KV
cache, ``quantize_params`` (int8-stored weights) and the fused QKV bank.

Ports ``tests/test_quantized_serving.py`` (the int8 parts) and
``tests/test_fused_hotpath.py::TestFuseQKV``.  Models use the small qwen2
config of ``tests/test_serving.py`` in f32 with the reference's weights
carried over (``repro_torch.weights``).  Tolerances:

* ``quantize_params``, ``_quantize_kv``, the carried-over int8 layout and
  the fused banks: bitwise (the same f32 ops in the same order);
* logits ``atol=1e-5`` (the attention and digital head sum in other orders,
  ``tests/test_torch_serving.py``), greedy tokens equal; with the int8 KV
  cache the K/V rows are quantized from float values that may already be
  an ulp apart, so a row may round one int8 LSB apart; the logits stay
  within the same 1e-5 on these inputs;
* fused QKV against three calls: bitwise under a deterministic channel.
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
from repro.models.common import quantize_params as jquantize  # noqa: E402
from repro.photonic import engine_for as jengine_for  # noqa: E402
from repro.photonic.packing import fuse_qkv_params as jfuse  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import Scheduler as JScheduler  # noqa: E402
from repro.serving import ServingConfig as JServingConfig  # noqa: E402
from repro_torch.core.dpu import DPUConfig as TDPU  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models.common import ModelConfig, init_params  # noqa: E402
from repro_torch.models.common import quantize_params as tquantize  # noqa: E402
from repro_torch.noise.channel import build_channel_model as tbuild  # noqa: E402
from repro_torch.noise.stages import tweak_word  # noqa: E402
from repro_torch.photonic import PackedDense, engine_for, fuse_qkv_params, pack_dense  # noqa: E402
from repro_torch.runtime.serve import LegacyEngine, ServeConfig  # noqa: E402
from repro_torch.serving import Request as TRequest  # noqa: E402
from repro_torch.serving import Scheduler as TScheduler  # noqa: E402
from repro_torch.serving import ServingConfig as TServingConfig  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

JA = jreg.get("qwen2-0.5b")
TA = treg.get("qwen2-0.5b")
SMALL = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64)
SC = dict(batch_size=2, max_seq=32, block_size=8, chunk_tokens=8, record_logits=True)
JIDEAL = JDPU(organization="SMWA", bits=4, dpe_size=16)
TIDEAL = TDPU(organization="SMWA", bits=4, dpe_size=16)


def _cfgs(*, int8_weights: bool, kv8: bool):
    """(reference, port) configs: float weights or the int8-stored layout
    on the ideal channel (the port's kernel twin against the reference's
    ``ref``, both exact), float or int8 KV cache."""
    jc = dataclasses.replace(JA.smoke_config, remat=False, **SMALL, kv_cache_int8=kv8)
    tc = dataclasses.replace(TA.smoke_config, **SMALL, kv_cache_int8=kv8)
    if int8_weights:
        jc = dataclasses.replace(jc, photonic=JIDEAL, photonic_backend="ref", photonic_scope="weights_int8")
        tc = dataclasses.replace(tc, photonic=TIDEAL, photonic_backend="kernel", photonic_scope="weights_int8")
    return jc, tc


@pytest.fixture(scope="module")
def jfloat():
    jc, _ = _cfgs(int8_weights=False, kv8=False)
    return init_tree(JA.param_defs(jc), jax.random.PRNGKey(0), jc.param_dtype)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _params(jfloat, int8_weights):
    """(reference params, port params) for the layout: the port's int8
    layout comes from its own ``quantize_params`` of the carried float
    weights."""
    jc, tc = _cfgs(int8_weights=int8_weights, kv8=False)
    tp = params_from_jax(_np(jfloat), tc, "cpu")
    if not int8_weights:
        return jfloat, tp
    return jquantize(jfloat, JA.param_defs(jc)), tquantize(tp, TA.param_defs(tc))


def _prompts(lengths):
    rng = np.random.default_rng(42)
    return [rng.integers(0, 64, n).astype(np.int32) for n in lengths]


# ---------------------------------------------------------------------------
# Quantizers and layouts, bitwise
# ---------------------------------------------------------------------------
def test_quantize_params_bitwise_and_carried_over(jfloat):
    jq, tq = _params(jfloat, True)
    carried = params_from_jax(_np(jq), dataclasses.replace(_cfgs(int8_weights=True, kv8=False)[1],
                                                            param_dtype=torch.bfloat16), "cpu")
    n = 0
    for i, layer in enumerate(tq["layers"]):
        for blk in ("attn", "ffn"):
            for name, p in layer[blk].items():
                want = jq["layers"][blk][name]
                assert p["w"].dtype == torch.int8 and p["w_scale"].dtype == torch.float32
                np.testing.assert_array_equal(p["w"].numpy(), np.asarray(want["w"])[i])
                np.testing.assert_array_equal(p["w_scale"].numpy(), np.asarray(want["w_scale"])[i])
                c = carried["layers"][i][blk][name]
                assert c["w"].dtype == torch.int8 and c["w_scale"].dtype == torch.float32  # not bf16
                assert torch.equal(c["w"], p["w"]) and torch.equal(c["w_scale"], p["w_scale"])
                n += 1
    assert n == 2 * 6  # wq, wk, wv, wo, ffn wi, ffn wo per layer
    assert tq["embed"]["table"].dtype == torch.float32  # non-dense leaves pass through


def test_quantize_kv_bitwise():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32) * rng.uniform(0.1, 4.0, (2, 5, 3, 1)).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero row takes the 1e-12 floor
    jq, js = jattn._quantize_kv(jnp.asarray(x))
    tq, ts = tattn._quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    kf, _ = tattn._kv_view({"k": tq, "v": tq, "k_scale": ts, "v_scale": ts}, ModelConfig(kv_cache_int8=True))
    assert torch.equal(kf, tq.float() * ts[..., None])


def test_int8_cache_def_shapes():
    cfg = dataclasses.replace(TA.smoke_config, kv_cache_int8=True)
    d = tattn.gqa_cache_def(cfg, 4, 32, torch.bfloat16)
    jcfg = dataclasses.replace(JA.smoke_config, kv_cache_int8=True)
    jd = jattn.gqa_cache_def(jcfg, 4, 32, jnp.bfloat16)
    assert d["k"][2] == torch.int8 and d["k_scale"][2] == torch.float32
    assert d["k_scale"][0] == (4, 32, cfg.num_kv_heads)
    assert {k: v[:2] for k, v in d.items()} == {k: v[:2] for k, v in jd.items()}
    assert tattn.gqa_cache_def(TA.smoke_config, 4, 32, torch.bfloat16)["k"][2] == torch.bfloat16


# ---------------------------------------------------------------------------
# One-shot and paged serving with int8 KV and int8 weights
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("int8_weights", [False, True], ids=["float-w", "int8-w"])
def test_oneshot_int8_kv_matches_reference(jfloat, int8_weights):
    jc, tc = _cfgs(int8_weights=int8_weights, kv8=True)
    jp, tp = _params(jfloat, int8_weights)
    toks = np.random.default_rng(1).integers(0, 64, (2, 12)).astype(np.int32)
    t = 12
    jl, jcache = JA.prefill(jp, {"tokens": jnp.asarray(toks[:, : t - 4])}, jc, t)
    with torch.no_grad():
        tl, tcache = TA.prefill(tp, {"tokens": torch.from_numpy(toks[:, : t - 4]).long()}, tc, t)
    assert tcache["layers"]["k"].dtype == torch.int8 and tcache["layers"]["v_scale"].shape == (2, 2, t, 2)
    for name in ("k", "v", "k_scale", "v_scale"):
        got, want = tcache["layers"][name].numpy(), np.asarray(jcache["layers"][name])
        np.testing.assert_allclose(got, want, atol=1 if name in ("k", "v") else 1e-6, rtol=0)
    outs = [(tl, jl)]
    for i in range(t - 4, t):
        jl, jcache = JA.decode(jp, jnp.asarray(toks[:, i : i + 1]), jcache, jc)
        with torch.no_grad():
            tl, tcache = TA.decode(tp, torch.from_numpy(toks[:, i : i + 1]).long(), tcache, tc)
        outs.append((tl, jl))
    for got, want in outs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_legacy_engine_serves_int8(jfloat):
    _, tc = _cfgs(int8_weights=True, kv8=True)
    _, tp = _params(jfloat, True)
    eng = LegacyEngine(TA, tc, tp, ServeConfig(batch_size=2, max_seq=32), device="cpu")
    reqs = [TRequest(uid=i, prompt=p, max_new_tokens=3) for i, p in enumerate(_prompts([6, 9]))]
    eng.run(reqs)
    assert all(r.done and len(r.output) == 3 for r in reqs)
    assert eng.cache["layers"]["k_scale"].dtype == torch.float32


@pytest.mark.parametrize("int8_weights", [False, True], ids=["float-w", "int8-w"])
def test_scheduler_int8_matches_reference(jfloat, int8_weights):
    jc, tc = _cfgs(int8_weights=int8_weights, kv8=True)
    jp, tp = _params(jfloat, int8_weights)
    prompts = _prompts([5, 12])
    js = JScheduler(JA, jc, jp, JServingConfig(**SC))
    jr = [JRequest(uid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
    js.run(jr)
    ts = TScheduler(TA, tc, tp, TServingConfig(**SC), device="cpu")
    assert ts.kv_pool["k"].dtype == torch.int8 and ts.kv_pool["k_scale"].shape[1:] == (ts.num_blocks, 8, 2)
    tr = [TRequest(uid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
    ts.run(tr)
    for a, b in zip(jr, tr):
        assert b.done and a.output == b.output
        for x, y in zip(a.logits, b.logits):
            np.testing.assert_allclose(y, np.asarray(x), atol=1e-5, rtol=1e-5)
    assert ts.decode_weight_rounds() == 0


def test_recycled_int8_blocks_are_zeroed_scales_included(jfloat):
    _, tc = _cfgs(int8_weights=False, kv8=True)
    _, tp = _params(jfloat, False)
    ts = TScheduler(TA, tc, tp, TServingConfig(**SC), device="cpu")
    assert set(ts.kv_pool) == {"k", "v", "k_scale", "v_scale"}
    reserved = 1 + SC["batch_size"]
    for name in ("k_scale", "v_scale"):
        ts.kv_pool[name][:, reserved:] = float("nan")  # sentinels in every allocatable block
    for name in ("k", "v"):
        ts.kv_pool[name][:, reserved:] = 77
    reqs = [TRequest(uid=i, prompt=p, max_new_tokens=3) for i, p in enumerate(_prompts([9, 4]))]
    ts.run(reqs)
    assert all(np.isfinite(row).all() for r in reqs for row in r.logits)
    for leaf in ts.kv_pool.values():
        assert (leaf[:, 0] == 0).all()  # the NULL block, scales included, stays zero


# ---------------------------------------------------------------------------
# fuse_qkv_params
# ---------------------------------------------------------------------------
def _qkv_params(d, eng=None, bias=False, scaled=False, seed=0):
    rng = np.random.default_rng(seed)
    params = {}
    for name in ("wq", "wk", "wv"):
        w = torch.from_numpy((rng.normal(size=(d, d)) * d**-0.5).astype(np.float32))
        if eng is not None:
            p = pack_dense({"w": w}, eng)
        elif scaled:
            ws = torch.amax(torch.abs(w), dim=0) * (1.0 / 127.0)
            p = {"w": torch.round(w / ws).to(torch.int8), "w_scale": ws}
        else:
            p = {"w": w}
        if bias:
            p["b"] = torch.from_numpy((rng.normal(size=d) * 0.02).astype(np.float32))
        params[name] = p
    params["wo"] = {"w": torch.from_numpy((rng.normal(size=(d, d)) * d**-0.5).astype(np.float32))}
    return params


@pytest.mark.parametrize("channel", ["ideal", "asmw-crosstalk"])
@pytest.mark.parametrize("backend", ["kernel", "ref"])
@pytest.mark.parametrize("bias", [False, True])
def test_fused_packed_bank_equals_three_calls(channel, backend, bias):
    dpu = TIDEAL
    if channel != "ideal":  # deterministic analog: crosstalk and filter, no detector noise
        ch = tbuild("ASMW", n=16, bits=4).disable("detector")
        dpu = TDPU(organization="ASMW", bits=4, dpe_size=16, channel=ch)
    d, eng = 48, engine_for(dpu, backend)
    params = _qkv_params(d, eng=eng, bias=bias)
    fused = fuse_qkv_params(params, eng)
    assert "wqkv" in fused and "wq" not in fused and "wo" in fused
    pk = fused["wqkv"]["w"]
    assert isinstance(pk, PackedDense) and (pk.k, pk.c) == (d, 3 * d)
    if backend == "kernel":
        tile_k = pk.tiling[1]
        assert tuple(pk.wq.shape) == (-(-d // tile_k) * tile_k, 256)  # re-padded once for 3d = 144
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(3, d)).astype(np.float32))
    y = eng.matmul(x, pk, site="attn.wqkv", bias=fused["wqkv"].get("b"))
    parts = [eng.matmul(x, params[n]["w"], site=f"attn.{n}", bias=params[n].get("b")) for n in ("wq", "wk", "wv")]
    assert torch.equal(y, torch.cat(parts, dim=-1))


def test_fused_bank_matches_reference_layouts():
    jparams = {n: {"w": jnp.asarray(np.random.default_rng(i).normal(size=(32, 32)).astype(np.float32))}
               for i, n in enumerate(("wq", "wk", "wv", "wo"))}
    tparams = {n: {"w": torch.from_numpy(np.array(p["w"]))} for n, p in jparams.items()}
    want = jfuse(jparams, jengine_for(JIDEAL, "ref"))
    got = fuse_qkv_params(tparams, engine_for(TIDEAL, "ref"))
    assert got["wqkv"]["w"].shape == (32, 96)
    np.testing.assert_array_equal(got["wqkv"]["w"].numpy(), np.asarray(want["wqkv"]["w"]))
    scaled = fuse_qkv_params(_qkv_params(32, scaled=True), engine_for(TIDEAL, "ref"))
    assert scaled["wqkv"]["w"].dtype == torch.int8 and scaled["wqkv"]["w_scale"].shape == (96,)
    # The packed layout on the kernel backend: the reference's padded bank.
    jpk = jfuse({n: {"w": p["w"]} for n, p in jparams.items()}, jengine_for(JIDEAL, "pallas"))
    from repro.photonic.packing import pack_dense as jpack

    jpacked = {n: jpack(p, jengine_for(JIDEAL, "pallas")) for n, p in jparams.items()}
    tpacked = {n: pack_dense(p, engine_for(TIDEAL, "kernel")) for n, p in tparams.items()}
    jpk = jfuse(jpacked, jengine_for(JIDEAL, "pallas"))["wqkv"]["w"]
    tpk = fuse_qkv_params(tpacked, engine_for(TIDEAL, "kernel"))["wqkv"]["w"]
    np.testing.assert_array_equal(tpk.wq.numpy(), np.asarray(jpk.wq))
    np.testing.assert_array_equal(tpk.w_scale.numpy(), np.asarray(jpk.w_scale))
    assert tpk.tiling == jpk.tiling and (tpk.k, tpk.c) == (jpk.k, jpk.c)


def test_fuse_qkv_errors():
    eng = engine_for(TIDEAL, "ref")
    mixed = _qkv_params(32, eng=eng)
    mixed["wk"] = {"w": torch.ones(32, 32)}
    with pytest.raises(ValueError, match="mix"):
        fuse_qkv_params(mixed, eng)
    partial = _qkv_params(32, eng=eng, bias=True)
    del partial["wk"]["b"]
    with pytest.raises(ValueError, match="bias"):
        fuse_qkv_params(partial, eng)
    missing = _qkv_params(32, eng=eng)
    del missing["wv"]
    with pytest.raises(KeyError, match="wv"):
        fuse_qkv_params(missing, eng)


def test_noisy_fused_pack_carries_its_own_word():
    ch = tbuild("SMWA", n=16, bits=4)
    eng = engine_for(TDPU(organization="SMWA", bits=4, dpe_size=16, channel=ch, noise_seed=1), "kernel")
    fused = fuse_qkv_params(_qkv_params(32, eng=eng), eng)["wqkv"]["w"]
    assert int(fused.w_word) == int(tweak_word(fused.wq[: fused.k, : fused.c]))


def test_qkv_proj_uses_the_fused_bank(monkeypatch):
    cfg = ModelConfig(d_model=32, num_heads=4, num_kv_heads=2, num_layers=1, photonic=TIDEAL,
                      photonic_backend="kernel")
    params = init_params(cfg, 0, "cpu", defs=tattn.gqa_def(cfg))
    fused = fuse_qkv_params(params, engine_for(TIDEAL, "kernel"))
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(1, 4, 32)).astype(np.float32))
    pos = torch.arange(4)
    sites = []
    real = tattn.dense

    def spy(p, x, cfg, *, site=None, layer=None, **kw):
        sites.append(site)
        return real(p, x, cfg, site=site, layer=layer, **kw)

    monkeypatch.setattr(tattn, "dense", spy)
    y_sep = tattn.gqa_attention(params, x, cfg, positions=pos)
    assert sites == ["attn.wq", "attn.wk", "attn.wv", "attn.wo"]
    sites.clear()
    y_fused = tattn.gqa_attention(fused, x, cfg, positions=pos)
    assert sites == ["attn.wqkv", "attn.wo"]
    assert torch.equal(y_sep, y_fused)


def test_scheduler_fused_tokens_equal_three_site_tokens(jfloat):
    _, tc = _cfgs(int8_weights=True, kv8=True)
    _, tp = _params(jfloat, True)
    outs = []
    for fuse in (False, True):
        ts = TScheduler(TA, tc, tp, TServingConfig(**SC), device="cpu")
        if fuse:
            for layer in ts.params["layers"]:
                layer["attn"] = fuse_qkv_params(layer["attn"], ts.photonic)
        reqs = [TRequest(uid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(_prompts([5, 12]))]
        ts.run(reqs)
        outs.append(reqs)
    for a, b in zip(*outs):
        assert a.output == b.output
        for x, y in zip(a.logits, b.logits):
            np.testing.assert_array_equal(x, y)


def test_params_from_jax_carries_a_fused_bank(jfloat):
    """A reference tree whose attention holds a fused ``wqkv`` (int8 with
    its f32 scale, or float) comes across bitwise, each leaf in its dtype."""
    jc, tc = _cfgs(int8_weights=True, kv8=False)
    jq = jquantize(jfloat, JA.param_defs(jc))
    tc16 = dataclasses.replace(tc, param_dtype=torch.bfloat16)
    for tree, w_dtype in ((jq, torch.int8), (jfloat, torch.bfloat16)):
        fused = dict(tree, layers=dict(tree["layers"], attn=jfuse(tree["layers"]["attn"], jengine_for(JIDEAL, "ref"))))
        carried = params_from_jax(_np(fused), tc16, "cpu")
        for i, layer in enumerate(carried["layers"]):
            got, want = layer["attn"]["wqkv"], fused["layers"]["attn"]["wqkv"]
            assert set(got) == set(want) and "wq" not in layer["attn"]
            assert got["w"].dtype == w_dtype and got["b"].dtype == torch.bfloat16
            if w_dtype == torch.int8:
                assert got["w_scale"].dtype == torch.float32
                np.testing.assert_array_equal(got["w_scale"].numpy(), np.asarray(want["w_scale"])[i])
                np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"])[i])
