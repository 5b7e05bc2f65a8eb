"""The port's tensor-parallel (K-sharded) photonic execution against the
JAX reference and against the unsharded port.

Ports ``tests/test_sharded_engine.py`` (DESIGN.md §10).  The test run's JAX
sees one CPU device, so the reference is held without a mesh: its
``psum_int_gemm`` is the sum over shards ``i`` of
``shard_local_engine(engine, K/s).int_gemm(xq_i, wq_i, shard=int32(i))``,
which these tests call directly.  Held here:

* ``shard_local_channel`` and ``DPUConfig.shard_local``: field for field
  the reference's, for the three orders and s in {2, 4}, with disabled
  stages, a replaced sigma, a hand-built model and the no-op;
* the shard stream: ``stream_seed(shard=i)`` on the seed and key paths,
  with and without a plane, bitwise;
* per-GEMM sums over shards, in process: the ideal channel bitwise (and
  equal to ``exact_int_gemm``); under noise the stream seeds are bitwise
  but the Box-Muller draws only ulp-close (f32 ``log``/``cos`` differ
  between XLA and torch), and the reference's interpret mode contracts the
  crosstalk adds into an FMA (ROADMAP Queue 3), so a shard's psum may
  round one LSB apart: at most 0.1% of the summed outputs may differ, each
  by at most two top-pass LSBs per shard (``2 * s * 2^(2B)``);
* ``pack_dense(shards=2)`` bitwise the reference's, and the reference's
  sharded pack carried across by ``repro_torch.weights``;
* on spawned ``gloo`` groups of 2 and 4 ranks (``_torch_tp_ranks``, one
  group per size for the module): ``dense`` under ``tensor_parallel`` —
  float (f32 and bf16 activations), K-sharded packs each rank holding its
  block, the int8-stored layout, bit-sliced, ``manual_tp`` — bitwise the
  unsharded port on the ideal channel with one all-reduce each; K not
  divisible and an unrouted site fall through bitwise with none; a bad
  axis raises; noisy runs deterministic, key-sensitive, unlike the
  unsharded draw, and decorrelated across shards; STE gradients equal the
  unsharded backward; qwen2-0.5b's smoke config served through
  ``Engine(mesh=)``: tokens equal TP = 1's, zero weight-shaped rounds in
  decode, all-reduces equal to TP = 1's routed GEMMs.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import _torch_tp_ranks as ranks  # noqa: E402
from repro.core.dpu import DPUConfig as JDPU  # noqa: E402
from repro.noise.channel import ChannelModel as JChannel  # noqa: E402
from repro.noise.channel import build_channel_model as jbuild  # noqa: E402
from repro.noise.channel import shard_local_channel as jshard_channel  # noqa: E402
from repro.photonic import engine_for as jengine_for  # noqa: E402
from repro.photonic import shard_local_engine as jshard_engine  # noqa: E402
from repro.photonic.packing import pack_dense as jpack  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core.dpu import DPUConfig as TDPU  # noqa: E402
from repro_torch.kernels.photonic_gemm.ref import exact_int_gemm  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.models.common import ModelConfig  # noqa: E402
from repro_torch.noise.channel import ChannelModel  # noqa: E402
from repro_torch.noise.channel import build_channel_model as tbuild  # noqa: E402
from repro_torch.noise.channel import shard_local_channel  # noqa: E402
from repro_torch.noise.stages import tweak_word  # noqa: E402
from repro_torch.photonic import (  # noqa: E402
    PackedDense,
    engine_for,
    fuse_qkv_params,
    pack_dense,
    shard_local_engine,
)
from repro_torch.photonic.engine import SHARD_STREAM_TAG  # noqa: E402
from repro_torch.weights import packed_from_jax, params_from_jax  # noqa: E402

ORGS = ("ASMW", "MASW", "SMWA")
BACKEND = {"kernel": "pallas", "ref": "ref"}
JKEY, TKEY = jax.random.PRNGKey(21), prng.PRNGKey(21)


def _fields(ch) -> dict:
    return {f.name: getattr(ch, f.name) for f in dataclasses.fields(ch)}


def _dpus(org, n=64, seed=3):
    if org == "ideal":
        return JDPU(organization="SMWA", bits=4, dpe_size=n), TDPU(organization="SMWA", bits=4, dpe_size=n)
    return (
        JDPU(organization=org, bits=4, dpe_size=n, channel=jbuild(org, n=n, bits=4), noise_seed=seed),
        TDPU(organization=org, bits=4, dpe_size=n, channel=tbuild(org, n=n, bits=4), noise_seed=seed),
    )


def _ints(seed=1, r=16, k=64, c=72):
    rng = np.random.default_rng(seed)
    return rng.integers(-127, 128, (r, k)).astype(np.int8), rng.integers(-127, 128, (k, c)).astype(np.int8)


# ---------------------------------------------------------------------------
# Shard-local operating points
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("org", ORGS)
def test_shard_local_channel_field_for_field(org, shards):
    k = 64
    want = jshard_channel(jbuild(org, n=k, bits=4, datarate_gs=5.0), k // shards)
    got = shard_local_channel(tbuild(org, n=k, bits=4, datarate_gs=5.0), k // shards)
    assert _fields(got) == _fields(want)
    assert got == tbuild(org, n=k // shards, bits=4, datarate_gs=5.0)


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("org", ORGS)
def test_dpu_shard_local_field_for_field(org, shards):
    jd, td = _dpus(org)
    want, got = jd.shard_local(64 // shards), td.shard_local(64 // shards)
    assert (got.n, got.dpe_size) == (want.n, want.dpe_size) == (64 // shards, 64 // shards)
    assert _fields(got.channel) == _fields(want.channel)
    ji, ti = _dpus("ideal")
    assert ti.shard_local(64 // shards).n == ji.shard_local(64 // shards).n == 64 // shards
    assert ti.shard_local(64 // shards).channel is None


def test_shard_local_channel_keeps_the_callers_stages():
    # Disabled stages stay disabled; a replaced sigma survives; a hand-built
    # model keeps its magnitudes; no-op at n_local >= n.
    for jch, tch in (
        (jbuild("ASMW", n=64).disable("detector", "filter"), tbuild("ASMW", n=64).disable("detector", "filter")),
        (dataclasses.replace(jbuild("ASMW", n=64), detector_sigma_lsb=123.5),
         dataclasses.replace(tbuild("ASMW", n=64), detector_sigma_lsb=123.5)),
        (JChannel(n=32, detector_sigma_lsb=0.5, filter_alpha=0.01),
         ChannelModel(n=32, detector_sigma_lsb=0.5, filter_alpha=0.01)),
    ):
        assert _fields(shard_local_channel(tch, 8)) == _fields(jshard_channel(jch, 8))
    base = tbuild("SMWA", n=16)
    assert shard_local_channel(base, 16) is base and shard_local_channel(base, 64) is base
    local = shard_local_channel(tbuild("ASMW", n=64), 8)
    assert local.snr_db > tbuild("ASMW", n=64).snr_db and local.detector_sigma_lsb < tbuild("ASMW", n=64).detector_sigma_lsb


def test_shard_local_engine_uses_n_local():
    _, td = _dpus("ASMW")
    local = shard_local_engine(engine_for(td, "ref"), 8)
    assert local.dpu.n == 8 and local.dpu.channel == tbuild("ASMW", n=8, bits=4, datarate_gs=5.0)
    assert shard_local_engine(engine_for(td, "ref"), 8) is local  # cached


# ---------------------------------------------------------------------------
# The shard stream
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("keyed", [False, True])
def test_stream_seed_folds_the_shard_as_the_reference_does(keyed):
    jd, td = _dpus("SMWA")
    xq, wq = _ints(4, 6, 30, 20)
    jeng, teng = jengine_for(jd, "ref"), engine_for(td, "ref")
    seen = set()
    for site, fold, shard, plane in (("attn.wq", 2, 0, None), ("attn.wq", 2, 1, None), ("ffn.wo", None, 3, 5),
                                     (None, 7, 1, 0), (None, None, 0, None), ("s", None, None, None)):
        want = int(jeng.stream_seed(site, None if fold is None else jnp.int32(fold), JKEY if keyed else None,
                                    jnp.asarray(xq), jnp.asarray(wq),
                                    shard=None if shard is None else jnp.int32(shard), plane=plane))
        got = int(teng.stream_seed(site, fold, torch.from_numpy(xq), torch.from_numpy(wq),
                                   prng_key=TKEY if keyed else None, shard=shard, plane=plane))
        assert got == want
        seen.add(got)
    assert len(seen) == 6
    # (site, fold=i) and (site, shard=i) are different streams.
    a = teng.stream_seed("s", 3, torch.from_numpy(xq), torch.from_numpy(wq))
    b = teng.stream_seed("s", None, torch.from_numpy(xq), torch.from_numpy(wq), shard=3)
    assert int(a) != int(b) and SHARD_STREAM_TAG == 0x5348


# ---------------------------------------------------------------------------
# Per-GEMM sums over shards against the reference's
# ---------------------------------------------------------------------------
def _shard_sums(jd, td, backend, xq, wq, shards, *, keyed=False, slicing=None, jit=True):
    k = xq.shape[1]
    kl = k // shards
    jl = jshard_engine(jengine_for(jd, BACKEND[backend]), kl)
    tl = shard_local_engine(engine_for(td, backend), kl)
    want = got = 0
    parts = []
    # One jitted reference call for every shard (the shard index traced,
    # as lax.axis_index is): the reference's eager ref backend is slow on
    # CPU; the sliced interpret-mode kernel runs faster eagerly.
    def ref(x, w, s):
        return jl.int_gemm(x, w, site="attn.wq", fold=jnp.int32(1), shard=s,
                           prng_key=JKEY if keyed else None, slicing=slicing)

    if jit:
        ref = jax.jit(ref)
    for i in range(shards):
        xs, ws = xq[:, i * kl:(i + 1) * kl], wq[i * kl:(i + 1) * kl]
        w_i = np.asarray(ref(jnp.asarray(xs), jnp.asarray(ws), jnp.int32(i)), np.int64)
        g_i = tl.int_gemm(torch.from_numpy(xs), torch.from_numpy(ws), site="attn.wq", fold=1, shard=i,
                          prng_key=TKEY if keyed else None, slicing=slicing).numpy().astype(np.int64)
        want, got = want + w_i, got + g_i
        parts.append(g_i)
    return got, want, parts


def _noisy_tier(got, want, shards, top):
    d = np.abs(got - want)
    assert (d > 0).mean() <= 1e-3 and d.max() <= 2 * shards * top, (int((d > 0).sum()), int(d.max()))


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("backend", ["kernel", "ref"])
def test_ideal_shard_sum_is_bitwise_the_reference_and_exact(backend, shards):
    jd, td = _dpus("ideal", n=32)
    xq, wq = _ints(1)
    got, want, _ = _shard_sums(jd, td, backend, xq, wq, shards)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, exact_int_gemm(torch.from_numpy(xq), torch.from_numpy(wq)).numpy())


@pytest.mark.parametrize("keyed", [False, True])
@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("org", ["SMWA", "ASMW"])
def test_noisy_shard_sum_matches_the_reference(org, shards, keyed):
    # dpe 64 > K/shards: every shard runs a channel rebuilt at N_local.  The
    # ref backend on both sides (the kernel's noise ids follow its tiling;
    # the Pallas interpret kernel under noise takes ~40 s to compile here,
    # and the sliced test below holds the kernel path's shard stream).
    jd, td = _dpus(org, n=64)
    xq, wq = _ints(2)
    got, want, parts = _shard_sums(jd, td, "ref", xq, wq, shards, keyed=keyed)
    _noisy_tier(got, want, shards, 2 ** 8)
    assert not np.array_equal(parts[0], parts[1])


def test_sliced_shard_sum_matches_the_reference():
    # Bit-sliced passes of each shard fold (shard, plane) into the stream.
    for org in ("ideal", "SMWA"):
        jd, td = _dpus(org, n=64)
        xq, wq = _ints(3, r=8, c=24)
        got, want, _ = _shard_sums(jd, td, "kernel", xq, wq, 2, slicing=2, jit=False)
        if org == "ideal":
            np.testing.assert_array_equal(got, want)
        else:
            d = np.abs(got - want)
            assert (d > 0).mean() <= 1e-2 and d.max() <= 2 * 2 * 2 * 2 ** (2 * 2 * 3)


# ---------------------------------------------------------------------------
# K-sharded packs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("org,backend", [("ideal", "kernel"), ("ASMW", "kernel"), ("SMWA", "ref")])
def test_pack_dense_shards_bitwise_the_reference(org, backend):
    jd, td = _dpus(org, n=64)
    rng = np.random.default_rng(5)
    w = rng.normal(size=(96, 40)).astype(np.float32)
    want = jpack({"w": jnp.asarray(w)}, jengine_for(jd, BACKEND[backend]), shards=2)["w"]
    got = pack_dense({"w": torch.from_numpy(w)}, engine_for(td, backend), shards=2)["w"]
    assert (got.k, got.c, got.tiling, got.shards, got.k_local) == (want.k, want.c, want.tiling, want.shards, 48)
    np.testing.assert_array_equal(got.wq.numpy(), np.asarray(want.wq))
    np.testing.assert_array_equal(got.w_scale.numpy(), np.asarray(want.w_scale))
    np.testing.assert_array_equal(got.dequant().numpy(), np.asarray(want.dequant()))
    # Carried across from the reference, the pack is the port's own.
    across = packed_from_jax(want, words=engine_for(td, backend).noisy, device="cpu")
    assert (across.k, across.c, across.tiling, across.shards) == (got.k, got.c, got.tiling, got.shards)
    assert torch.equal(across.wq, got.wq) and torch.equal(across.w_scale, got.w_scale)
    assert (across.w_word is None) == (got.w_word is None)
    if got.w_word is not None:
        assert torch.equal(across.w_word, got.w_word)
        for i in range(2):
            assert int(got.local(i, 2).w_word) == int(tweak_word(got.local(i, 2).wq))


def test_a_stacked_sharded_reference_pack_comes_across_layer_by_layer():
    # The reference packs a stacked (L, K, C) weight K-sharded; the port's
    # tree takes one pack a layer, each the port's own pack of that layer.
    jd, td = _dpus("ASMW", n=64)
    w = np.random.default_rng(8).normal(size=(3, 96, 40)).astype(np.float32)
    jtree = {"layers": {"attn": {"wq": jpack({"w": jnp.asarray(w)}, jengine_for(jd, "pallas"), shards=2)}}}
    got = params_from_jax(jtree, ModelConfig(), device="cpu")["layers"]
    assert len(got) == 3
    for i, layer in enumerate(got):
        pk = layer["attn"]["wq"]["w"]
        want = pack_dense({"w": torch.from_numpy(w[i])}, engine_for(td, "kernel"), shards=2)["w"]
        assert (pk.k, pk.c, pk.tiling, pk.shards) == (want.k, want.c, want.tiling, want.shards)
        assert torch.equal(pk.wq, want.wq) and torch.equal(pk.w_scale, want.w_scale)


def test_sharded_pack_blocks_views_and_refusals():
    _, td = _dpus("ASMW", n=64)
    eng = engine_for(td, "kernel")
    w = torch.from_numpy(np.random.default_rng(6).normal(size=(96, 40)).astype(np.float32))
    pk = pack_dense({"w": w}, eng, shards=2)["w"]
    own = pk.only(1)
    assert own.shard == 1 and tuple(own.wq.shape) == (tuple(pk.wq.shape)[0] // 2, pk.wq.shape[1])
    assert torch.equal(own.local(1, 2).wq, pk.local(1, 2).wq)
    assert torch.equal(own.dequant(), pk.dequant()[48:])
    with pytest.raises(ValueError, match="holds shard 1 only"):
        own.local(0, 2)
    with pytest.raises(ValueError, match="cannot be split"):
        pk.local(0, 4)
    with pytest.raises(ValueError, match="K-sharded"):
        eng.matmul(torch.zeros(2, 96), pk)
    with pytest.raises(ValueError, match="not divisible"):
        pack_dense({"w": w[:95]}, eng, shards=2)
    attn = {n: pack_dense({"w": w}, eng, shards=2) for n in ("wq", "wk", "wv")}
    with pytest.raises(ValueError, match="K-sharded packs not supported"):
        fuse_qkv_params(attn, eng)
    assert isinstance(pk, PackedDense) and "shards=2" in repr(pk) and "shard=1" in repr(own)


# ---------------------------------------------------------------------------
# On spawned gloo groups
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=[2, 4], ids=["tp2", "tp4"])
def group(request):
    return request.param, spawn(ranks.tp_suite, request.param, backend="gloo", timeout=300)


def _same_on_every_rank(res, key):
    for r in res[1:]:
        np.testing.assert_array_equal(r[key][1], res[0][key][1])


@pytest.mark.parametrize("chan,backend", [("ideal", "kernel"), ("ideal", "ref"), ("ideal", "exact")])
@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16"])
def test_dense_float_weights_under_tp_bitwise_unsharded(group, chan, backend, dtype):
    _, res = group
    key = f"float/{chan}/{backend}/{dtype}"
    for r in res:
        base, tp, n = r["dense"][key]
        np.testing.assert_array_equal(tp, base)
        assert n == 1
    assert [r["dense"]["axis_rank"] for r in res] == list(range(len(res)))


@pytest.mark.parametrize("backend", ["kernel", "ref", "exact"])
def test_dense_sharded_pack_under_tp_bitwise_unsharded(group, backend):
    world, res = group
    for i, r in enumerate(res):
        base, tp, n = r["dense"][f"packed/ideal/{backend}"]
        np.testing.assert_array_equal(tp, base)
        assert n == 1
        shards, shard, _ = r["dense"][f"packed_layout/ideal/{backend}"]
        assert (shards, shard) == (world, i)


@pytest.mark.parametrize("key", ["int8_layout", "sliced/ideal", "manual/ideal"])
def test_int8_layout_sliced_and_manual_under_tp_bitwise_unsharded(group, key):
    _, res = group
    for r in res:
        base, tp, n = r["dense"][key]
        np.testing.assert_array_equal(tp, base)
        assert n == 1


@pytest.mark.parametrize("key", ["fall/odd_k", "fall/unrouted"])
def test_indivisible_k_and_unrouted_sites_fall_through(group, key):
    _, res = group
    for r in res:
        base, tp, n = r["dense"][key]
        np.testing.assert_array_equal(tp, base)
        assert n == 0


def test_bad_axis_raises(group):
    _, res = group
    assert res[0]["dense"]["bad_axis"] == "mesh has no axis 'tensor'; axes are ('data', 'model')"


@pytest.mark.parametrize("org", ["SMWA", "ASMW"])
def test_noisy_tp_is_deterministic_and_decorrelated(group, org):
    _, res = group
    for r in res:
        v = r["dense"][f"noise/{org}"]
        np.testing.assert_array_equal(v["y1"], v["y2"])
        np.testing.assert_array_equal(v["k1"], v["k1b"])
        assert not np.array_equal(v["k1"], v["k2"]) and not np.array_equal(v["k1"], v["y1"])
        assert not np.array_equal(v["y1"], v["base"])  # not the unsharded draw
        assert np.all(np.isfinite(v["y1"]))
    for name in ("y1", "k1"):
        for r in res[1:]:
            np.testing.assert_array_equal(r["dense"][f"noise/{org}"][name], res[0]["dense"][f"noise/{org}"][name])
    partials = [r["dense"][f"partial/{org}"] for r in res]
    for i in range(len(partials)):
        for j in range(i):
            assert not np.array_equal(partials[i], partials[j])
    for r in res:
        for key in (f"float/{org}/kernel/torch.float32", f"packed/{org}/kernel"):
            assert r["dense"][key][2] == 1
    _same_on_every_rank([r["dense"] for r in res], f"packed/{org}/kernel")


@pytest.mark.parametrize("kind", ["float", "packed"])
def test_ste_gradients_equal_the_unsharded_backward(group, kind):
    _, res = group
    for r in res:
        base, tp = r["dense"][f"grad/{kind}"]
        assert sorted(base) == sorted(tp) == (["db", "dw", "dx"] if kind == "float" else ["db", "dx"])
        for name in base:
            np.testing.assert_array_equal(tp[name], base[name])


def test_engine_mesh_serves_tp1_tokens_with_one_all_reduce_per_routed_gemm(group):
    world, res = group
    for r in res:
        runs = r["serve"]["ideal"]
        assert runs["tp"]["tokens"] == runs["tp1"]["tokens"] == runs["tp_again"]["tokens"]
        assert runs["tp1"]["all_reduces"] == 0 and runs["tp"]["routed"] == 0
        assert runs["tp"]["all_reduces"] == runs["tp1"]["routed"] == 6 * r["serve"]["layers"] * runs["tp"]["forwards"]
        assert runs["tp"]["decode_rounds"] == 0
    assert all(r["serve"]["ideal"]["tp"]["tokens"] == res[0]["serve"]["ideal"]["tp"]["tokens"] for r in res)
