"""The port's audio family (the whisper encoder-decoder) against the
reference, at whisper-medium's smoke config (2 encoder + 2 decoder
layers, d 64, gelu MLP) with the reference's weights carried over
(``params_from_jax``) and f32 ``audio_embed`` frames, as the reference's
own tests feed them (the encoder's residual stream then stays f32).

Held here, digitally and on the ideal channel (the port's kernel twin
against the reference's ``ref``, both exact), within ``atol=1e-5,
rtol=1e-5``, except that a whole model on the ideal channel may carry a
quantization flip (an f32 activation within an ulp of an int8 rounding
boundary takes the next code on one side, since the packages' f32 sums run
in other orders), and is then held to the chip's bf16 floor (max |d| <=
2e-2 of the max magnitude, argmax agreement >= 0.9 on logits):

* ``FULL`` and ``SMOKE`` equal the reference's field for field;
* ``encode`` with ``attn_impl`` "chunked" and "flash" (non-causal, 30
  frames: a ragged key block; the reference's flash core is its Pallas
  kernel in interpret mode, the port's the kernel's plain twin);
* ``whisper_logits`` and the ``whisper_loss`` forward value;
  ``whisper_prefill`` + ``whisper_decode`` logits and caches (``self``
  stacked, the ``cross`` K/V pair over the encoder frames, ``pos``);
* the reference's contracts for the family, ported: prefill + decode equal
  the teacher-forced forward within 1e-3 (``tests/test_archs_smoke.py``);
  the int8 KV cache stays close to f32 (relative norm < 0.05, argmax
  agreement >= 0.9; ``tests/test_quantized_serving.py``), and the port's
  int8 run equals the reference's; prepack and call-time site names agree
  (``tests/test_photonic_engine.py``);
* routed GEMMs: 6 an encoder layer and 10 a decoder layer (with the cross
  layer's ``wk``/``wv`` over the encoder frames) + the head per prefill, 8
  a decoder layer + the head per decode step, none with a layer fold (the
  reference passes no ``layer=``: all encoder layers share one stream per
  site, as do all decoder layers);
* a reference checkpoint of the stacked ``enc_layers`` / ``dec_layers``
  restores into the port bit for bit; ``LegacyEngine`` (and ``Engine``)
  refuses the family, naming the registry's ``prefill`` / ``decode``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.core.dpu import DPUConfig as JDPU  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import whisper as jwh  # noqa: E402
from repro.models.common import init_tree  # noqa: E402
from repro_torch._tree import tree_items, tree_map  # noqa: E402
from repro_torch.checkpoint import ckpt as tckpt  # noqa: E402
from repro_torch.core.dpu import DPUConfig as TDPU  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models import whisper as twh  # noqa: E402
from repro_torch.photonic.packing import _is_dense_def, site_name  # noqa: E402
from repro_torch.runtime import serve as tserve  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

NAME = "whisper-medium"
JA, TA = jreg.get(NAME), treg.get(NAME)
DTYPE = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
MODES = pytest.mark.parametrize("photonic", [False, True], ids=["digital", "ideal-photonic"])
B, T, T_ENC = 2, 16, 30


def _cfgs(photonic, **kw):
    jc = dataclasses.replace(JA.smoke_config, remat=False, **kw)
    tc = dataclasses.replace(TA.smoke_config, **kw)
    if photonic:
        jc = dataclasses.replace(jc, photonic=JDPU(organization="SMWA", bits=4, dpe_size=16), photonic_backend="ref")
        tc = dataclasses.replace(tc, photonic=TDPU(organization="SMWA", bits=4, dpe_size=16),
                                 photonic_backend="kernel")
    return jc, tc


@pytest.fixture(scope="module")
def params():
    """The reference's smoke weights, jitted (one program instead of an
    op-by-op compile per leaf): ``(jax tree, numpy tree)``."""
    jp = jax.jit(lambda k: init_tree(JA.param_defs(JA.smoke_config), k, jnp.float32))(jax.random.PRNGKey(0))
    return jp, jax.tree.map(np.asarray, jp)


def _batch(seed=0, n=T):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, TA.smoke_config.vocab_size, (B, n)).astype(np.int32)
    audio = rng.normal(size=(B, T_ENC, TA.smoke_config.d_model)).astype(np.float32)
    return {"tokens": toks, "audio_embed": audio}


def _torch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v) for k, v in batch.items()}


def _ideal_tier(got, want, photonic, logits=True):
    """1e-5 digitally; on the ideal channel 1e-5, or, after a quantization
    flip (module docstring), max |d| <= 2e-2 of max |want| and, on logits,
    argmax agreement >= 0.9."""
    got, want = got.numpy().astype(np.float64), np.asarray(want, np.float64)
    if not photonic or np.allclose(got, want, atol=1e-5, rtol=1e-5):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        return
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
    if logits:
        assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.9


def test_configs_match_reference_field_for_field():
    for jc, tc in ((JA.config, TA.config), (JA.smoke_config, TA.smoke_config)):
        for f in dataclasses.fields(tc):
            if f.name == "photonic_backend":
                continue
            jv, tv = getattr(jc, f.name), getattr(tc, f.name)
            assert (DTYPE[jv] == tv) if jv in DTYPE else jv == tv, f.name
    assert TA.skip_shapes == JA.skip_shapes and TA.family == JA.family == "audio"


@MODES
@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_encode_matches_reference(params, photonic, impl):
    jc, tc = _cfgs(photonic, attn_impl=impl)
    batch = _batch()
    want = jax.jit(lambda p, a: jwh.encode(p, a, jc))(params[0], batch["audio_embed"])
    with torch.no_grad():
        got = twh.encode(params_from_jax(params[1], tc, "cpu"), torch.from_numpy(batch["audio_embed"]), tc)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, T_ENC, tc.d_model)
    _ideal_tier(got, want, photonic, logits=False)


@MODES
def test_whisper_logits_and_loss_match_reference(params, photonic):
    jc, tc = _cfgs(photonic)
    tp = params_from_jax(params[1], tc, "cpu")
    batch = dict(_batch(1))
    batch["labels"] = np.roll(batch["tokens"], -1, axis=1)
    want, _ = jax.jit(lambda p, b: jwh.whisper_logits(p, b, jc))(params[0], batch)
    want_loss = jax.jit(lambda p, b: JA.loss(p, b, jc))(params[0], batch)
    with torch.no_grad():
        got, aux = twh.whisper_logits(tp, _torch(batch), tc)
        loss = TA.loss(tp, _torch(batch), tc)
    assert tuple(got.shape) == (B, T, tc.n_vocab) and float(aux) == 0.0
    _ideal_tier(got, want, photonic)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-3 if photonic else 1e-6)


@MODES
def test_prefill_and_decode_match_reference(params, photonic):
    """``Arch.prefill`` of 12 tokens, then 4 decode steps: logits and every
    cache leaf against the reference's."""
    jc, tc = _cfgs(photonic)
    tp = params_from_jax(params[1], tc, "cpu")
    batch = _batch(2)
    toks = batch["tokens"]
    pre = {"tokens": toks[:, :12], "audio_embed": batch["audio_embed"]}
    jl, jcache = jax.jit(lambda p, b: JA.prefill(p, b, jc, T))(params[0], pre)
    jdec = jax.jit(lambda p, x, c: JA.decode(p, x, c, jc))
    with torch.no_grad():
        tl, tcache = TA.prefill(tp, _torch(pre), tc, T)
    _ideal_tier(tl, jl, photonic)
    assert set(tcache) == set(jcache) == {"self", "cross", "pos"}
    for i in range(2):
        assert tuple(tcache["cross"][i].shape) == jcache["cross"][i].shape == (
            tc.num_layers, B, T_ENC, tc.num_kv_heads, tc.hd)
        _ideal_tier(tcache["cross"][i], jcache["cross"][i], photonic, logits=False)
    for i in range(12, T):
        jl, jcache = jdec(params[0], toks[:, i: i + 1], jcache)
        with torch.no_grad():
            tl, tcache = TA.decode(tp, torch.from_numpy(toks[:, i: i + 1]).long(), tcache, tc)
        _ideal_tier(tl, jl, photonic)
    assert tcache["pos"] == int(jcache["pos"]) == T
    for k in ("k", "v"):
        assert tuple(tcache["self"][k].shape) == jcache["self"][k].shape == (
            tc.num_layers, B, T, tc.num_kv_heads, tc.hd)
        _ideal_tier(tcache["self"][k], jcache["self"][k], photonic, logits=False)


def test_prefill_decode_matches_full_forward(params):
    """Port of the reference's contract (``tests/test_archs_smoke.py``):
    prefill of T - 4 tokens and 4 decode steps equal the teacher-forced
    forward within 1e-3."""
    _, tc = _cfgs(False)
    tp = params_from_jax(params[1], tc, "cpu")
    batch = _torch(_batch(3))
    toks = batch["tokens"]
    with torch.no_grad():
        full, _ = twh.whisper_logits(tp, batch, tc)
        logits, cache = TA.prefill(tp, {"tokens": toks[:, : T - 4], "audio_embed": batch["audio_embed"]}, tc, T)
        assert tuple(logits.shape) == (B, 1, tc.n_vocab)
        errs = [float((logits[:, 0] - full[:, T - 5]).abs().max())]
        for i in range(T - 4, T):
            logits, cache = TA.decode(tp, toks[:, i: i + 1], cache, tc)
            errs.append(float((logits[:, 0] - full[:, i]).abs().max()))
    assert max(errs) < 1e-3, errs


def _roundtrip(arch, params, cfg, batch, jit=lambda f: f):
    """Prefill of T - 4 tokens and 4 decode steps; the logits concatenated."""
    prefill = jit(lambda p, b: arch.prefill(p, b, cfg, T))
    decode = jit(lambda p, x, c: arch.decode(p, x, c, cfg))
    toks = batch["tokens"]
    logits, cache = prefill(params, {"tokens": toks[:, : T - 4], "audio_embed": batch["audio_embed"]})
    outs = [logits]
    for i in range(T - 4, T):
        logits, cache = decode(params, toks[:, i: i + 1], cache)
        outs.append(logits)
    return outs


def test_int8_kv_cache_close_to_f32_and_to_the_reference(params):
    """Port of the reference's contract (``tests/test_quantized_serving.py``,
    the whisper case): the int8 self-attention cache (the cross K/V stay
    float, as there) keeps the logits within 0.05 relative norm of the
    float cache's and the argmax on >= 90% of positions; and the port's
    int8 run equals the reference's within 1e-5."""
    _, tc = _cfgs(False)
    jc8, tc8 = _cfgs(False, kv_cache_int8=True)
    tp = params_from_jax(params[1], tc, "cpu")
    batch = _batch(4)
    with torch.no_grad():
        f32 = torch.cat(_roundtrip(TA, tp, tc, _torch(batch)), dim=1)
        i8 = torch.cat(_roundtrip(TA, tp, tc8, _torch(batch)), dim=1)
        _, cache = TA.prefill(tp, {"tokens": _torch(batch)["tokens"][:, :8],
                                   "audio_embed": _torch(batch)["audio_embed"]}, tc8, T)
    assert cache["self"]["k"].dtype == torch.int8 and cache["cross"][0].dtype == torch.float32
    rel = float(torch.linalg.norm(i8 - f32) / torch.linalg.norm(f32))
    agree = float((i8.argmax(-1) == f32.argmax(-1)).float().mean())
    assert rel < 0.05 and agree >= 0.9, (rel, agree)
    want = jnp.concatenate(_roundtrip(JA, params[0], jc8, batch, jit=jax.jit), axis=1)
    np.testing.assert_allclose(i8.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


class _Recorder:
    """Records each engine float GEMM's (site, fold, rows); on the CPU
    each runs the fused kernel's twin."""

    def __init__(self, monkeypatch):
        import repro_torch.photonic.engine as E

        self.calls = []
        inner = E.PhotonicEngine.matmul_float

        def record(eng, x, w, *, site=None, fold=None, **kw):
            self.calls.append((site, fold, x.reshape(-1, x.shape[-1]).shape[0]))
            return inner(eng, x, w, site=site, fold=fold, **kw)

        monkeypatch.setattr(E.PhotonicEngine, "matmul_float", record)


def test_routed_gemms_per_prefill_and_decode_step(params, monkeypatch):
    _, tc = _cfgs(True)
    tp = params_from_jax(params[1], tc, "cpu")
    rec = _Recorder(monkeypatch)
    batch = _torch(_batch(5))
    with torch.no_grad():
        _, cache = TA.prefill(tp, {"tokens": batch["tokens"][:, :8], "audio_embed": batch["audio_embed"]}, tc, T)
        n_prefill = len(rec.calls)
        TA.decode(tp, batch["tokens"][:, 8:9], cache, tc)
    assert n_prefill == 6 * tc.encoder_layers + 10 * tc.num_layers + 1
    assert len(rec.calls) - n_prefill == 8 * tc.num_layers + 1
    assert {f for _, f, _ in rec.calls} == {None}
    enc_rows = [r for s, _, r in rec.calls[:n_prefill] if s in ("attn.wk", "attn.wv") and r == B * T_ENC]
    assert len(enc_rows) == 2 * tc.encoder_layers + 2 * tc.num_layers  # encoder self K/V and the cross K/V


def test_prepack_site_names_agree_with_call_time_sites(params, monkeypatch):
    """Port of the reference's contract (``tests/test_photonic_engine.py``):
    the site names prepack derives from the def tree (a decoder layer's
    ``cross`` dict maps to ``attn.*``) equal the ones the forward passes."""
    _, tc = _cfgs(True)

    def derived(d, path=()):
        if _is_dense_def(d):
            return {site_name(path)}
        items = d.items() if isinstance(d, dict) else enumerate(d) if isinstance(d, list) else ()
        return set().union(*[derived(v, path + (k,)) for k, v in items])

    rec = _Recorder(monkeypatch)
    with torch.no_grad():
        twh.whisper_logits(params_from_jax(params[1], tc, "cpu"), _torch(_batch(6)), tc)
    assert derived(TA.param_defs(tc)) == {s for s, _, _ in rec.calls} == {
        "attn.wq", "attn.wk", "attn.wv", "attn.wo", "ffn.wi", "ffn.wo", "lm_head"}


def test_reference_checkpoint_of_the_encoder_decoder_restores_bitwise(params, tmp_path):
    """The reference's ``ckpt.save`` of the smoke params (the stacked
    ``enc_layers`` and ``dec_layers``) restores into the port's lists bit
    for bit, and the port's own save round-trips."""
    _, tc = _cfgs(False)
    jckpt.save(tmp_path / "ref", 3, {"params": params[0]})
    want = params_from_jax(params[1], tc, "cpu")
    like = tree_map(torch.zeros_like, want)
    back = tckpt.restore(tmp_path / "ref", 3, {"params": like})["params"]
    tckpt.save(tmp_path / "port", 4, {"params": want})
    again = tckpt.restore(tmp_path / "port", 4, {"params": like})["params"]
    assert tree_items(back).keys() == tree_items(want).keys()
    for k, a in tree_items(want).items():
        assert torch.equal(tree_items(back)[k], a) and torch.equal(tree_items(again)[k], a), k
    names = tree_items({"params": back})
    assert "params/dec_layers/1/cross/wk/w" in names and "params/enc_layers/1/ffn/wi/w" in names


def test_cache_def_matches_the_prefill_cache(params):
    _, tc = _cfgs(False)
    tp = params_from_jax(params[1], tc, "cpu")
    with torch.no_grad():
        _, cache = TA.prefill(tp, _torch(_batch(7)), tc, T)
    cdef = TA.cache_def(tc, B, T, {"enc_seq": T_ENC}, torch.float32)
    assert {k: tuple(v.shape) for k, v in cache["self"].items()} == {k: v[0] for k, v in cdef["self"].items()}
    assert [tuple(c.shape) for c in cache["cross"]] == [c[0] for c in cdef["cross"]]
    assert cdef["pos"][0] == () and cache["pos"] == T


def test_engines_refuse_the_family_and_name_the_registry_entry_points(params):
    _, tc = _cfgs(True)
    tp = params_from_jax(params[1], tc, "cpu")
    for engine in (tserve.Engine, tserve.LegacyEngine):
        with pytest.raises(NotImplementedError, match=r"'audio'.*tokens only.*audio_embed.*prefill.*decode"):
            engine(TA, tc, tp, tserve.ServeConfig(batch_size=2, max_seq=T), device="cpu")
