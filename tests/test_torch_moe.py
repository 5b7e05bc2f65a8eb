"""The port's MoE family against the reference: the top-k MoE layer, the
MoE decoders' forward, the phi3.5-moe paged server, and the registry.

Held here, with the reference's weights carried over (``params_from_jax``)
and every routed GEMM on the ideal channel unless noted (the port's kernel
twin against the reference's ``ref``, both exact):

* ``FULL`` and ``SMOKE`` of deepseek-v2-lite-16b and phi3.5-moe-42b-a6.6b
  equal the reference's field for field;
* ``ffn.moe`` on the same inputs: the selected experts equal (the router
  is digital and ``_top_k`` orders ties as ``jax.lax.top_k``: lower index
  first), the aux loss within 1e-6 relative (the router's f32 logits are
  summed in another order), outputs within ``atol=1e-5`` (f32 einsums in
  other orders); cases: ideal, capacity binding (tokens dropped), all
  gates tied, and SMWA seeded (``noise_seed``; both sides on their ``ref``
  backend, which draws its own stream; the shared experts' psums may round
  one LSB apart, so at most 1% of outputs may leave 1e-5, each
  within 1e-2 of the output's max); and the reference's router contract
  tests (``tests/test_photonic_engine.py``), with a ``prng_key`` too;
* ``lm_logits`` and its summed aux at both smoke configs within 1e-5, and
  the number of routed GEMMs a forward makes (7 a layer + the head for
  deepseek-v2-lite, 4 a layer + the head for phi3.5-moe);
* phi3.5-moe on the paged ``Scheduler``: greedy tokens equal, logits
  within 1e-5;
* the checkpoint names of the unstacked ``first_block`` and the expert
  stacks: a reference checkpoint restores into the port bit for bit;
* ``registry.get`` of the vlm, ssm, hybrid and audio archs comes back
  with the reference's family and adapters, and the paged
  ``lm_prefill_chunk`` refuses vision cross-attention with the
  reference's message.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.core.dpu import DPUConfig as JDPU  # noqa: E402
from repro.models import ffn as jffn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models.common import ModelConfig as JModelConfig  # noqa: E402
from repro.models.common import dense as jdense  # noqa: E402
from repro.models.common import init_tree  # noqa: E402
from repro.noise.channel import build_channel_model as jbuild  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import Scheduler as JScheduler  # noqa: E402
from repro.serving import ServingConfig as JServingConfig  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch._tree import tree_items, tree_map  # noqa: E402
from repro_torch.checkpoint import ckpt as tckpt  # noqa: E402
from repro_torch.core.dpu import DPUConfig as TDPU  # noqa: E402
from repro_torch.models import ffn as tffn  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models.common import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.models.common import dense as tdense  # noqa: E402
from repro_torch.noise.channel import build_channel_model as tbuild  # noqa: E402
from repro_torch.photonic import PackedDense  # noqa: E402
from repro_torch.serving import Request as TRequest  # noqa: E402
from repro_torch.serving import Scheduler as TScheduler  # noqa: E402
from repro_torch.serving import ServingConfig as TServingConfig  # noqa: E402
from repro_torch.serving import prepack_serving_params  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

NAMES = ["deepseek-v2-lite-16b", "phi3.5-moe-42b-a6.6b"]
DTYPE = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
MOE = dict(d_model=32, d_ff=64, num_experts=8, num_experts_per_tok=2, num_shared_experts=1, moe_d_ff=24)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _ideal():
    return JDPU(organization="SMWA", bits=4, dpe_size=16), TDPU(organization="SMWA", bits=4, dpe_size=16)


def _smwa():
    return (
        JDPU(organization="SMWA", bits=4, dpe_size=16, channel=jbuild("SMWA", n=16, bits=4), noise_seed=5),
        TDPU(organization="SMWA", bits=4, dpe_size=16, channel=tbuild("SMWA", n=16, bits=4), noise_seed=5),
    )


def _float_tier(got, want):
    """Noisy outputs: within 1e-5 except at <= 1% of elements (a psum one
    LSB apart), those within 1e-2 of the output's max."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    off = np.abs(got - want) > 1e-5 + 1e-5 * np.abs(want)
    assert off.mean() <= 0.01, off.mean()
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


@pytest.mark.parametrize("name", NAMES)
def test_configs_match_reference_field_for_field(name):
    ja, ta = jreg.get(name), treg.get(name)
    for jc, tc in ((ja.config, ta.config), (ja.smoke_config, ta.smoke_config)):
        for f in dataclasses.fields(tc):
            if f.name == "photonic_backend":
                continue
            jv, tv = getattr(jc, f.name), getattr(tc, f.name)
            assert (DTYPE[jv] == tv) if jv in DTYPE else jv == tv, (name, f.name)
        assert jc.moe_hidden == tc.moe_hidden
    assert ta.skip_shapes == ja.skip_shapes and ta.notes == ja.notes and ta.family == ja.family == "moe"


def _moe_case(case):
    extra = dict(MOE)
    if case == "capacity":
        extra["capacity_factor"] = 0.5
    jd, td = _smwa() if case == "smwa" else _ideal()
    jc = JModelConfig(photonic=jd, photonic_backend="ref", **extra)
    # Under noise each backend draws its own stream: the port's ref against the reference's ref.
    tc = TModelConfig(photonic=td, photonic_backend="ref" if case == "smwa" else "kernel", **extra)
    params = init_tree(jffn.moe_def(jc), jax.random.PRNGKey(3), jnp.float32)
    if case == "ties":
        params["router"]["w"] = jnp.zeros_like(params["router"]["w"])
    x = np.random.default_rng(4).normal(size=(2, 16, MOE["d_model"])).astype(np.float32)
    return jc, tc, params, params_from_jax(_np_tree(params), tc, "cpu"), x


@pytest.mark.parametrize("case", ["ideal", "capacity", "ties", "smwa"])
def test_moe_matches_reference(case):
    jc, tc, jp, tp, x = _moe_case(case)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    # The experts each side selects, from its own router path.
    jg = jax.nn.softmax(jdense(jp["router"], jx, jc, site="ffn.router"), axis=-1)
    _, j_top = jax.lax.top_k(jg, jc.num_experts_per_tok)
    with torch.no_grad():
        tg = torch.softmax(tdense(tp["router"], tx, tc, site="ffn.router"), dim=-1)
        _, t_top = tffn._top_k(tg, tc.num_experts_per_tok)
        got, aux = tffn.moe(tp, tx, tc, layer=1)
    np.testing.assert_array_equal(t_top.numpy(), np.asarray(j_top))
    if case == "ties":
        assert (t_top.numpy() == np.arange(tc.num_experts_per_tok)).all()
    if case == "capacity":
        cap = tffn._capacity(tc, x.shape[1])
        per_row = np.stack([np.bincount(r.ravel(), minlength=tc.num_experts) for r in t_top.numpy()])
        assert cap == 2 and per_row.max() > cap  # tokens are dropped
    want, jaux = jax.jit(lambda p, x: jffn.moe(p, x, jc, layer=1))(jp, jx)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    if case == "smwa":
        _float_tier(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_moe_bf16_matches_reference():
    """bf16 activations and weights, as at full width: outputs stay bf16
    and agree within 2^-5 of the output's max (four bf16 ulps of it: XLA
    evaluates the bf16 elementwise chain in f32 and rounds once, torch
    rounds op by op, and the GEMMs round their bf16 outputs)."""
    jc = JModelConfig(param_dtype=jnp.bfloat16, compute_dtype=jnp.bfloat16, **MOE)
    tc = TModelConfig(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16, **MOE)
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), init_tree(jffn.moe_def(jc), jax.random.PRNGKey(5), jnp.float32))
    tp = params_from_jax(_np_tree(jax.tree.map(lambda a: a.astype(jnp.float32), jp)), tc, "cpu")
    x = np.random.default_rng(6).normal(size=(2, 8, MOE["d_model"])).astype(np.float32)
    want, jaux = jax.jit(lambda p, x: jffn.moe(p, x, jc))(jp, jnp.asarray(x, jnp.bfloat16))
    with torch.no_grad():
        got, aux = tffn.moe(tp, torch.from_numpy(x).to(torch.bfloat16), tc)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, atol=2**-5 * np.abs(want).max())
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


def test_router_site_stays_digital_under_noise():
    """Port of the reference's test of the same name: ``dense(site=
    "ffn.router")`` equals the digital product under a fierce analog
    channel, with a seed or a key; a routed site does not; clearing the
    exclusion routes the router."""
    ch = dataclasses.replace(tbuild("SMWA", n=21, bits=4, datarate_gs=5.0), detector_sigma_lsb=500.0)
    cfg = TModelConfig(photonic=TDPU(dpe_size=21, channel=ch, noise_seed=0))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(8, 42)).astype(np.float32))
    params = {"w": torch.from_numpy(rng.normal(size=(42, 16)).astype(np.float32))}
    with torch.no_grad():
        for key in (None, prng.PRNGKey(9)):
            y = tdense(params, x, cfg, site="ffn.router", prng_key=key)
            torch.testing.assert_close(y, x @ params["w"], rtol=0, atol=0)
            assert not torch.equal(tdense(params, x, cfg, site="ffn.wi", prng_key=key), x @ params["w"])
        y3 = tdense(params, x, dataclasses.replace(cfg, photonic_exclude=()), site="ffn.router")
    assert not torch.equal(y3, x @ params["w"])


def test_moe_router_excluded_end_to_end():
    """Port of the reference's test of the same name: with a photonic
    engine the router's logits are the digital product, and the layer runs
    (photonic shared experts, digital router and routed experts)."""
    cfg = TModelConfig(d_model=32, d_ff=64, num_experts=4, num_experts_per_tok=2,
                       photonic=TDPU(organization="SMWA", bits=4, datarate_gs=5.0))
    jcfg = JModelConfig(d_model=32, d_ff=64, num_experts=4, num_experts_per_tok=2)
    params = params_from_jax(_np_tree(init_tree(jffn.moe_def(jcfg), jax.random.PRNGKey(1), jnp.float32)), cfg, "cpu")
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 8, 32)).astype(np.float32))
    with torch.no_grad():
        logits = tdense(params["router"], x, cfg, site="ffn.router")
        torch.testing.assert_close(logits, x @ params["router"]["w"], rtol=0, atol=0)
        out, aux = tffn.moe(params, x, cfg)
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(aux))


def _init(name, cfg, seed):
    """The reference's initial weights, jitted (one program instead of an
    op-by-op compile per leaf)."""
    return jax.jit(lambda k: init_tree(jreg.get(name).param_defs(cfg), k, cfg.param_dtype))(jax.random.PRNGKey(seed))


def _cfgs(name, **kw):
    jd, td = _ideal()
    jc = dataclasses.replace(jreg.get(name).smoke_config, remat=False, photonic=jd, photonic_backend="ref", **kw)
    tc = dataclasses.replace(treg.get(name).smoke_config, photonic=td, photonic_backend="kernel", **kw)
    return jc, tc


@pytest.fixture(scope="module", params=NAMES)
def model(request):
    name = request.param
    jc, tc = _cfgs(name)
    jp = _init(name, jc, 0)
    return name, jc, tc, jp, params_from_jax(_np_tree(jp), tc, "cpu")


class _CountGemms:
    """Counts the engine's fused-kernel calls (on the CPU each runs the
    kernel's twin), with each call's (rows, K, C)."""

    def __init__(self, monkeypatch):
        import repro_torch.photonic.engine as E

        self.calls = []
        inner = E.photonic_gemm_fused

        def counted(x, w, *a, **kw):
            self.calls.append((kw.get("rows") or x.shape[0], x.shape[1], w.shape[1]))
            return inner(x, w, *a, **kw)

        monkeypatch.setattr(E, "photonic_gemm_fused", counted)


def test_lm_logits_and_aux_match_reference(model, monkeypatch):
    name, jc, tc, jp, tp = model
    toks = np.random.default_rng(0).integers(0, tc.vocab_size, (2, 9)).astype(np.int32)
    want, jaux = jax.jit(lambda p, t: jlm.lm_logits(p, t, jc))(jp, jnp.asarray(toks))
    count = _CountGemms(monkeypatch)
    with torch.no_grad():
        got, aux = tlm.lm_logits(tp, torch.from_numpy(toks).long(), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    assert float(aux) > 0
    per_layer = 7 if tc.mla else 4  # MLA: wq wdkv wuk wuv wo + 2 FFN; GQA: wq wk wv wo (experts are einsums)
    assert len(count.calls) == per_layer * tc.num_layers + 1
    if tc.mla:
        assert "first_block" in tp and len(tp["layers"]) == tc.num_layers - 1
        assert "router" not in tp["first_block"]["ffn"] and "shared" in tp["layers"][0]["ffn"]
        assert tp["layers"][0]["ffn"]["wi"].shape == (tc.num_experts, tc.d_model, 2 * tc.moe_hidden)


def test_prepack_leaves_router_and_experts_unpacked(model):
    name, jc, tc, jp, tp = model
    _, packed = prepack_serving_params(treg.get(name), tc, tp)
    ffn = packed["layers"][0]["ffn"]
    assert not isinstance(ffn["router"]["w"], PackedDense)
    assert isinstance(ffn["wi"], torch.Tensor) and isinstance(ffn["wo"], torch.Tensor)
    assert isinstance(packed["layers"][0]["attn"]["wq"]["w"], PackedDense)
    if tc.mla:
        assert isinstance(ffn["shared"]["wi"]["w"], PackedDense)
        assert isinstance(packed["first_block"]["ffn"]["wi"]["w"], PackedDense)


@pytest.mark.parametrize("photonic", [False, True], ids=["digital", "ideal-photonic"])
def test_phi_paged_scheduler_matches_reference(photonic):
    """The paged server (chunked prefill of 8 tokens, batched decode) takes
    the MoE family as the reference's does: greedy tokens equal.  Digital
    logits within 1e-5; on the photonic path a quantization scale follows
    the float activations, so a row of logits may carry a one-LSB flip of
    an activation's int8 code upstream: at most one row in four leaves
    1e-5, by at most 1e-2 of its max |logit|."""
    name = "phi3.5-moe-42b-a6.6b"
    jc, tc = _cfgs(name)
    if not photonic:
        jc, tc = dataclasses.replace(jc, photonic=None), dataclasses.replace(tc, photonic=None)
    jp = _init(name, jc, 0)
    tp = params_from_jax(_np_tree(jp), tc, "cpu")
    sc = dict(batch_size=2, max_seq=32, block_size=8, chunk_tokens=8, record_logits=True)
    rng = np.random.default_rng(42)
    prompts = [rng.integers(0, tc.vocab_size, n).astype(np.int32) for n in (7, 11)]
    js = JScheduler(jreg.get(name), jc, jp, JServingConfig(**sc))
    jr = [JRequest(uid=i, prompt=p, max_new_tokens=3) for i, p in enumerate(prompts)]
    js.run(jr)
    ts = TScheduler(treg.get(name), tc, tp, TServingConfig(**sc), device="cpu")
    tr = [TRequest(uid=i, prompt=p, max_new_tokens=3) for i, p in enumerate(prompts)]
    ts.run(tr)
    rows_off = rows = 0
    for a, b in zip(jr, tr):
        assert b.done and a.output == b.output
        for x, y in zip(a.logits, b.logits):
            x = np.asarray(x)
            rows += 1
            if not np.allclose(y, x, atol=1e-5, rtol=1e-5):
                assert photonic and np.abs(y - x).max() <= 1e-2 * np.abs(x).max()
                rows_off += 1
    assert rows_off * 4 <= rows, (rows_off, rows)


def test_reference_checkpoint_of_the_moe_layout_restores_bitwise(tmp_path):
    """The reference's ``ckpt.save`` of deepseek-v2-lite's smoke params (the
    unstacked ``first_block``, the stacked layers with their ``(L, E, d,
    2f)`` expert stacks) restores into the port's tree bit for bit, and the
    port's own save round-trips."""
    name = "deepseek-v2-lite-16b"
    jc, tc = _cfgs(name)
    jp = _init(name, jc, 2)
    jckpt.save(tmp_path / "ref", 3, {"params": jp})
    want = params_from_jax(_np_tree(jp), tc, "cpu")
    like = tree_map(torch.zeros_like, want)
    back = tckpt.restore(tmp_path / "ref", 3, {"params": like})["params"]
    tckpt.save(tmp_path / "port", 4, {"params": want})
    again = tckpt.restore(tmp_path / "port", 4, {"params": like})["params"]
    assert tree_items(back).keys() == tree_items(want).keys()
    for k, a in tree_items(want).items():
        assert torch.equal(tree_items(back)[k], a) and torch.equal(tree_items(again)[k], a), k
    assert "params/first_block/ffn/wi/w" in tree_items({"params": back})


@pytest.mark.parametrize("name", ["llama-3.2-vision-90b", "xlstm-350m", "zamba2-2.7b", "whisper-medium"])
def test_registry_returns_each_family_with_its_adapters(name):
    """The vlm, ssm, hybrid and audio archs come back with the reference's
    family and that family's adapters; an unknown arch raises as the
    reference's lookup does."""
    family = jreg.get(name).family
    arch = treg.get(name)
    assert arch.name == name and arch.family == family
    assert (arch.param_defs, arch.loss, arch.prefill, arch.decode, arch.cache_def) == treg.FAMILY_FNS[family]
    assert arch.prefill.__name__ == jreg.FAMILY_FNS[family][2].__name__
    assert sorted(treg.FAMILY_FNS) == sorted(jreg.FAMILY_FNS)
    with pytest.raises(KeyError, match="unknown arch"):
        treg.get("no-such-arch")


def test_lm_refuses_vision_cross_attention():
    """The paged path refuses vision cross-attention with the reference's
    message (``repro.models.lm:_check_paged_support``)."""
    cfg = TModelConfig(cross_attn_every=2, num_layers=4)
    message = ("paged serving covers the GQA self-attention stack only (no MLA latent caches / vision "
               "cross-attention); serve these families through the legacy fixed-slot engine")
    with pytest.raises(ValueError) as info:
        tlm.lm_prefill_chunk({}, torch.zeros((1, 4), dtype=torch.int64), {}, torch.zeros(4, dtype=torch.int64), 0,
                             cfg, t_full=4, block_size=4, with_logits=True)
    assert message in str(info.value)
    with pytest.raises(ValueError) as info:
        jlm.lm_prefill_chunk({}, jnp.zeros((1, 4), jnp.int32), {}, jnp.zeros(4, jnp.int32), 0,
                             JModelConfig(cross_attn_every=2, num_layers=4), t_full=4, block_size=4,
                             with_logits=True)
    assert message in str(info.value)
