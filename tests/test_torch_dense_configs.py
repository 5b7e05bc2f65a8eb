"""The other three dense configs against the reference: qwen2-1.5b,
granite-3-8b and deepseek-67b.

* ``FULL`` and ``SMOKE`` equal the reference's field for field (torch
  dtypes for JAX dtypes; the photonic backend default is each package's
  own), and so do the registry's ``skip_shapes`` and notes;
* at each smoke config, with the reference's initial weights carried
  over (``params_from_jax``) and every weight GEMM on the ideal channel
  (the port's kernel twin against the reference's ``ref``, both exact):
  ``lm_logits`` within ``atol=1e-5`` (as the qwen2-0.5b tests: the
  attention and the digital head sum in other orders) and greedy tokens
  of the paged ``Scheduler`` equal the reference's, logits within the same
  tolerance.  deepseek-67b's untied ``lm_head`` is a routed GEMM here;
  granite-3-8b's Q/K/V carry no bias;
* granite-3-8b in the int8 serving layout (``quantize_params``, int8 KV
  cache) with the bias-free fused ``wqkv`` bank: the bank packs without a
  bias and its tokens equal the three-site run's.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core.dpu import DPUConfig as JDPU  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models.common import init_tree  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import Scheduler as JScheduler  # noqa: E402
from repro.serving import ServingConfig as JServingConfig  # noqa: E402
from repro_torch.core.dpu import DPUConfig as TDPU  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models.common import quantize_params  # noqa: E402
from repro_torch.photonic import PackedDense, fuse_qkv_params  # noqa: E402
from repro_torch.serving import Request as TRequest  # noqa: E402
from repro_torch.serving import Scheduler as TScheduler  # noqa: E402
from repro_torch.serving import ServingConfig as TServingConfig  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

NAMES = ["qwen2-1.5b", "granite-3-8b", "deepseek-67b"]
SC = dict(batch_size=2, max_seq=32, block_size=8, chunk_tokens=8, record_logits=True)
DTYPE = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


def _same(jv, tv):
    if jv in DTYPE:
        return DTYPE[jv] == tv
    return jv == tv


@pytest.mark.parametrize("name", ["qwen2-0.5b", *NAMES])
def test_configs_match_reference_field_for_field(name):
    ja, ta = jreg.get(name), treg.get(name)
    for jc, tc in ((ja.config, ta.config), (ja.smoke_config, ta.smoke_config)):
        for f in dataclasses.fields(tc):
            if f.name == "photonic_backend":
                continue
            assert _same(getattr(jc, f.name), getattr(tc, f.name)), (name, f.name)
    assert ta.skip_shapes == ja.skip_shapes and ta.notes == ja.notes and ta.family == ja.family


def _cfgs(name):
    jc = dataclasses.replace(jreg.get(name).smoke_config, remat=False,
                             photonic=JDPU(organization="SMWA", bits=4, dpe_size=16), photonic_backend="ref")
    tc = dataclasses.replace(treg.get(name).smoke_config,
                             photonic=TDPU(organization="SMWA", bits=4, dpe_size=16), photonic_backend="kernel")
    return jc, tc


@pytest.fixture(scope="module", params=NAMES)
def model(request):
    name = request.param
    jc, tc = _cfgs(name)
    jp = init_tree(jreg.get(name).param_defs(jc), jax.random.PRNGKey(0), jc.param_dtype)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")
    return name, jc, tc, jp, tp


def _prompts(lengths, vocab):
    rng = np.random.default_rng(42)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


def test_lm_logits_match_reference(model):
    name, jc, tc, jp, tp = model
    if name == "deepseek-67b":
        assert "lm_head" in tp and "lm_head" in jp  # untied, routed
    else:
        assert "lm_head" not in tp
    if name == "granite-3-8b":
        assert "b" not in tp["layers"][0]["attn"]["wq"]
    toks = np.random.default_rng(0).integers(0, tc.vocab_size, (2, 9)).astype(np.int32)
    want, _ = jlm.lm_logits(jp, jnp.asarray(toks), jc)
    with torch.no_grad():
        got, _ = tlm.lm_logits(tp, torch.from_numpy(toks).long(), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_scheduler_greedy_tokens_match_reference(model):
    name, jc, tc, jp, tp = model
    prompts = _prompts([7, 11], tc.vocab_size)
    js = JScheduler(jreg.get(name), jc, jp, JServingConfig(**SC))
    jr = [JRequest(uid=i, prompt=p, max_new_tokens=3) for i, p in enumerate(prompts)]
    js.run(jr)
    ts = TScheduler(treg.get(name), tc, tp, TServingConfig(**SC), device="cpu")
    tr = [TRequest(uid=i, prompt=p, max_new_tokens=3) for i, p in enumerate(prompts)]
    ts.run(tr)
    for a, b in zip(jr, tr):
        assert b.done and a.output == b.output
        for x, y in zip(a.logits, b.logits):
            np.testing.assert_allclose(y, np.asarray(x), atol=1e-5, rtol=1e-5)
    if name == "deepseek-67b":
        assert isinstance(ts.params["lm_head"]["w"], PackedDense)


def test_granite_int8_layout_with_the_bias_free_fused_bank():
    name = "granite-3-8b"
    _, tc = _cfgs(name)
    jc, _ = _cfgs(name)
    jp = init_tree(jreg.get(name).param_defs(jc), jax.random.PRNGKey(1), jc.param_dtype)
    tc8 = dataclasses.replace(tc, photonic_scope="weights_int8", kv_cache_int8=True)
    arch = treg.get(name)
    tp = quantize_params(params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu"), arch.param_defs(tc8))
    prompts = _prompts([6, 10], tc.vocab_size)
    outs = []
    for fuse in (False, True):
        ts = TScheduler(arch, tc8, tp, TServingConfig(**SC), device="cpu")
        if fuse:
            for layer in ts.params["layers"]:
                layer["attn"] = fuse_qkv_params(layer["attn"], ts.photonic)
            bank = ts.params["layers"][0]["attn"]["wqkv"]
            assert "b" not in bank and isinstance(bank["w"], PackedDense)
            assert bank["w"].c == tc.num_heads * tc.hd + 2 * tc.num_kv_heads * tc.hd
        reqs = [TRequest(uid=i, prompt=p, max_new_tokens=3) for i, p in enumerate(prompts)]
        ts.run(reqs)
        assert all(r.done for r in reqs)
        outs.append(reqs)
    for a, b in zip(*outs):
        assert a.output == b.output
        for x, y in zip(a.logits, b.logits):
            np.testing.assert_array_equal(x, y)
