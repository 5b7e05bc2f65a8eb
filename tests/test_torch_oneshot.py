"""The port's one-shot serving path and full-sequence forward against the
JAX reference, with both attention cores.

* ``lm_prefill`` / ``lm_decode`` (through ``Arch.prefill`` / ``Arch.decode``)
  and ``lm_logits``, float and ideal-photonic, ``attn_impl`` "chunked" and
  "flash";
* ``runtime.serve.LegacyEngine`` greedy tokens against the reference's
  (ideal channel, both cores), and ``Engine`` routing the dense family to
  the paged ``Scheduler``;
* the paged ``Scheduler`` with ``attn_impl="flash"``: the reference runs
  chunked attention there and serves it, so the port must too.

Models use ``tests/test_torch_serving.py``'s small qwen2 config in f32 with
the reference's weights carried over.  Logits are held at ``atol=1e-5``
(both sides compute the same f32 ops in other summation orders; the flash
core on the JAX side is its Pallas kernel in interpret mode, on the port's
side the kernel's plain twin).  Greedy tokens are held equal.
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
from repro.runtime import serve as jserve  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import Scheduler as JScheduler  # noqa: E402
from repro.serving import ServingConfig as JServingConfig  # noqa: E402
from repro.serving.scheduler import prepack_serving_params as jprepack  # noqa: E402
from repro_torch.core.dpu import DPUConfig as TDPU  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.runtime import serve as tserve  # noqa: E402
from repro_torch.serving import Request as TRequest  # noqa: E402
from repro_torch.serving import Scheduler as TScheduler  # noqa: E402
from repro_torch.serving import ServingConfig as TServingConfig  # noqa: E402
from repro_torch.serving.scheduler import prepack_serving_params as tprepack  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

JA = jreg.get("qwen2-0.5b")
TA = treg.get("qwen2-0.5b")
SMALL = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64)
SC = dict(batch_size=2, max_seq=32, block_size=8, chunk_tokens=8, record_logits=True)
IMPLS = ["chunked", "flash"]
PHOTONIC = pytest.mark.parametrize("photonic", [False, True], ids=["float", "ideal-photonic"])


def _cfgs(photonic: bool, impl: str):
    jc = dataclasses.replace(JA.smoke_config, remat=False, attn_impl=impl, **SMALL)
    tc = dataclasses.replace(TA.smoke_config, attn_impl=impl, **SMALL)
    if photonic:
        jc = dataclasses.replace(jc, photonic=JDPU(organization="SMWA", bits=4, dpe_size=16), photonic_backend="ref")
        tc = dataclasses.replace(tc, photonic=TDPU(organization="SMWA", bits=4, dpe_size=16), photonic_backend="kernel")
    return jc, tc


@pytest.fixture(scope="module")
def jparams():
    jc, _ = _cfgs(False, "chunked")
    return init_tree(JA.param_defs(jc), jax.random.PRNGKey(0), jc.param_dtype)


def _tparams(jparams, tc):
    return params_from_jax(jax.tree.map(np.asarray, jparams), tc, "cpu")


def _prompts(lengths, vocab=64):
    rng = np.random.default_rng(42)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# Model functions against the reference
# ---------------------------------------------------------------------------
@PHOTONIC
@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_and_decode_match_reference(jparams, impl, photonic):
    jc, tc = _cfgs(photonic, impl)
    _, jp = jprepack(JA, jc, jparams)
    _, tp = tprepack(TA, tc, _tparams(jparams, tc))
    toks = np.stack(_prompts([11, 11]))
    jl, jcache = JA.prefill(jp, {"tokens": jnp.asarray(toks)}, jc, 16)
    tl, tcache = TA.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, tc, 16)
    _close(tl, jl)
    assert tcache["pos"] == int(jcache["pos"]) == 11
    for leaf in ("k", "v"):
        assert tuple(tcache["layers"][leaf].shape) == jcache["layers"][leaf].shape == (2, 2, 16, 2, 16)
        _close(tcache["layers"][leaf], jcache["layers"][leaf])
    for _ in range(2):  # two decode steps on the reference's own greedy tokens
        tok = np.array(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
        jl, jcache = JA.decode(jp, jnp.asarray(tok), jcache, jc)
        tl, tcache = TA.decode(tp, torch.from_numpy(tok).long(), tcache, tc)
        _close(tl, jl)
    assert tcache["pos"] == int(jcache["pos"]) == 13
    _close(tcache["layers"]["k"], jcache["layers"]["k"])


@PHOTONIC
@pytest.mark.parametrize("impl", IMPLS)
def test_lm_logits_matches_reference(jparams, impl, photonic):
    jc, tc = _cfgs(photonic, impl)
    _, jp = jprepack(JA, jc, jparams)
    _, tp = tprepack(TA, tc, _tparams(jparams, tc))
    for t in (19, 23):
        toks = np.stack(_prompts([t, t]))
        jl, jaux = jlm.lm_logits(jp, jnp.asarray(toks), jc)
        tl, taux = tlm.lm_logits(tp, torch.from_numpy(toks).long(), tc)
        assert tuple(tl.shape) == (2, t, 64)
        _close(tl, jl)
        assert float(taux) == float(jaux) == 0.0


# ---------------------------------------------------------------------------
# Engines against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", IMPLS)
def test_legacy_engine_greedy_tokens_match_reference(jparams, impl):
    jc, tc = _cfgs(True, impl)
    prompts = _prompts([5, 12, 7])
    je = jserve.LegacyEngine(JA, jc, jparams, jserve.ServeConfig(batch_size=2, max_seq=32))
    jr = [JRequest(uid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
    je.run(jr)
    te = tserve.LegacyEngine(TA, tc, _tparams(jparams, tc), tserve.ServeConfig(batch_size=2, max_seq=32),
                             device="cpu")
    tr = [TRequest(uid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
    te.run(tr)
    assert [r.output for r in tr] == [r.output for r in jr]
    assert all(r.done for r in tr)
    for key in ("prefills", "decode_steps", "completed"):
        assert te.stats[key] == je.stats[key]


def test_engine_routes_the_dense_family_to_the_scheduler(jparams):
    jc, tc = _cfgs(True, "flash")
    cfg = dict(batch_size=2, max_seq=32)
    eng = tserve.Engine(TA, tc, _tparams(jparams, tc), tserve.ServeConfig(**cfg), device="cpu")
    assert isinstance(eng.impl, TScheduler)
    assert (eng.impl.cfg.block_size, eng.impl.cfg.chunk_tokens) == (16, 64)
    assert eng.photonic is eng.impl.photonic and eng.stats is eng.impl.stats
    prompts = _prompts([6, 9])
    tr = eng.run([TRequest(uid=i, prompt=p, max_new_tokens=3) for i, p in enumerate(prompts)])
    jeng = jserve.Engine(JA, jc, jparams, jserve.ServeConfig(**cfg))
    jr = jeng.run([JRequest(uid=i, prompt=p, max_new_tokens=3) for i, p in enumerate(prompts)])
    assert [r.output for r in tr] == [r.output for r in jr]


def test_paged_scheduler_serves_attn_impl_flash_as_the_reference(jparams):
    """The reference's paged path accepts ``attn_impl="flash"`` and runs
    chunked attention there; the port's scheduler once refused it."""
    jc, tc = _cfgs(True, "flash")
    prompts = _prompts([5, 12, 7])
    js = JScheduler(JA, jc, jparams, JServingConfig(**SC))
    jr = [JRequest(uid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
    js.run(jr)
    ts = TScheduler(TA, tc, _tparams(jparams, tc), TServingConfig(**SC), device="cpu")
    tr = [TRequest(uid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
    ts.run(tr)
    assert ts.stats["completed"] == 3
    for a, b in zip(jr, tr):
        assert a.output == b.output
        for x, y in zip(a.logits, b.logits):
            np.testing.assert_allclose(y, np.asarray(x), atol=1e-5, rtol=1e-5)
