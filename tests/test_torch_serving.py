"""The port's paged serving stack: the KV-cache primitives, the dense LM's
paged prefill/decode against the JAX reference, and the scheduler's
contracts (greedy parity with the JAX scheduler under the ideal channel,
zero weight-shaped rounds in decode, request-folded sampling, no stale
KV).

Models use ``tests/test_serving.py``'s small qwen2 config in f32 with the
reference's initial weights carried over (``repro_torch.weights``).
Logits are held at ``atol=1e-5``: both sides compute the same f32 ops, but
XLA and torch sum the attention and the digital LM head in other orders
(observed differences ~1e-7).  Greedy tokens are held equal.
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
from repro.serving import kv_cache as jkvc  # noqa: E402
from repro.serving.scheduler import prepack_serving_params as jprepack  # noqa: E402
from repro_torch.analysis.contracts import ContractChecker  # noqa: E402
from repro_torch.core.dpu import DPUConfig as TDPU  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.photonic.engine import PhotonicEngine  # noqa: E402
from repro_torch.photonic.packing import pack_dense  # noqa: E402
from repro_torch.serving import NULL_BLOCK, BlockAllocator  # noqa: E402
from repro_torch.serving import Request as TRequest  # noqa: E402
from repro_torch.serving import Scheduler as TScheduler  # noqa: E402
from repro_torch.serving import ServingConfig as TServingConfig  # noqa: E402
from repro_torch.serving import kv_cache as tkvc  # noqa: E402
from repro_torch.serving.scheduler import prepack_serving_params as tprepack  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

JA = jreg.get("qwen2-0.5b")
TA = treg.get("qwen2-0.5b")
SMALL = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64)
SC = dict(batch_size=2, max_seq=32, block_size=8, chunk_tokens=8, record_logits=True)


def _cfgs(photonic: bool):
    jc = dataclasses.replace(JA.smoke_config, remat=False, **SMALL)
    tc = dataclasses.replace(TA.smoke_config, **SMALL)
    if photonic:
        jc = dataclasses.replace(jc, photonic=JDPU(organization="SMWA", bits=4, dpe_size=16), photonic_backend="ref")
        tc = dataclasses.replace(tc, photonic=TDPU(organization="SMWA", bits=4, dpe_size=16), photonic_backend="kernel")
    return jc, tc


@pytest.fixture(scope="module")
def jparams():
    jc, _ = _cfgs(False)
    return init_tree(JA.param_defs(jc), jax.random.PRNGKey(0), jc.param_dtype)


def _tparams(jparams, tc):
    return params_from_jax(jax.tree.map(np.asarray, jparams), tc, "cpu")


def _prompts(lengths, vocab=64):
    rng = np.random.default_rng(42)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


# ---------------------------------------------------------------------------
# KV-cache primitives
# ---------------------------------------------------------------------------
def test_allocator_all_or_nothing_and_guards():
    a = BlockAllocator(8, 4, reserved=2)
    got = a.alloc(4)
    assert sorted(got) == [2, 3, 4, 5] and a.alloc(3) is None and a.free_blocks == 2
    a.free(got)
    assert a.free_blocks == 6
    assert [a.blocks_needed(n) for n in (1, 4, 5, 8, 9)] == [1, 1, 2, 2, 3]
    with pytest.raises(ValueError):
        a.free([NULL_BLOCK])
    with pytest.raises(ValueError):
        BlockAllocator(3, 4, reserved=3)


def test_scatter_gather_roundtrip_matches_reference():
    bs = 4
    rng = np.random.default_rng(0)
    rows = {n: rng.normal(size=(6, 2, 3)).astype(np.float32) for n in ("k", "v")}
    table = np.asarray([[2, 5, NULL_BLOCK]], np.int32)
    jpool = {n: jnp.zeros((6, bs, 2, 3)) for n in ("k", "v")}
    tpool = {n: torch.zeros((6, bs, 2, 3)) for n in ("k", "v")}
    jb, jo = jkvc.chunk_dest(jnp.asarray(table[0]), jnp.int32(1), 5, bs)
    tb, to = tkvc.chunk_dest(torch.from_numpy(table[0]), 1, 5, bs)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    jpool = jkvc.scatter_kv(jpool, jb, jo, {n: jnp.asarray(r[:5]) for n, r in rows.items()})
    tkvc.scatter_kv(tpool, tb, to, {n: torch.from_numpy(r[:5]) for n, r in rows.items()})
    for length in (6, 12):
        jg = jkvc.gather_kv(jpool, jnp.asarray(table), length)
        tg = tkvc.gather_kv(tpool, torch.from_numpy(table), length)
        for n in ("k", "v"):
            np.testing.assert_array_equal(tg[n].numpy(), np.asarray(jg[n]))
    stacked = {"k": torch.ones((2, 5, 3, 2))}
    tkvc.zero_blocks(stacked, [1, 3])
    assert (stacked["k"][:, [1, 3]] == 0).all() and (stacked["k"][:, [0, 2, 4]] == 1).all()


def test_token_dest_redirects_inactive_rows_to_trash():
    table = torch.tensor([[3, 4], [5, NULL_BLOCK]])
    blocks, offsets = tkvc.token_dest(
        table, torch.tensor([6, 1]), torch.tensor([True, False]), torch.tensor([1, 2]), 4
    )
    assert blocks.tolist() == [4, 2] and offsets.tolist() == [2, 0]


def test_init_pool_validates_paged_axes():
    good = {"k": ((4, 2, 3), ("batch", "kv_seq", None), torch.float32)}
    assert tkvc.init_pool(good, "cpu")["k"].shape == (4, 2, 3)
    with pytest.raises(ValueError):
        tkvc.init_pool({"k": ((4, 2, 3), ("kv_seq", "batch", None), torch.float32)}, "cpu")


# ---------------------------------------------------------------------------
# Paged prefill / decode against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("photonic", [False, True], ids=["float", "ideal-photonic"])
def test_prefill_chunk_and_decode_logits_match_reference(jparams, photonic):
    jc, tc = _cfgs(photonic)
    bs, nb, t = 8, 6, 11
    _, jp = jprepack(JA, jc, jparams)
    _, tp = tprepack(TA, tc, _tparams(jparams, tc))
    jpool = jkvc.init_pool(JA.cache_def(jc, nb, bs, {}, jc.compute_dtype)["layers"])
    tpool = tkvc.init_pool(TA.cache_def(tc, nb, bs, {}, tc.compute_dtype)["layers"], "cpu")
    toks = _prompts([t])[0]
    table = np.asarray([2, 3, 4, NULL_BLOCK], np.int32)
    # Two chunks (8 + 3 tokens): the second attends through the pool.
    for t0, t1 in ((0, 8), (8, t)):
        jl, jpool = jlm.lm_prefill_chunk(
            jp, jnp.asarray(toks[None, t0:t1]), jpool, jnp.asarray(table), jnp.int32(t0), jc,
            t_full=t, block_size=bs, with_logits=t1 == t,
        )
        tl, tpool = tlm.lm_prefill_chunk(
            tp, torch.from_numpy(toks[None, t0:t1]).long(), tpool, torch.from_numpy(table).long(),
            t0, tc, t_full=t, block_size=bs, with_logits=t1 == t,
        )
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tpool["k"].numpy(), np.asarray(jpool["k"]), atol=1e-5, rtol=1e-5)
    # One batched decode step: row 0 live at position t, row 1 inactive.
    tok = np.asarray([[int(np.argmax(np.asarray(jl)[0, -1]))], [0]], np.int32)
    tables = np.stack([table, np.full_like(table, NULL_BLOCK)])
    pos, active, trash = np.asarray([t, 0]), np.asarray([True, False]), np.asarray([1, 5])
    jl2, _ = jlm.lm_decode_paged(
        jp, jnp.asarray(tok), jpool, jnp.asarray(tables), jnp.asarray(pos, jnp.int32),
        jnp.asarray(active), jnp.asarray(trash, jnp.int32), jc, gather_len=32, block_size=bs,
    )
    tl2, _ = tlm.lm_decode_paged(
        tp, torch.from_numpy(tok).long(), tpool, torch.from_numpy(tables).long(),
        torch.from_numpy(pos), torch.from_numpy(active), torch.from_numpy(trash), tc,
        gather_len=32, block_size=bs,
    )
    np.testing.assert_allclose(tl2.numpy()[0], np.asarray(jl2)[0], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("photonic", [False, True], ids=["float", "ideal-photonic"])
def test_scheduler_greedy_tokens_match_reference(jparams, photonic):
    jc, tc = _cfgs(photonic)
    prompts = _prompts([5, 12, 7])
    js = JScheduler(JA, jc, jparams, JServingConfig(**SC))
    jr = [JRequest(uid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
    js.run(jr)
    ts = TScheduler(TA, tc, _tparams(jparams, tc), TServingConfig(**SC), device="cpu")
    tr = [TRequest(uid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
    ts.run(tr)
    assert ts.stats["completed"] == 3 and ts.stats["prefill_chunks"] == js.stats["prefill_chunks"]
    for a, b in zip(jr, tr):
        assert a.output == b.output
        for x, y in zip(a.logits, b.logits):
            np.testing.assert_allclose(y, np.asarray(x), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# Scheduler contracts inside the port
# ---------------------------------------------------------------------------
def test_decode_does_zero_weight_shaped_rounds(jparams):
    _, tc = _cfgs(True)
    ts = TScheduler(TA, tc, _tparams(jparams, tc), TServingConfig(**SC), device="cpu")
    ts.run([TRequest(uid=0, prompt=_prompts([6])[0], max_new_tokens=2)])
    assert ts.decode_weight_rounds() == 0
    # Positive control: per-call weight quantization is seen by the checker.
    eng = PhotonicEngine(dpu=tc.photonic, backend="kernel")
    w = torch.randn(64, 48)
    checker = ContractChecker.record(eng.matmul_float, torch.randn(3, 64), w, site="attn.wq")
    assert checker.weight_round_ops(64 * 48) == 1
    packed = pack_dense({"w": w}, eng)["w"]
    assert ContractChecker.record(eng.matmul, torch.randn(3, 64), packed, site="attn.wq").weight_round_ops(64 * 48) == 0


def test_chunked_prefill_equals_one_shot_on_the_float_path(jparams):
    _, tc = _cfgs(False)
    outs = []
    for chunk in (4, 32):
        ts = TScheduler(TA, tc, _tparams(jparams, tc), TServingConfig(**dict(SC, chunk_tokens=chunk)), device="cpu")
        reqs = [TRequest(uid=i, prompt=p, max_new_tokens=3) for i, p in enumerate(_prompts([13, 9]))]
        ts.run(reqs)
        outs.append(reqs)
    for a, b in zip(*outs):
        assert a.output == b.output
        for x, y in zip(a.logits, b.logits):
            np.testing.assert_allclose(x, y, atol=1e-5, rtol=1e-5)


def test_sampling_streams_fold_the_request_uid_not_the_slot(jparams):
    _, tc = _cfgs(False)
    params = _tparams(jparams, tc)
    cfg = TServingConfig(**dict(SC, greedy=False, batch_size=1, record_logits=False))
    p = _prompts([6, 6])
    ts1 = TScheduler(TA, tc, params, cfg, device="cpu")
    r1 = [TRequest(uid=7, prompt=p[0], max_new_tokens=4), TRequest(uid=9, prompt=p[1], max_new_tokens=4)]
    ts1.run(r1)
    ts2 = TScheduler(TA, tc, params, cfg, device="cpu")
    r2 = [TRequest(uid=9, prompt=p[1], max_new_tokens=4), TRequest(uid=7, prompt=p[0], max_new_tokens=4)]
    ts2.run(r2)  # the same requests through the one slot in the other order
    assert r1[0].output == r2[1].output and r1[1].output == r2[0].output


def test_recycled_blocks_are_zeroed_at_admission(jparams):
    _, tc = _cfgs(False)
    ts = TScheduler(TA, tc, _tparams(jparams, tc), TServingConfig(**SC), device="cpu")
    for leaf in ts.kv_pool.values():
        leaf[:, 1 + SC["batch_size"]:] = float("nan")  # plant sentinels in allocatable blocks
    reqs = [TRequest(uid=i, prompt=p, max_new_tokens=3) for i, p in enumerate(_prompts([9, 4]))]
    ts.run(reqs)
    assert all(np.isfinite(row).all() for r in reqs for row in r.logits)
    with pytest.raises(ValueError, match="exceeds max_seq"):
        ts.submit(TRequest(uid=5, prompt=np.zeros(30, np.int32), max_new_tokens=8))
