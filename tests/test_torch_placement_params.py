"""The port's parameter placement for the dense GQA decoders
(``repro_torch.runtime.sharding.place_params``: ``heads``, ``kv_heads``,
``d_ff``, ``vocab`` over ``model``) against the replicated program, the JAX
reference and the reference's dry-run shardings.

The reference's dry run holds each parameter as its ``param_axes`` place
it; the port's placed step now holds the same blocks and computes only its
block of every GEMM: column-parallel ``attn.wq`` / ``wk`` / ``wv``,
``ffn.wi`` (SwiGLU's ``[u | g]`` as a block of each half) and ``lm_head``,
row-parallel ``attn.wo`` / ``ffn.wo``, a vocab-parallel embedding, head
and loss.  Held here:

* (a) on a spawned (data 2, model 2) ``gloo`` group, qwen2-0.5b's smoke
  config padded for a model degree of 2 (8 q / 2 KV heads, d_ff 112,
  vocab 256) with the reference's initial weights (``params_from_jax``):
  a prefill of 4 x 8 tokens and 2 decode steps with everything placed give
  logits (gathered over rows and vocab) bitwise those of the replicated TP
  program (whole parameters, TP over "model", nothing placed) on the ideal
  channel and under SMWA with its noise key (``noise_seed``): each
  column-parallel GEMM runs every K shard of the TP program itself at the
  block's global column origin.  Without a TP scope (SMWA), everything
  placed against the rows alone placed: the column GEMMs take the fused
  single-device stream at their origins, bitwise.  The placed run's counts: no int32 psum
  for a column-parallel GEMM (2 a layer, ``attn.wo`` and ``ffn.wo``), one
  scale ``MAX`` a GEMM, one content-word all-reduce a noisy column GEMM,
  one weight-scale ``MAX`` a row GEMM, one vocab lookup a forward, logits
  gathered over rows and vocab; parameter bytes a rank half the whole;
* (b) digital (no engine), where the row-parallel float sums run in
  another order: the placed logits within ``atol=1e-5`` of the unsharded
  run's (3.0e-7 apart on the CPU);
* (c) the placed logits, ideal channel and digital, within the reference
  parity tolerance (``atol=rtol=1e-5``, as ``test_torch_oneshot.py``) of
  the JAX reference's ``prefill`` / ``decode`` on the same parameters;
* (d) the dry run's train step (``dryrun.build_step``: placed parameters,
  ZeRO-1 moments, the placed gradient norm) for two steps, digital and on
  the ideal channel, against the replicated step on whole parameters: the
  losses within ``rtol=1e-3``, the gradient norms within ``rtol=1e-4``,
  the first gradient's blocks within ``atol=1e-6`` of the replicated
  gradient's (summed in other orders; 1.8e-7 apart on the CPU), every
  parameter block within ``2 x steps x lr`` plus one bf16 rounding of its
  value;
* ``train(mesh=(2, 2), tp_axis="model")`` on the padded smoke config
  (one step) places the heads as well as the rows and keeps its parameters
  whole:
  with the heads alone placed (a batch of 3) it is the replicated program
  (``place_rows=False``) bit for bit, with half its int32 all-reduces; with
  rows and heads placed, within ``rtol=1e-5`` / ``atol=1e-5`` (6.3e-6
  apart on the CPU: the gradient sums over the rows in another order);
* (e) the vocab-parallel loss over a padded vocab (10 of 12 columns real,
  the padded two in one rank's block) and its gradient block equal the
  replicated loss's within f32 rounding; SwiGLU's ``wi`` placed as a block
  of ``u`` and a block of ``g``;
* (f) the photonic kernel's twin with a column origin that is not a
  multiple of ``tile_c`` (64 and 448, qwen2-0.5b's ``wk`` / ``wq`` blocks
  on a 2-way ``model``), ``fused`` 0 and 1, under noise and crosstalk, and
  ``PhotonicEngine.int_gemm(columns=)`` on the kernel and ``ref``
  backends: bitwise those columns of the whole;
* (g) the dry run's qwen2-0.5b x decode_32k x single cell at full width
  holds the reference's arguments to the byte (1,677,959,972 B,
  ``chip_smoke.REFERENCE_DECODE_CELL``) and lists nothing under
  ``replicated_by_port``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import _torch_placement_params_ranks as ranks  # noqa: E402
from _torch_placement_ranks import BATCH, MAX_SEQ, _inputs  # noqa: E402
from repro.core.dpu import DPUConfig as JDPU  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models.common import init_tree  # noqa: E402
from repro_torch._tree import tree_items  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.runtime import sharding as tshd  # noqa: E402

LAYERS = 2
FORWARDS = 1 + ranks.DECODE_STEPS
REFERENCE_DECODE_ARGUMENTS = 1677959972  # the reference's qwen2-0.5b x decode_32k x single cell


def _jcfg(photonic):
    cfg = jreg.get("qwen2-0.5b").smoke_config.pad_for_mesh(2)
    if photonic:
        cfg = dataclasses.replace(cfg, photonic=JDPU(organization="SMWA", bits=4, datarate_gs=5.0),
                                  photonic_backend="ref")
    return cfg


@pytest.fixture(scope="module")
def params_np():
    cfg = _jcfg(False)
    return jax.tree.map(np.asarray, init_tree(jreg.get("qwen2-0.5b").param_defs(cfg), jax.random.PRNGKey(0),
                                              cfg.param_dtype))


@pytest.fixture(scope="module")
def group(params_np):
    return spawn(ranks.suite, 4, backend="gloo", args=(params_np,), timeout=300)


@pytest.fixture(scope="module")
def serve(group):
    return [r["serve"] for r in group]


@pytest.fixture(scope="module")
def train(group):
    return [r["train"] for r in group]


# ---------------------------------------------------------------------------
# (a)-(c) placed prefill and decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("channel", ["ideal", "SMWA", "SMWA without TP"])
def test_placed_parameters_give_the_replicated_programs_logits_bitwise(serve, channel):
    assert sorted(r["coords"] for r in serve) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in serve:
        res = r[channel]
        assert len(res["placed"]) == FORWARDS
        for rep, placed, rank0 in zip(res["replicated"], res["placed"], serve[0][channel]["placed"]):
            assert placed.shape == (BATCH, 1, 256)
            np.testing.assert_array_equal(placed, rep)
            np.testing.assert_array_equal(placed, rank0)


@pytest.mark.parametrize("channel", ["ideal", "SMWA"])
def test_a_placed_forward_reduces_only_its_row_parallel_gemms(serve, channel):
    noisy = channel == "SMWA"
    for r in serve:
        res = r[channel]
        rows = 6 * LAYERS * FORWARDS
        assert res["replicated_counts"]["psum"] == rows and res["replicated_counts"]["tp_rows"] == rows
        assert res["placed_counts"] == dict(
            psum=2 * LAYERS * FORWARDS, amax=6 * LAYERS * FORWARDS, outputs=2 * FORWARDS, tp_rows=0, heads=0,
            column_input=0, row_output=0, vocab=FORWARDS, weight_words=4 * LAYERS * FORWARDS if noisy else 0,
            weight_scale=2 * LAYERS * FORWARDS, expert_combine=0, expert_input=0)
        full = (LAYERS, BATCH, MAX_SEQ, 2, 8)
        assert res["replicated_cache"] == {"k": full, "v": full}
        assert res["placed_cache"] == {"k": (LAYERS, 2, MAX_SEQ, 1, 8), "v": (LAYERS, 2, MAX_SEQ, 1, 8)}
        norms = 2 * LAYERS * 56 + 56  # ln1, ln2 and the final norm stay whole
        assert res["placed_bytes"] == (res["replicated_bytes"] - 4 * norms) // 2 + 4 * norms


def test_the_digital_placed_run_sums_its_row_parallel_gemms_within_tolerance(serve):
    for r in serve:
        res = r["digital"]
        for rep, placed in zip(res["replicated"], res["placed"]):
            np.testing.assert_allclose(placed, rep, rtol=0, atol=1e-5)
        assert res["placed_counts"]["row_output"] == 2 * LAYERS * FORWARDS
        assert res["placed_counts"]["vocab"] == FORWARDS and res["placed_counts"]["psum"] == 0


@pytest.mark.parametrize("channel", ["ideal", "digital"])
def test_placed_logits_match_the_reference(serve, params_np, channel):
    from repro.models import registry as R

    jarch = R.get("qwen2-0.5b")
    jc = _jcfg(channel == "ideal")
    _, tcfg = ranks._cfg(None)
    prompt, steps = _inputs(tcfg)
    prefill = jax.jit(lambda p, t: jarch.prefill(p, {"tokens": t}, jc, MAX_SEQ))
    decode = jax.jit(lambda p, t, c: jarch.decode(p, t, c, jc))
    logits, cache = prefill(params_np, jnp.asarray(prompt.numpy(), jnp.int32))
    want = [logits]
    for t in steps[:ranks.DECODE_STEPS]:
        logits, cache = decode(params_np, jnp.asarray(t.numpy(), jnp.int32), cache)
        want.append(logits)
    for got, w in zip(serve[0][channel]["placed"], want):
        np.testing.assert_allclose(got, np.asarray(w), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# (d) the dry run's train step on placed parameters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("channel", ["digital", "ideal"])
def test_the_dry_runs_placed_train_step_stays_within_tolerance_of_the_replicated_step(train, channel):
    for r in train:
        t = r[channel]
        np.testing.assert_allclose(t["losses"], t["rep_losses"], rtol=1e-3)
        np.testing.assert_allclose(t["norms"], t["rep_norms"], rtol=1e-4)
        assert t["grads"].keys() == t["want_grads"].keys()
        for k in t["grads"]:
            assert t["grads"][k].shape == t["want_grads"][k].shape, k
            np.testing.assert_allclose(t["grads"][k], t["want_grads"][k], rtol=0, atol=1e-6, err_msg=k)
        bound = 2 * sum(t["lrs"])
        for k, got in t["params"].items():
            want = t["want_params"][k]
            ulp = np.maximum(np.abs(want) * 2.0**-7, 2.0**-133)
            assert np.all(np.abs(got - want) <= bound + ulp), k
        c = t["counts"]
        assert c["column_input"] > 0 and c["vocab"] > 0 and c["tp_rows"] == 0
        assert (c["row_output"] > 0) == (channel == "digital")


def test_train_on_a_mesh_places_the_heads_and_keeps_the_parameters_whole(train):
    for r in train:
        heads_only, both = r["heads"][3], r["heads"][4]
        # heads alone placed: the column-parallel backward gathers its output gradient and the
        # row-parallel one its input, so the run is the replicated program's bit for bit
        assert heads_only[True]["losses"] == heads_only[False]["losses"]
        for k, want in heads_only[False]["params"].items():
            np.testing.assert_array_equal(heads_only[True]["params"][k], want, err_msg=k)
        # three of a layer's six GEMMs K-shard (wo, ffn.wi, ffn.wo); wq / wk / wv are column-parallel
        assert heads_only[True]["counts"]["psum"] * 2 == heads_only[False]["counts"]["psum"]
        np.testing.assert_allclose(both[True]["losses"], both[False]["losses"], rtol=1e-5)
        for k, want in both[False]["params"].items():
            assert both[True]["params"][k].shape == want.shape  # whole on every rank
            np.testing.assert_allclose(both[True]["params"][k], want, rtol=0, atol=1e-5, err_msg=k)


def test_placed_train_parameters_are_blocks_by_their_axes(train):
    t = train[0]["digital"]["params"]
    assert t["embed/table"].shape == (128, 56)  # vocab over model
    assert t["layers/0/attn/wq/w"].shape == (56, 32) and t["layers/0/attn/wq/b"].shape == (32,)
    assert t["layers/0/attn/wk/w"].shape == (56, 8) and t["layers/0/attn/wo/w"].shape == (32, 56)
    assert t["layers/0/ffn/wi/w"].shape == (56, 112) and t["layers/0/ffn/wo/w"].shape == (56, 56)
    assert t["layers/0/ln1/scale"].shape == (56,)


# ---------------------------------------------------------------------------
# (e) the vocab-parallel loss and SwiGLU's pairing
# ---------------------------------------------------------------------------
def test_the_vocab_parallel_loss_masks_the_padded_columns_by_their_global_index(train):
    blocks = set()
    for r in train:
        v = r["loss"]
        blocks.add(v["block"])
        np.testing.assert_allclose(v["loss"], v["want"], rtol=1e-6)
        np.testing.assert_allclose(v["grad"], v["want_grad"], rtol=1e-5, atol=1e-7)
        if v["block"][0] == 1:  # the padded columns get no gradient
            np.testing.assert_array_equal(v["grad"][..., -2:], 0.0)
    assert blocks == {(0, 6), (1, 6)}


@pytest.mark.parametrize("index", [0, 1])
def test_swiglu_wi_is_placed_as_a_block_of_u_and_a_block_of_g(index):
    mesh = tshd.abstract_mesh((2, 2), ("data", "model"))
    w = torch.arange(3 * 8, dtype=torch.float32).reshape(3, 8)  # d 3, f 4: [u | g]
    wo = torch.arange(4 * 3, dtype=torch.float32).reshape(4, 3)
    pl = tshd.Placement(mesh, {"d_ff": tshd.Block("model", index, 2, 4)})
    with tshd.reenter(pl):
        got = tshd.place_params({"wi": {"w": w}, "wo": {"w": wo}},
                                {"wi": {"w": tshd.parted((None, "d_ff"), (4, 4))}, "wo": {"w": ("d_ff", None)}})
    u, g = w[:, :4], w[:, 4:]
    want = torch.cat([u[:, 2 * index: 2 * index + 2], g[:, 2 * index: 2 * index + 2]], dim=1)
    torch.testing.assert_close(got["wi"]["w"], want, rtol=0, atol=0)
    torch.testing.assert_close(got["wo"]["w"], wo[2 * index: 2 * index + 2], rtol=0, atol=0)
    with tshd.reenter(pl), tshd.use_rules(mesh):
        # a d_ff the model degree does not divide stays whole, the fallback recorded
        odd = tshd.place_params({"w": torch.zeros(3, 5)}, {"w": (None, "d_ff")})
        assert odd["w"].shape == (3, 5) and tshd.fallback_log()[0][1] == "d_ff"


# ---------------------------------------------------------------------------
# (f) the kernel's column origin
# ---------------------------------------------------------------------------
NOISY = dict(slice_bits=4, num_slices=2, n_chunk=64, adc_bits=8, noise_sigma=0.7, filter_alpha=0.1,
             intermod_eps=0.02, crossweight_eps=0.03, valid_chunks=4, tile_r=8, tile_c=128, tile_k=128)


@pytest.mark.parametrize("fused", [0, 1])
@pytest.mark.parametrize("origin,width", [(64, 64), (448, 448), (100, 200)])
def test_the_twin_at_a_column_origin_is_those_columns_of_the_whole(origin, width, fused):
    from repro_torch.kernels.photonic_gemm.kernel import photonic_gemm_fused_twin, photonic_gemm_twin

    g = torch.Generator().manual_seed(origin + width)
    total = 1024
    x = torch.randint(-127, 128, (16, 256), generator=g).to(torch.int8)
    w = torch.randint(-127, 128, (256, total), generator=g).to(torch.int8)
    pad = (-width) % 128
    block = F.pad(w[:, origin: origin + width], (0, pad))
    if fused:
        xf = torch.randn(16, 256, generator=g)
        xs, ws, b = torch.tensor(0.03), torch.rand(total, generator=g) + 0.5, torch.randn(total, generator=g)
        whole = photonic_gemm_fused_twin(xf, w, xs, ws, b, 4321, activation="silu", **NOISY)
        part = photonic_gemm_fused_twin(xf, block, xs, F.pad(ws[origin: origin + width], (0, pad)),
                                        F.pad(b[origin: origin + width], (0, pad)), 4321, activation="silu",
                                        c_origin=origin, **NOISY)
    else:
        whole = photonic_gemm_twin(x, w, 4321, **NOISY)
        part = photonic_gemm_twin(x, block, 4321, c_origin=origin, **NOISY)
    torch.testing.assert_close(part[:, :width], whole[:, origin: origin + width], rtol=0, atol=0)
    if not fused:  # without its origin the block draws another tile's noise
        alone = photonic_gemm_twin(x, block, 4321, **NOISY)
        assert not torch.equal(alone[:, :width], whole[:, origin: origin + width])


@pytest.mark.parametrize("backend", ["kernel", "ref"])
def test_int_gemm_with_columns_is_those_columns_of_the_whole(backend):
    from repro_torch.core.dpu import DPUConfig
    from repro_torch.noise.channel import build_channel_model
    from repro_torch.noise.stages import tweak_word
    from repro_torch.photonic import PhotonicEngine

    eng = PhotonicEngine(dpu=DPUConfig(organization="SMWA", bits=4, dpe_size=16,
                                       channel=build_channel_model("SMWA", n=16), noise_seed=3), backend=backend)
    g = torch.Generator().manual_seed(1)
    x = torch.randint(-127, 128, (6, 96), generator=g).to(torch.int8)
    w = torch.randint(-127, 128, (96, 300), generator=g).to(torch.int8)
    whole = eng.int_gemm(x, w, site="attn.wq", fold=1, shard=0)
    for origin, width in ((64, 64), (140, 160)):
        part = eng.int_gemm(x, w[:, origin: origin + width].contiguous(), site="attn.wq", fold=1, shard=0,
                            columns=(origin, 300), w_word=tweak_word(w))
        torch.testing.assert_close(part, whole[:, origin: origin + width], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# (g) the full-width decode cell
# ---------------------------------------------------------------------------
def test_the_qwen2_decode_cell_holds_the_references_arguments_to_the_byte():
    cell = dryrun.run_cell("qwen2-0.5b", "decode_32k", "single", device="cpu")
    assert cell["ok"] and cell["argument_size_in_bytes"] == REFERENCE_DECODE_ARGUMENTS
    assert cell["replicated_by_port"] == [] and cell["sharding_fallbacks"] == []
    assert cell["placed"] == {"batch": ["data"], "heads": "model", "kv_heads": "model", "d_ff": "model",
                              "vocab": "model"}
    arch = treg.get("qwen2-0.5b")
    cfg = arch.config.pad_for_mesh(16)
    whole = sum(s.nbytes for s in tree_items(arch.param_specs(cfg, treg.SHAPES["decode_32k"])[0]).values())
    assert cell["param_bytes"] * 16 < 1.1 * whole  # about 1/16 of the whole (the norms stay whole)
