"""The port's parameter placement for the MoE decoders
(``repro_torch.runtime.sharding.place_params`` with ``experts``, MLA's
``heads``, the shared experts' and DeepSeek-V2's first layer's ``d_ff``,
``vocab`` over ``model``) against the replicated program, the JAX reference
and the reference's dry-run shardings.

The reference's dry run holds each parameter as its ``param_axes`` place
it, the expert stacks by their leading ``experts`` dimension (expert
parallelism: "16 experts / TP=16 -> 1 expert per model shard" for
phi3.5-moe).  The port's placed step now holds the same blocks: a rank
dispatches to its own experts, runs its block of ``wi`` / ``wo``, and the
ranks' partial combines meet in one SUM all-reduce (``ffn.moe``); MLA's
``wq`` / ``wuk`` / ``wuv`` are column-parallel by heads and ``wo``
row-parallel, ``wdkv`` whole; the shared experts and the dense first layer
take the column-parallel ``wi`` and row-parallel ``wo``.  Held here, on a
spawned (data 2, model 2) ``gloo`` group with both MoE smoke configs padded
for a model degree of 2 and the reference's initial weights
(``params_from_jax``):

* (a) a prefill of 4 x 8 tokens and 2 decode steps, everything placed,
  against the replicated TP program (whole parameters, TP over "model",
  nothing placed): on the ideal channel the logits within ``atol=1e-5``
  (the port's f32 MoE parity bar: the combine sums the experts' floats in
  another order, the one place the placed program does), under SMWA with
  its key within 1e-5 except at <= 1% of logits, each within 1e-2 of the
  largest (``tests/test_torch_moe.py``'s rule for psums one LSB apart: a
  float moved by the combine can move one int8 code downstream); every
  GEMM that runs before its forward's first expert combine (layer 0's,
  then the first MoE layer's attention, router and shared experts) bitwise
  this rank's rows and columns of the replicated program's, expanded and
  absorbed decode; with every name but ``experts`` placed, the logits and
  every GEMM bitwise.  An absorbed decode step is bitwise up to its first
  core: its batched latent products fold the heads into their rows, which
  rounds by the head count a rank holds, so the GEMMs from its first
  ``attn.wo`` on, and its logits, are held within ``atol=1e-5`` (SMWA: the
  float tier above); the counts: no GEMM row gathered, one expert combine
  a MoE layer, the psums, scale reductions and content words of the
  dense decoders' placed forms; parameter bytes a rank those of the
  registry's placed specs, about half the whole;
* (b) ``ffn.moe`` alone: a rank's dispatch and combine are the whole
  one's expert columns bit for bit (default and binding capacity); its
  expert-parallel output within ``atol=1e-5`` of the replicated one, its
  aux loss bitwise (it reads the whole gates);
* (c) the placed logits, ideal channel and digital, within the reference
  parity tolerance (``atol=rtol=1e-5``) of the JAX reference's
  ``prefill`` / ``decode`` on the same parameters;
* (d) the dry run's train step (``dryrun.build_step``: placed parameters
  experts included, ZeRO-1 moments, the placed gradient norm) for two
  steps against the replicated step: the losses within ``rtol=1e-3``, the
  first gradient's blocks within ``atol=1e-6`` or, for a leaf whose
  gradients reach past 1 (the embedding: 1.7 here), one part in 2^18 of
  its largest (32 f32 ulps; 3.0e-6 apart on the CPU, the other leaves
  within 1e-6); the router's gradient within ``atol=1e-6``, where counting
  the aux loss once per model rank would move it by the aux term's own
  gradient (over 3e-4 here); one expert-input all-reduce a MoE layer in the
  backward, and the combine's twice (the forward, and its recompute under
  ``remat``);
* (e) the full-width decode_32k cells of both archs are ``ok`` and fit
  80 GB, list nothing under ``replicated_by_port``, and hold the sum of
  the reference's ``resolve_spec`` blocks of its ``param_axes`` to the
  byte.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import _torch_placement_moe_ranks as ranks  # noqa: E402
from _torch_placement_ranks import BATCH, MAX_SEQ, _inputs  # noqa: E402
from repro import compat  # noqa: E402
from repro.core.dpu import DPUConfig as JDPU  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models.common import P as JP  # noqa: E402
from repro.models.common import init_tree  # noqa: E402
from repro.runtime import sharding as jshd  # noqa: E402
from repro_torch._tree import tree_items  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.models import ffn as tffn  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.runtime import sharding as tshd  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = (ranks.DEEPSEEK, ranks.PHI)
FORWARDS = 1 + ranks.DECODE_STEPS
PHOTONIC = [(a, c) for c, a, ch, _ in ranks.SERVE_CASES if ch != "digital"]
IDEAL = [(a, c) for c, a, ch, _ in ranks.SERVE_CASES if ch == "ideal"]
# the GEMMs before a forward's first expert combine: (site, layer)
PRE_COMBINE = {
    ranks.DEEPSEEK: {(s, 0) for s in ("attn.wq", "attn.wdkv", "attn.wuk", "attn.wuv", "attn.wo", "ffn.wi", "ffn.wo")}
    | {(s, 1) for s in ("attn.wq", "attn.wdkv", "attn.wuk", "attn.wuv", "attn.wo", "ffn.router", "ffn.shared.wi",
                        "ffn.shared.wo")},
    ranks.PHI: {(s, 0) for s in ("attn.wq", "attn.wk", "attn.wv", "attn.wo", "ffn.router")},
}


@pytest.fixture(scope="module")
def params_np():
    out = {}
    for name in ARCHS:
        cfg = jreg.get(name).smoke_config.pad_for_mesh(2)
        out[name] = jax.tree.map(np.asarray, init_tree(jreg.get(name).param_defs(cfg), jax.random.PRNGKey(0),
                                                       cfg.param_dtype))
    return out


@pytest.fixture(scope="module")
def cell_runs(tmp_path_factory):
    """(e)'s full-width decode_32k cells, each in a subprocess of the dry
    run's CLI (fake tensors on the CPU), started before the group so that
    they run beside it."""
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    procs = {arch: subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
                                     "decode_32k", "--mesh", "single", "--device", "cpu", "--out", str(out)],
                                    env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
             for arch in ARCHS}
    yield out, procs
    for proc in procs.values():
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def group(params_np, cell_runs):
    return spawn(ranks.suite, 4, backend="gloo", args=(params_np,), timeout=300)


@pytest.fixture(scope="module")
def cells(group, cell_runs):
    out, procs = cell_runs
    res = {}
    for arch, proc in procs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-2000:]
        res[arch] = json.loads(dryrun._cell_path(out, arch, "decode_32k", "single").read_text())
    return res


@pytest.fixture(scope="module")
def serve(group):
    return [r["serve"] for r in group]


def _float_tier(got, want):
    """Noisy logits: within 1e-5 except at <= 1% of elements, those within
    1e-2 of the largest (``tests/test_torch_moe.py``)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    off = np.abs(got - want) > 1e-5 + 1e-5 * np.abs(want)
    assert off.mean() <= 0.01, off.mean()
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


# ---------------------------------------------------------------------------
# (a) placed prefill and decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,case", PHOTONIC)
def test_placed_moe_logits_are_within_tolerance_of_the_replicated_program(serve, arch, case):
    assert sorted(r["coords"] for r in serve) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in serve:
        res = r[(arch, case)]
        assert len(res["placed"]["logits"]) == FORWARDS
        for rep, placed, rank0 in zip(res["replicated"]["logits"], res["placed"]["logits"],
                                      serve[0][(arch, case)]["placed"]["logits"]):
            assert placed.shape == (BATCH, 1, 320)
            np.testing.assert_array_equal(placed, rank0)  # every rank gathers the same logits
            if case.startswith("SMWA"):
                _float_tier(placed, rep)
            else:
                np.testing.assert_allclose(placed, rep, rtol=0, atol=1e-5)


def _rest_within(rest, case):
    """The GEMMs after an absorbed decode step's core: ideal within
    ``atol=1e-5`` (the port's f32 MoE bar); SMWA within the float tier of
    its logits, a moved int8 code drawing another stream."""
    for site, layer, worst, off, top in rest:
        if case.startswith("SMWA"):
            assert off <= 0.01 and worst <= 1e-2 * top, (site, layer, worst, off)
        else:
            assert worst <= 1e-5, (site, layer, worst)


@pytest.mark.parametrize("arch,case", PHOTONIC)
def test_the_gemms_before_the_expert_combine_are_bitwise_the_replicated_programs(serve, arch, case):
    absorbed = "absorbed" in case
    for r in serve:
        checked, same, bad, rest = r[(arch, case)]["placed"]["gemms"]
        assert bad == []
        assert set(checked) == PRE_COMBINE[arch]
        # absorbed: the prefill's, and each decode step's wq and wdkv of layer 0, before the absorbed core
        assert same >= (len(PRE_COMBINE[arch]) + 2 * ranks.DECODE_STEPS if absorbed
                        else len(PRE_COMBINE[arch]) * FORWARDS)
        assert bool(rest) == absorbed
        _rest_within(rest, case)


@pytest.mark.parametrize("arch,case", IDEAL)
def test_everything_but_the_experts_placed_is_bitwise_the_replicated_program(serve, arch, case):
    absorbed = "absorbed" in case
    for r in serve:
        res = r[(arch, case)]
        for i, (rep, got) in enumerate(zip(res["replicated"]["logits"], res["no_experts"]["logits"])):
            if absorbed and i > 0:  # past the absorbed core, as the GEMMs
                np.testing.assert_allclose(got, rep, rtol=0, atol=1e-5)
            else:
                np.testing.assert_array_equal(got, rep)
        checked, same, bad, rest = res["no_experts"]["gemms"]
        assert bad == [] and same > (len(PRE_COMBINE[arch]) + 2 * ranks.DECODE_STEPS if absorbed
                                     else len(PRE_COMBINE[arch]) * FORWARDS)
        _rest_within(rest, case)
        assert res["no_experts"]["counts"]["expert_combine"] == 0


def _forward_counts(arch, case):
    """What one placed forward reduces and gathers (deepseek-v2-lite's
    smoke: 3 layers, the first dense; phi3.5-moe's: 2, both MoE)."""
    absorbed = "absorbed" in case
    if arch == ranks.DEEPSEEK:
        routed = 7 * 3 + 1  # wq wdkv wuk wuv wo + (wi wo | shared wi wo) a layer, lm_head
        decode_routed = routed - (6 if absorbed else 0)  # absorbed decode runs no wuk / wuv
        psum, row, column, column_decode, moe = 9, 6, 13, 13 - (6 if absorbed else 0), 2
    else:
        routed = decode_routed = 4 * 2 + 1  # wq wk wv wo a layer, lm_head
        psum, row, column, column_decode, moe = 2, 2, 7, 7, 2
    return dict(routed=routed + 2 * decode_routed, psum=psum * FORWARDS, row=row * FORWARDS,
                column=column + 2 * column_decode, moe=moe * FORWARDS)


@pytest.mark.parametrize("arch,case", PHOTONIC)
def test_a_placed_moe_forward_gathers_no_rows_and_reduces_once_a_moe_layer(serve, arch, case):
    want = _forward_counts(arch, case)
    noisy = case.startswith("SMWA")
    for r in serve:
        c = r[(arch, case)]["placed"]["counts"]
        # wdkv is whole: it K-shards as the replicated TP program does, so every rank writes the same latent rows
        assert c == dict(psum=want["psum"], amax=want["routed"], outputs=2 * FORWARDS, tp_rows=0, heads=0,
                         column_input=0, row_output=0, vocab=FORWARDS,
                         weight_words=want["column"] if noisy else 0, weight_scale=want["row"],
                         expert_combine=want["moe"], expert_input=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_placed_moe_parameters_are_the_registrys_blocks_about_half_the_whole(serve, arch):
    _, cfg = ranks._cfg(arch, "digital")
    mesh = tshd.abstract_mesh((2, 2), ("data", "model"))
    specs, _ = treg.get(arch).param_specs(cfg, ranks._shape("decode"), mesh=mesh)
    blocks = sum(s.nbytes for s in tree_items(specs).values())
    whole = sum(s.nbytes for s in tree_items(treg.get(arch).param_specs(cfg, ranks._shape("decode"))[0]).values())
    for r in serve:
        for key, res in r.items():
            if key != "coords" and key[0] == arch:
                assert res["placed"]["bytes"] == blocks and res["replicated"]["bytes"] == whole, key
    assert 0.45 < blocks / whole < 0.55


def test_the_digital_placed_moe_run_is_within_tolerance_of_the_unsharded_run(serve):
    for r in serve:
        for arch in ARCHS:
            res = r[(arch, "digital")]
            for rep, placed in zip(res["replicated"]["logits"], res["placed"]["logits"]):
                np.testing.assert_allclose(placed, rep, rtol=0, atol=1e-5)
            c = res["placed"]["counts"]
            assert c["psum"] == 0 and c["expert_combine"] == 2 * FORWARDS and c["row_output"] > 0


# ---------------------------------------------------------------------------
# (b) moe() alone
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("factor", [1.25, 0.5], ids=["capacity", "binding"])
@pytest.mark.parametrize("arch", ARCHS)
def test_a_ranks_dispatch_is_the_whole_dispatchs_expert_columns(arch, factor):
    _, cfg = ranks._cfg(arch, "digital", capacity_factor=factor)
    gen = torch.Generator().manual_seed(11)
    gates = torch.softmax(torch.randn(BATCH, 8, cfg.num_experts, generator=gen), dim=-1)
    topv, topi = tffn._top_k(gates, cfg.num_experts_per_tok)
    topv = topv / topv.sum(-1, keepdim=True)
    cap = tffn._capacity(cfg, 8)
    experts = torch.arange(cfg.num_experts)
    dispatch, combine = tffn._dispatch(topi, topv, experts, cap, torch.float32)
    if factor < 1:
        assert dispatch.sum() < BATCH * 8 * cfg.num_experts_per_tok  # tokens are dropped
    for mine in experts.chunk(2):
        d, c = tffn._dispatch(topi, topv, mine, cap, torch.float32)
        torch.testing.assert_close(d, dispatch[:, :, mine], rtol=0, atol=0)
        torch.testing.assert_close(c, combine[:, :, mine], rtol=0, atol=0)


@pytest.mark.parametrize("factor", [1.25, 0.5], ids=["capacity", "binding"])
@pytest.mark.parametrize("arch", ARCHS)
def test_expert_parallel_moe_is_within_tolerance_of_the_replicated_moe(group, arch, factor):
    _, cfg = ranks._cfg(arch, "digital")
    for r in group:
        m = r["moe"][(arch, factor)]
        np.testing.assert_allclose(m["out"], m["want"], rtol=0, atol=1e-5)
        assert m["aux"] == m["want_aux"]
        assert m["stack"] == (cfg.num_experts // 2, cfg.d_model, 2 * cfg.moe_hidden)
        assert m["counts"]["expert_combine"] == 1


# ---------------------------------------------------------------------------
# (c) against the JAX reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("channel", ["ideal", "digital"])
@pytest.mark.parametrize("arch", ARCHS)
def test_placed_moe_logits_match_the_reference(serve, params_np, arch, channel):
    jarch = jreg.get(arch)
    jc = jarch.smoke_config.pad_for_mesh(2)
    if channel == "ideal":
        jc = dataclasses.replace(jc, photonic=JDPU(organization="SMWA", bits=4, datarate_gs=5.0),
                                 photonic_backend="ref")
    _, tcfg = ranks._cfg(arch, "digital")
    prompt, steps = _inputs(tcfg)
    prefill = jax.jit(lambda p, t: jarch.prefill(p, {"tokens": t}, jc, MAX_SEQ))
    decode = jax.jit(lambda p, t, c: jarch.decode(p, t, c, jc))
    logits, cache = prefill(params_np[arch], jnp.asarray(prompt.numpy(), jnp.int32))
    want = [logits]
    for t in steps[:ranks.DECODE_STEPS]:
        logits, cache = decode(params_np[arch], jnp.asarray(t.numpy(), jnp.int32), cache)
        want.append(logits)
    for got, w in zip(serve[0][(arch, channel)]["placed"]["logits"], want):
        np.testing.assert_allclose(got, np.asarray(w), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# (d) the dry run's train step on placed parameters
# ---------------------------------------------------------------------------
TRAIN = [(a, c) for c, a, _ in ranks.TRAIN_CASES]


@pytest.mark.parametrize("arch,case", TRAIN)
def test_the_dry_runs_placed_moe_train_step_stays_within_tolerance_of_the_replicated_step(group, arch, case):
    for r in group:
        t = r["train"][(arch, case)]
        np.testing.assert_allclose(t["losses"], t["rep_losses"], rtol=1e-3)
        assert t["grads"].keys() == t["want_grads"].keys()
        for k, got in t["grads"].items():
            want = t["want_grads"][k]
            assert got.shape == want.shape, k
            np.testing.assert_allclose(got, want, rtol=0, atol=max(1e-6, 2.0**-18 * np.abs(want).max()), err_msg=k)
        c = t["grad_counts"]
        # one expert-input reduction a MoE layer in the backward; the combine's forward all-reduce runs again
        # when remat recomputes the layer
        assert c["expert_input"] == 2 and c["expert_combine"] == 2 * 2 and c["tp_rows"] == 0 and c["column_input"] > 0


@pytest.mark.parametrize("arch,case", TRAIN)
def test_the_routers_gradient_counts_the_aux_loss_once(group, arch, case):
    for r in group:
        t = r["train"][(arch, case)]
        assert len(t["aux_router"]) == 2
        for k, aux in t["aux_router"].items():
            np.testing.assert_allclose(t["grads"][k], t["want_grads"][k], rtol=0, atol=1e-6, err_msg=k)
            # the negative control: the aux term's own share, what a second count would add
            assert np.abs(aux).max() > 100 * 1e-6, k


def test_expert_stacks_and_their_moments_are_blocks_by_their_axes(group):
    for r in group:
        for (arch, _), t in r["train"].items():
            _, cfg = ranks._cfg(arch, "digital")
            e, d, f = cfg.num_experts // 2, cfg.d_model, cfg.moe_hidden
            for k, shape in t["stacks"].items():
                assert shape == ((e, d, 2 * f) if k.endswith("wi") else (e, f, d)), k
                # ZeRO-1 splits the first dimension the reference's zero1_axes leaves unnamed
                want = (e, d // 2, 2 * f) if k.endswith("wi") else (e, f // 2, d)
                assert t["moment_stacks"][k] == want, k


# ---------------------------------------------------------------------------
# (e) the full-width decode cells
# ---------------------------------------------------------------------------
def _reference_param_bytes(name):
    """The bytes of one device's blocks of the reference's parameters on
    the ``single`` (16, 16) mesh: each leaf's ``resolve_spec`` block."""
    jarch = jreg.get(name)
    cfg = jarch.config.pad_for_mesh(16)
    mesh = compat.abstract_mesh((16, 16), ("data", "model"))
    total = 0
    for p in jax.tree.leaves(jarch.param_defs(cfg), is_leaf=lambda x: isinstance(x, JP)):
        spec = tuple(jshd.resolve_spec(p.shape, p.axes, mesh))
        n = 1
        for d, size in enumerate(p.shape):
            part = spec[d] if d < len(spec) else None
            names = () if part is None else (part if isinstance(part, tuple) else (part,))
            n *= size // math.prod(mesh.shape[a] for a in names)
        total += n * jnp.dtype(p.dtype or cfg.param_dtype).itemsize
    return total


@pytest.mark.parametrize("arch", ARCHS)
def test_the_moe_decode_cells_hold_the_references_parameter_bytes(cells, arch):
    cell = cells[arch]
    assert cell["ok"] and cell["fits_device"]
    assert cell["replicated_by_port"] == [] and cell["sharding_fallbacks"] == []
    assert cell["placed"]["experts"] == "model" and cell["placed"]["heads"] == "model"
    assert cell["param_bytes"] == _reference_param_bytes(arch)
