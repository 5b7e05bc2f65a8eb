"""The port's parameter and state placement for the recurrent families
(xlstm-350m, zamba2-2.7b: ``inner`` and ``mamba_heads`` over ``model``,
``runtime.sharding.place_params``) against the replicated program, the
JAX reference and the reference's dry-run shardings.

The reference's dry run holds each parameter as its ``param_axes`` place
it and each recurrent state as its cache axes do: the xLSTM and Mamba2
projections by ``inner``, Mamba2's heads and SSM state by
``mamba_heads``, the mLSTM state ``C`` / ``n`` on the key dimension.  The
port's placed step holds the same blocks (module docstrings of
``models/xlstm.py`` and ``models/ssm.py``).  Held here, on a spawned
(data 2, model 2) ``gloo`` group (``tests/_torch_placement_recurrent_
ranks.py``) with both smoke configs padded for a model degree of 2 and the
reference's initial weights (``params_from_jax``; the zero-initialized
mLSTM gates and Mamba2 biases drawn from a seeded normal on both sides):

* (a) a prefill of 4 x 8 tokens and 2 decode steps (SMWA: the prefill
  alone, the noisy twin being slow on the CPU), everything
  placed, against the replicated program (whole parameters, nothing
  placed; TP over "model" on the photonic channels): zamba2's logits
  bitwise, ideal and SMWA (the gather before ``out_norm`` keeps its sums;
  ``out_proj``'s int32 partials sum exactly); xLSTM's within
  ``atol=rtol=1e-5`` ideal and SMWA (the mLSTM state's partial readouts
  meet in an f32 SUM over ``model``, another order than the replicated sum
  over ``d``); digitally both within ``atol=rtol=5e-5`` (the row-parallel
  ``down`` / ``out_proj`` partial products summed in f32 too, carried
  through the recurrences); every routed GEMM of the placed run, called
  again on this rank's block of the replicated run's input, bitwise this
  rank's block of its output; the collectives of a placed forward;
  parameter bytes a rank those of the registry's placed specs, about half
  the whole, and the recurrent states a rank about half the rows' share;
* (b) the digital placed logits against the JAX reference's ``prefill``
  / ``decode`` on the same parameters within ``atol=rtol=1e-3`` (the
  recurrent bar of ROADMAP Queue 3 item 10), and no further from the
  port's f64 run than twice the replicated port's distance (the photonic
  channels' placed runs are held to the replicated program in (a), whose
  parity with the reference ``tests/test_torch_xlstm.py`` and
  ``tests/test_torch_ssm.py`` hold).  Queue 3 item
  10's other half, twice the reference's distance, is not met by the
  replicated port itself at these seeded gates: the reference lies 2.0e-5
  to 3.1e-5 from f64, the replicated port 4.5e-5 to 6.4e-5, the placed
  port 5.6e-5 to 6.9e-5 (ROADMAP Queue 3);
* (c) the dry run's train step (``dryrun.build_step``: placed parameters,
  ZeRO-1 moments, the placed gradient norm) for two steps against the
  replicated step: losses within ``rtol=1e-3``, the first gradient's
  blocks each within ``1e-4`` of its largest (f32 sums in other orders
  through the mLSTM normalizer; 3.7e-5 at most here);
* (d) every parameter and cache leaf's block against the reference's
  ``resolve_spec`` on abstract meshes of model 2 and 16;
* (e) the full-width decode_32k cells are ``ok`` and fit 80 GB, list
  nothing under ``replicated_by_port`` and hold the sum of the reference's
  ``resolve_spec`` blocks of its ``param_axes`` to the byte.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import _torch_placement_family_checks as checks  # noqa: E402
import _torch_placement_recurrent_ranks as ranks  # noqa: E402
from repro_torch._tree import tree_items  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.runtime import sharding as tshd  # noqa: E402

ARCHS = ranks.SERVE_ARCHS
PHOTONIC = [(a, c) for a in ARCHS for c in ("ideal", "SMWA")]
# the routed sites of one forward (the mLSTM's gates wi / wf run whole; the lm_head is routed)
SITES = {ranks.XLSTM: ["down", "lm_head", "up", "wf", "wi", "wk", "wq", "wv", "wx"],
         ranks.ZAMBA: ["attn.wk", "attn.wo", "attn.wq", "attn.wv", "ffn.wi", "ffn.wo", "in_proj", "lm_head",
                       "out_proj"]}


@pytest.fixture(scope="module")
def params_np():
    return checks.reference_params(ARCHS)


@pytest.fixture(scope="module")
def cell_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    procs = checks.start_cells(ARCHS, out)
    yield out, procs
    checks.stop_cells(procs)


@pytest.fixture(scope="module")
def group(params_np, cell_runs):
    return spawn(ranks.suite, 4, backend="gloo", args=(params_np,), timeout=300)


@pytest.fixture(scope="module")
def serve(group):
    return [r["serve"] for r in group]


def _forwards(channel):
    return 1 + ranks.steps_of(channel)


# ---------------------------------------------------------------------------
# (a) placed against replicated
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("channel", ranks.CHANNELS)
@pytest.mark.parametrize("arch", ARCHS)
def test_placed_recurrent_logits_against_the_replicated_program(serve, arch, channel):
    assert sorted(r["coords"] for r in serve) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in serve:
        res = r[(arch, channel)]
        assert len(res["placed"]["logits"]) == _forwards(channel)
        for rep, got, rank0 in zip(res["replicated"]["logits"], res["placed"]["logits"],
                                   serve[0][(arch, channel)]["placed"]["logits"]):
            assert got.shape == (ranks.BATCH, 1, 256)
            np.testing.assert_array_equal(got, rank0)  # every rank gathers the same logits
            if channel == "digital":
                np.testing.assert_allclose(got, rep, rtol=5e-5, atol=5e-5)
            elif arch == ranks.ZAMBA:
                np.testing.assert_array_equal(got, rep)
            else:
                np.testing.assert_allclose(got, rep, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch,channel", PHOTONIC)
def test_every_routed_gemm_replays_bitwise_on_the_replicated_input(serve, arch, channel):
    for r in serve:
        checked, same, bad = r[(arch, channel)]["replay"]
        assert bad == []
        assert checked == SITES[arch]
        assert same == r[(arch, channel)]["placed"]["counts"]["amax"]  # one scale MAX a routed GEMM


def _want_counts(arch, channel):
    """What the placed forwards reduce and gather: the smoke configs have 2
    groups (xLSTM: one mLSTM and one sLSTM layer each; Zamba2: two Mamba2
    layers and the shared block)."""
    f = _forwards(channel)
    if arch == ranks.XLSTM:
        # per forward: up wq wk wv wi wf down a mLSTM layer, wx down a sLSTM layer, the head
        want = dict(recurrent_xin=2, recurrent_parts=2 + 2, recurrent_state_sum=2, recurrent_norm=0, rows=4,
                    routed=2 * 7 + 2 * 2 + 1, psum=2 * 3 + 2)
    else:
        # per forward: in_proj out_proj a Mamba2 layer, wq wk wv wo ffn.wi ffn.wo a shared block, the head
        want = dict(recurrent_xin=0, recurrent_parts=4, recurrent_state_sum=0, recurrent_norm=4, rows=4 + 2 * 2,
                    routed=4 * 2 + 2 * 6 + 1, psum=4 + 2 * 2)
    return {k: v * f for k, v in want.items()}


@pytest.mark.parametrize("arch,channel", [(a, c) for a in ARCHS for c in ranks.CHANNELS])
def test_a_placed_recurrent_forward_gathers_and_reduces_once_a_layer(serve, arch, channel):
    want = _want_counts(arch, channel)
    photonic = channel != "digital"
    for r in serve:
        c = r[(arch, channel)]["placed"]["counts"]
        assert {k: c[k] for k in want if k.startswith("recurrent_")} == {
            k: v for k, v in want.items() if k.startswith("recurrent_")}
        assert c["tp_rows"] == 0 and c["heads"] == 0 and c["recurrent_split_input"] == 0
        assert c["outputs"] == 2 * _forwards(channel) and c["vocab"] == _forwards(channel)
        if photonic:  # the row-parallel GEMMs and the whole gates reduce their int32 partials
            assert c["psum"] == want["psum"] and c["amax"] == want["routed"] and c["row_output"] == 0
            assert c["weight_scale"] == want["rows"]
        else:
            assert c["psum"] == 0 and c["row_output"] == want["rows"]


@pytest.mark.parametrize("arch", ARCHS)
def test_placed_recurrent_parameters_and_states_are_about_half_a_ranks_share(serve, arch):
    _, cfg = ranks.cfg_of(arch, "digital")
    mesh = tshd.abstract_mesh((2, 2), ("data", "model"))
    shape = ranks.shape_of("decode")
    specs, _ = treg.get(arch).param_specs(cfg, shape, mesh=mesh)
    blocks = sum(s.nbytes for s in tree_items(specs).values())
    whole = sum(s.nbytes for s in tree_items(treg.get(arch).param_specs(cfg, shape)[0]).values())
    (_, _), (cache, _) = treg.get(arch).decode_specs(cfg, shape, mesh=mesh)
    for r in serve:
        for channel in ranks.CHANNELS:
            res = r[(arch, channel)]
            assert res["placed"]["bytes"] == blocks and res["replicated"]["bytes"] == whole
            for k, s in res["placed"]["state_shapes"].items():
                assert s == tuple(tree_items(cache)[k].shape), k
            # the rows halve over "data" in both; "model" halves the placed states once more
            assert 0.45 < res["placed"]["state_bytes"] / (res["replicated"]["state_bytes"] / 2) < 0.55
    assert 0.45 < blocks / whole < 0.55


# ---------------------------------------------------------------------------
# (b) against the JAX reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_placed_recurrent_logits_match_the_reference(serve, params_np, arch):
    want = checks.reference_logits(arch, params_np[arch])
    res = serve[0][(arch, "digital")]
    f64 = checks.f64_logits(arch, params_np[arch])
    for g, rep, w, e in zip(res["placed"]["logits"], res["replicated"]["logits"], want, f64):
        np.testing.assert_allclose(g, w, atol=1e-3, rtol=1e-3)
        # the placement's own cost: no further from f64 than twice the replicated port's distance
        assert np.abs(g - e).max() <= 2 * np.abs(rep - e).max()


# ---------------------------------------------------------------------------
# (c) the dry run's train step on placed parameters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,channel", ranks.TRAIN_CASES)
def test_the_dry_runs_placed_recurrent_train_step_stays_within_tolerance(group, arch, channel):
    for r in group:
        t = r["train"][(arch, channel)]
        np.testing.assert_allclose(t["losses"], t["rep_losses"], rtol=1e-3)
        assert t["grads"].keys() == t["want_grads"].keys()
        for k, got in t["grads"].items():
            want = t["want_grads"][k]
            assert got.shape == want.shape, k
            np.testing.assert_allclose(got, want, rtol=0, atol=max(1e-6, 1e-4 * np.abs(want).max()), err_msg=k)
        c = t["grad_counts"]
        # the backward sums the split work's replicated inputs over "model"
        assert c["recurrent_split_input"] > 0 and c["column_input"] > 0 and c["tp_rows"] == 0
        if arch == ranks.XLSTM:
            assert c["recurrent_state_sum"] == 2 * 2  # the forward and its recompute under remat
        else:
            assert c["recurrent_norm"] == 2 * 4


# ---------------------------------------------------------------------------
# (d) leaf blocks against the reference's resolve_spec
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("model", [2, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_leaf_blocks_are_the_references(arch, model):
    placed = checks.check_leaf_blocks(arch, model)
    if model == 2 or arch == ranks.XLSTM:
        assert "inner" in placed
    if arch == ranks.ZAMBA:
        # the smoke config's 8 Mamba2 heads do not split 16 ways: inner and mamba_heads stay whole together
        assert ("mamba_heads" in placed) == ("inner" in placed) == (model == 2)


def test_a_parted_leaf_is_a_block_of_each_part():
    from repro_torch.models import ssm

    _, cfg = ranks.cfg_of(ranks.ZAMBA, "digital")
    defs = ssm.mamba_def(cfg)
    from repro_torch.models.common import axes_tree

    axes = axes_tree(defs)
    inner, st, h = 2 * cfg.d_model, cfg.ssm_state_size, 2 * cfg.d_model // cfg.ssm_head_dim
    w = torch.arange(cfg.d_model * (2 * inner + 2 * st + h), dtype=torch.float32).reshape(cfg.d_model, -1)
    mesh = tshd.abstract_mesh((2, 2), ("data", "model"))
    for index in (0, 1):
        pl = tshd.Placement(mesh, {"inner": tshd.Block("model", index, 2, inner),
                                   "mamba_heads": tshd.Block("model", index, 2, h)})
        with tshd.reenter(pl):
            got = tshd.place_params({"in_proj": {"w": w}}, {"in_proj": axes["in_proj"]})["in_proj"]["w"]
        cuts = [(0, inner), (inner, inner), (2 * inner, 2 * st), (2 * inner + 2 * st, h)]
        want = torch.cat([w[:, o + index * n // 2: o + (index + 1) * n // 2] for o, n in cuts], dim=1)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# (e) the full-width decode cells
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def cells(group, cell_runs):
    return checks.read_cells(*cell_runs)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_recurrent_decode_cells_hold_the_references_parameter_bytes(cells, arch):
    cell = cells[arch]
    assert cell["ok"] and cell["fits_device"]
    assert cell["replicated_by_port"] == [] and cell["sharding_fallbacks"] == []
    assert cell["placed"]["inner"] == "model"
    assert cell["param_bytes"] == checks.port_param_bytes(arch) == checks.reference_param_bytes(arch)
