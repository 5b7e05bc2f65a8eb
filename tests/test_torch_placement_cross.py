"""The port's parameter placement for the audio and vision families
(whisper-medium, llama-3.2-vision-90b: ``heads``, ``kv_heads``, ``d_ff``
and ``vocab`` over ``model``, ``runtime.sharding.place_params``) against
the replicated program, the JAX reference and the reference's dry-run
shardings.

Every attention and MLP takes the dense decoders' placed forms:
column-parallel ``wq`` / ``wk`` / ``wv`` and ``ffn.wi`` (whisper's GELU
``wi`` is one part, SwiGLU's two), row-parallel ``wo`` and ``ffn.wo``; the
cross-attention's ``wk`` / ``wv`` write the rank's KV heads of the cross
cache; llama-3.2-vision's ``gate`` / ``gate_ffn`` stay whole; the
embedding and head are vocab-parallel.  Held here, on a spawned (data 2,
model 2) ``gloo`` group (``tests/_torch_placement_cross_ranks.py``) with
both smoke configs padded for a model degree of 2 and the reference's
initial weights (``params_from_jax``; the vision gates drawn from a
seeded normal on both sides, since at their zero init a cross layer is the
identity):

* (a) a prefill of 4 x 8 tokens (whisper: against 16 encoder frames;
  vision: 16 patches) and 2 decode steps (SMWA: the prefill alone, the
  noisy twin being slow on the CPU), everything placed,
  against the replicated program (whole parameters, nothing placed; TP
  over "model" on the photonic channels): the logits bitwise, ideal and
  SMWA; digitally within ``atol=rtol=1e-5`` (the row-parallel GEMMs' f32
  partial products summed in another order); every routed GEMM of the
  placed run, called again on this rank's block of the replicated run's
  input, bitwise this rank's block of its output; the reductions of a
  placed forward; parameter bytes a rank those of the registry's placed
  specs, about half the whole;
* (b) the digital placed logits within ``atol=rtol=1e-5`` of the JAX
  reference's ``prefill`` / ``decode`` on the same parameters (the
  photonic channels' placed runs are bitwise the replicated program in
  (a); on the ideal channel at these seeded gates the vision smoke
  config's first decode step flips one int8 code in one row against the
  reference, the port's single-device run as much as its placed one, the
  flip ``tests/test_torch_vlm.py`` describes);
* (c) the dry run's train step (``dryrun.build_step``) for two steps
  against the replicated step: losses within ``rtol=1e-3``, the first
  gradient's blocks each within ``1e-4`` of its largest;
* (d) every parameter and cache leaf's block against the reference's
  ``resolve_spec`` on abstract meshes of model 2 and 16;
* (e) the full-width decode_32k cells hold the sum of the reference's
  ``resolve_spec`` blocks of its ``param_axes`` to the byte (the
  registry's placed specs, which the dry run materializes), and
  llama-3.2-vision-90b's cell, run, is ``ok``, fits 80 GB (178.7 GB a rank
  with its parameters whole) and lists nothing under
  ``replicated_by_port``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import _torch_placement_cross_ranks as cross  # noqa: E402
import _torch_placement_family_checks as checks  # noqa: E402
import _torch_placement_recurrent_ranks as ranks  # noqa: E402
from repro_torch._tree import tree_items  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.runtime import sharding as tshd  # noqa: E402

ARCHS = cross.SERVE_ARCHS
PHOTONIC = [(a, c) for a in ARCHS for c in ("ideal", "SMWA")]
SITES = ["attn.wk", "attn.wo", "attn.wq", "attn.wv", "ffn.wi", "ffn.wo", "lm_head"]


@pytest.fixture(scope="module")
def params_np():
    return checks.reference_params(ARCHS)


# the cells run as dry-run subprocesses: llama-3.2-vision-90b's (its peak is the point); whisper-medium's decode_32k
# traces its 32,768-frame cross cache for about a minute, so its parameter bytes are read off the registry's specs
CELLS = (ranks.VISION,)


@pytest.fixture(scope="module")
def cell_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    procs = checks.start_cells(CELLS, out)
    yield out, procs
    checks.stop_cells(procs)


@pytest.fixture(scope="module")
def group(params_np, cell_runs):
    return spawn(cross.suite, 4, backend="gloo", args=(params_np,), timeout=300)


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
def test_placed_cross_logits_against_the_replicated_program(serve, arch, channel):
    assert sorted(r["coords"] for r in serve) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in serve:
        res = r[(arch, channel)]
        assert len(res["placed"]["logits"]) == _forwards(channel)
        for rep, got in zip(res["replicated"]["logits"], res["placed"]["logits"]):
            assert got.shape == (ranks.BATCH, 1, 320)
            if channel == "digital":
                np.testing.assert_allclose(got, rep, rtol=1e-5, atol=1e-5)
            else:
                np.testing.assert_array_equal(got, rep)


@pytest.mark.parametrize("arch,channel", PHOTONIC)
def test_every_routed_cross_gemm_replays_bitwise_on_the_replicated_input(serve, arch, channel):
    for r in serve:
        checked, same, bad = r[(arch, channel)]["replay"]
        assert bad == [] and checked == SITES
        assert same == r[(arch, channel)]["placed"]["counts"]["amax"]


def _want_counts(arch, channel):
    """Routed GEMMs, row-parallel GEMMs and psums of the placed forwards:
    whisper's smoke config has 2 encoder and 2 decoder layers (the
    decoder's cross K/V computed in the prefill only); llama-3.2-vision's
    4 self layers and 2 cross layers (their K/V over the patches in the
    prefill only)."""
    f = _forwards(channel) - 1
    if arch == ranks.WHISPER:
        prefill = 2 * 6 + 2 * (6 + 4) + 1  # encoder: wq wk wv wo wi wo; decoder: + cross wq wk wv wo; head
        decode = 2 * (6 + 2) + 1  # decode reads the cross cache: no cross wk / wv
        rows = (2 * 2 + 2 * 3, 2 * 3)  # wo ffn.wo an encoder layer; wo, cross wo, ffn.wo a decoder layer
    else:
        prefill = 4 * 6 + 2 * 6 + 1  # self layers; cross layers (wq wk wv wo wi wo); head
        decode = 4 * 6 + 2 * 4 + 1
        rows = (6 * 2, 6 * 2)
    return dict(routed=prefill + f * decode, rows=rows[0] + f * rows[1])


@pytest.mark.parametrize("arch,channel", [(a, c) for a in ARCHS for c in ranks.CHANNELS])
def test_a_placed_cross_forward_reduces_once_a_row_parallel_gemm(serve, arch, channel):
    want = _want_counts(arch, channel)
    for r in serve:
        c = r[(arch, channel)]["placed"]["counts"]
        assert c["tp_rows"] == 0 and c["heads"] == 0 and c["outputs"] == 2 * _forwards(channel)
        assert all(c[k] == 0 for k in c if k.startswith("recurrent_"))
        if channel == "digital":
            assert c["psum"] == 0 and c["row_output"] == want["rows"]
        else:
            assert c["amax"] == want["routed"] and c["weight_scale"] == want["rows"] == c["psum"]
            assert c["row_output"] == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_placed_cross_parameters_are_the_registrys_blocks_about_half_the_whole(serve, arch):
    _, cfg = ranks.cfg_of(arch, "digital")
    mesh = tshd.abstract_mesh((2, 2), ("data", "model"))
    specs, _ = treg.get(arch).param_specs(cfg, ranks.shape_of("decode"), mesh=mesh)
    blocks = sum(s.nbytes for s in tree_items(specs).values())
    whole = sum(s.nbytes for s in tree_items(treg.get(arch).param_specs(cfg, ranks.shape_of("decode"))[0]).values())
    for r in serve:
        for channel in ranks.CHANNELS:
            res = r[(arch, channel)]
            assert res["placed"]["bytes"] == blocks and res["replicated"]["bytes"] == whole
    assert 0.45 < blocks / whole < 0.55


# ---------------------------------------------------------------------------
# (b) against the JAX reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_placed_cross_logits_match_the_reference(serve, params_np, arch):
    want = checks.reference_logits(arch, params_np[arch])
    for g, w in zip(serve[0][(arch, "digital")]["placed"]["logits"], want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# (c) the dry run's train step on placed parameters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,channel", cross.TRAIN_CASES)
def test_the_dry_runs_placed_cross_train_step_stays_within_tolerance(group, arch, channel):
    for r in group:
        t = r["train"][(arch, channel)]
        np.testing.assert_allclose(t["losses"], t["rep_losses"], rtol=1e-3)
        assert t["grads"].keys() == t["want_grads"].keys()
        for k, got in t["grads"].items():
            want = t["want_grads"][k]
            assert got.shape == want.shape, k
            np.testing.assert_allclose(got, want, rtol=0, atol=max(1e-6, 1e-4 * np.abs(want).max()), err_msg=k)
        c = t["grad_counts"]
        assert c["column_input"] > 0 and c["tp_rows"] == 0 and c["recurrent_split_input"] == 0


# ---------------------------------------------------------------------------
# (d) leaf blocks against the reference's resolve_spec
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("model", [2, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_cross_leaf_blocks_are_the_references(arch, model):
    placed = checks.check_leaf_blocks(arch, model)
    assert {"heads", "kv_heads", "d_ff", "vocab"} <= placed


# ---------------------------------------------------------------------------
# (e) the full-width decode cells
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def cells(group, cell_runs):
    return checks.read_cells(*cell_runs)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_cross_decode_cells_hold_the_references_parameter_bytes(cells, arch):
    assert checks.port_param_bytes(arch) == checks.reference_param_bytes(arch)
    if arch not in cells:
        return
    cell = cells[arch]
    assert cell["ok"] and cell["fits_device"]
    assert cell["replicated_by_port"] == []
    # a decode token's one position cannot split over "model": the reference's seq_sp fallback, recorded
    assert {f["logical"] for f in cell["sharding_fallbacks"]} <= {"seq_sp"}
    assert cell["placed"]["d_ff"] == "model" and cell["placed"]["vocab"] == "model"
    assert cell["param_bytes"] == checks.port_param_bytes(arch)
