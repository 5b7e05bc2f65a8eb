"""The port's placement of the two sequence axes against the replicated
program on the same mesh and against the JAX reference.

The reference constrains the residual stream to ``("batch", "seq_sp",
None)`` after the embedding and after every block, so that between blocks a
device holds its block of the sequence over "model", and it places the
decode cache ``(batch, kv_seq, ...)`` by ``kv_seq`` over "data" where the
rows cannot take "data" (one row at ``long_500k``), its GSPMD partitioning
the decode softmax across the blocks.  The port holds the same blocks
(``repro_torch.runtime.sharding``: ``seq_gather`` / ``seq_scatter``,
``kv_merge``).  Held here, on a spawned (data 2, model 2) ``gloo`` group
(``tests/_torch_placement_seq_ranks.py``) at smoke size:

* (a) qwen2-0.5b's smoke config padded for model 2: a prefill of 4 x 8
  tokens with the rows, heads and ``seq_sp`` placed gives logits bitwise
  the replicated program's, ideal and SMWA with its noise key, and its
  residual between blocks is a rank's 2 rows x 4 positions; the training
  forward's logits are bitwise too;
* (b) two ``train(mesh=(2, 2), tp_axis="model")`` steps with ``seq_sp``
  placed are bitwise the same run without it (the norms gather the
  sequence after normalizing the block, so every gradient sums its terms
  in the replicated program's order), and within ``rtol`` / ``atol`` 1e-5
  of the replicated run, as ``tests/test_torch_placement.py`` (c) holds
  the placed rows;
* (c) whisper-medium's smoke prefill and training forward with its
  ``audio_embed`` placed by ``seq_sp`` (encoder residual a block of the
  frames, the training decoder's a block of its own positions), and
  zamba2-2.7b's (the Mamba2 layers and the shared block gathering the
  sequence they scan), bitwise the replicated program;
* (d) ``kv_seq`` at one row: a cache of 32 positions over "data" (16 a
  rank), a prompt of 20 (across both blocks) and one of 14 whose decode
  steps cross the boundary: qwen2-0.5b's logits within ``atol = rtol =
  1e-5`` of the replicated program digitally (no engine) and of the JAX
  reference's; on the ideal channel within ``1e-5`` of their largest
  magnitude (measured on the CPU: 1.5e-7 and 2.2e-7 of it); with the
  ``MAX`` all-reduce of the row max skipped the logits miss that bar by
  far (a rank whose block is all masked adds ``exp(0)`` for every position
  of it); deepseek-v2-lite's MLA decode absorbed and expanded within the
  same bars, and expanded under SMWA raises (its noise ids need a row
  origin in the kernel); whisper-medium's digital decode, its cross cache a
  block of the encoder frames, within the digital bar; every cache leaf
  holds ``max_seq / 2`` positions (whisper's cross cache half its frames);
* (e) the sequence axes' blocks against the reference's ``resolve_spec``
  on the cache and residual leaves of the abstract (16, 16) and (2, 16, 16)
  meshes (``kv_seq`` resolved after ``batch``: it takes "data" only where
  the rows fall back), and the dry run's train, prefill and one-row decode
  cells of a dense arch at smoke size list nothing under
  ``replicated_by_port`` and count the new collectives.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import _torch_placement_seq_ranks as ranks  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro import compat  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models.common import init_tree  # noqa: E402
from repro.runtime import sharding as jshd  # noqa: E402
from repro_torch._tree import tree_items  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.runtime import sharding as tshd  # noqa: E402

KV_ATOL = KV_RTOL = 1e-5  # digital: the merged softmax sums in another order


def _seq(**counts):
    """``contracts.SEQ_COLLECTIVES`` with ``counts`` and every other key 0."""
    from repro_torch.analysis import contracts

    return {k: counts.get(k, 0) for k in contracts.SEQ_COLLECTIVES}
IDEAL_BAR = 1e-5  # the ideal channel's logits, of their largest magnitude
CONTROL_BAR = 2.0**-5  # chip_smoke's phase 10 bar, which the control must miss


def _reference_params(name):
    cfg = jreg.get(name).smoke_config.pad_for_mesh(2)
    return jax.tree.map(np.asarray, init_tree(jreg.get(name).param_defs(cfg), jax.random.PRNGKey(0),
                                              cfg.param_dtype))


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    return spawn(ranks.suite, 4, backend="gloo", args=(str(tmp_path_factory.mktemp("seq")),), timeout=600)


# ---------------------------------------------------------------------------
# (a) and (c): seq_sp, bitwise the replicated program
# ---------------------------------------------------------------------------
def _layers(name):
    return ranks._cfg(name, "digital")[1]


def _want_residuals(name, kind):
    """The residual shapes a rank's constraints see, in order: 2 rows and
    its block of the positions (whisper: the encoder's frames, then the
    training decoder's tokens)."""
    cfg = _layers(name)
    if name == ranks.WHISPER:
        enc = [(2, ranks.ENC_SEQ // 2, cfg.d_model)] * (1 + cfg.encoder_layers)
        return enc + ([(2, ranks.DEC_SEQ // 2, cfg.d_model)] * cfg.num_layers if kind == "train" else [])
    if name == ranks.ZAMBA:
        if kind == "prefill":
            return []  # the reference constrains no prefill residual
        return [(2, ranks.PROMPT // 2, cfg.d_model)] * (1 + cfg.num_layers + cfg.num_layers // cfg.attn_every)
    per = 2 if kind == "train" else 1  # the training block constrains after attention and after the FFN
    return [(2, ranks.PROMPT // 2, cfg.d_model)] * ((kind == "train") + per * cfg.num_layers)


@pytest.mark.parametrize("case", ranks.seq_cases(), ids=lambda c: "-".join(map(str, c[:3])))
def test_seq_sp_is_bitwise_the_replicated_program(group, case):
    name, channel, kind, _ = case
    for r in group:
        res = r["seq"][(name, channel, kind)]
        assert res["sizes"]["seq_sp"] == (ranks.ENC_SEQ if name == ranks.WHISPER else ranks.PROMPT)
        np.testing.assert_array_equal(res["placed"]["logits"], res["replicated"]["logits"])
        np.testing.assert_array_equal(res["placed"]["logits"], group[0]["seq"][(name, channel, kind)]["placed"]
                                      ["logits"])
        assert res["placed"]["residuals"] == _want_residuals(name, kind)
        assert res["replicated"]["seq"]["gather"] == 0
        assert res["placed"]["seq"]["gather"] > 0 or (name, kind) == (ranks.ZAMBA, "prefill")


def test_a_placed_prefill_gathers_twice_a_layer_and_once_for_its_last_position(group):
    cfg = _layers(ranks.QWEN)
    for r in group:
        for channel in ("ideal", "SMWA"):
            got = r["seq"][(ranks.QWEN, channel, "prefill")]["placed"]["seq"]
            # the Megatron form: each layer's two blocks reduce-scatter their outputs (attention's wo, the MLP's wo)
            assert got == _seq(gather=2 * cfg.num_layers + 1, scatter=2 * cfg.num_layers)


# ---------------------------------------------------------------------------
# (b) train(mesh=) with seq_sp placed
# ---------------------------------------------------------------------------
def test_training_with_seq_sp_is_bitwise_the_run_without_it(group):
    layers = _layers(ranks.QWEN).num_layers
    for r in group:
        t = r["train"]
        assert t["seq"]["losses"] == t["no_seq"]["losses"]
        for k, v in t["seq"]["params"].items():
            np.testing.assert_array_equal(v, t["no_seq"]["params"][k], err_msg=k)
        np.testing.assert_allclose(t["seq"]["losses"], t["replicated"]["losses"], rtol=1e-5)
        for k, v in t["seq"]["params"].items():
            np.testing.assert_allclose(v, t["replicated"]["params"][k], rtol=0, atol=1e-5, err_msg=k)
        # a step: the forward's and the remat recompute's gathers, the backward's of every cut residual
        assert t["seq"]["seq"] == _seq(gather=2 * (4 * layers + 1), split_grad=2 * (2 * layers + 1),
                                       scatter=2 * 4 * layers)
        assert t["no_seq"]["seq"]["gather"] == 0
        np.testing.assert_array_equal(t["seq"]["params"]["embed/table"], group[0]["train"]["seq"]["params"]
                                      ["embed/table"])


# ---------------------------------------------------------------------------
# (d) kv_seq: the decode cache over "data", the softmax merged
# ---------------------------------------------------------------------------
def _kv(group, name, channel, absorbed, t):
    return [r["kv"][(name, channel, absorbed, t)] for r in group]


def _kv_ids(c):
    return f"{c[0]}-{c[1]}-{'absorbed' if c[2] else 'expanded'}"


@pytest.mark.parametrize("case", ranks.kv_cases(), ids=_kv_ids)
def test_a_kv_seq_placed_decode_holds_its_bar(group, case):
    name, channel, absorbed, prompts = case
    cfg = _layers(name)
    for t in prompts:
        for res in _kv(group, name, channel, absorbed, t):
            rep, placed = res["replicated"]["logits"], res["placed"]["logits"]
            assert len(placed) == 1 + ranks.KV_STEPS
            if channel == "digital":
                for got, want in zip(placed, rep):
                    np.testing.assert_allclose(got, want, atol=KV_ATOL, rtol=KV_RTOL)
            else:
                largest = max(float(np.abs(x).max()) for x in rep)
                worst = max(float(np.abs(a - b).max()) for a, b in zip(placed, rep))
                assert worst <= IDEAL_BAR * largest, (t, worst, largest)
            attn = cfg.num_layers * (2 if name == ranks.WHISPER else 1)  # whisper: self- and cross-attention
            assert res["placed"]["seq"] == _seq(kv_max=attn * ranks.KV_STEPS, kv_sum=attn * ranks.KV_STEPS)
            assert res["replicated"]["seq"]["kv_max"] == 0
            for key, shape in res["placed"]["cache"].items():
                whole = res["replicated"]["cache"][key]
                at = 1 if key.startswith("first/") else 2  # the position axis, after the layer axis of a stack
                n = ranks.ENC_SEQ if key.startswith("cross/") else ranks.KV_MAX_SEQ  # whisper's cross cache: frames
                assert shape[at] == whole[at] // 2 == n // 2, key


def test_kv_seq_takes_data_where_the_one_row_falls_back(group):
    for r in group:
        data, model = r["coords"]
        assert r["kv"]["blocks"] == {"heads": ("model", model, 2, 8), "kv_heads": ("model", model, 2, 2),
                                     "kv_seq": ("data", data, 2, ranks.KV_MAX_SEQ)}


def test_the_row_max_must_meet_across_the_blocks(group):
    for res in _kv(group, ranks.QWEN, "ideal", False, ranks.KV_PROMPTS[1]):
        rep, control = res["replicated"]["logits"], res["no_max"]["logits"]
        largest = max(float(np.abs(x).max()) for x in rep)
        worst = max(float(np.abs(a - b).max()) for a, b in zip(control, rep))
        # decode steps with the second block all masked: its rank adds exp(0) for each of its positions
        assert worst > 4 * CONTROL_BAR * largest, worst
        np.testing.assert_array_equal(control[0], rep[0])  # the prefill attends over its own K/V


@pytest.mark.parametrize("backend,tp,rows", ranks.noisy_cases(), ids=lambda v: str(v))
def test_an_expanded_mla_decode_on_a_noisy_channel_is_the_replicated_programs(group, backend, tp, rows):
    """deepseek-v2-lite's expanded decode over a ``kv_seq`` cache on seeded
    SMWA: every routed GEMM of the placed steps, replayed on the replicated
    run's input, is bitwise its output (``wuk`` / ``wuv`` on the rank's
    block of the latent rows), and the logits hold the merge's bar.  Without
    TP the blocks run at their row origins with the whole operand's word
    (one SUM of the word a ``wuk`` / ``wuv``), and either control (origin
    0 on the second block, the block's own word) breaks the replay of
    both; under TP the
    replicated program splits the rows over "data" as the cache is
    placed at one row, and nothing is summed; at three rows its split
    cuts across the rows, and the rank gathers its latent rows (two
    all-gathers a layer and step) and expands them whole."""
    for r in group:
        res = r["kv"]["smwa_expanded"][(backend, tp, rows)]
        checked, same, bad = res["replay"]
        assert checked == same > 0 and not bad
        rep, placed = res["replicated"]["logits"], res["placed"]["logits"]
        largest = max(float(np.abs(x).max()) for x in rep)
        assert max(float(np.abs(a - b).max()) for a, b in zip(placed, rep)) <= IDEAL_BAR * largest
        np.testing.assert_array_equal(placed[0], rep[0])  # the prefill attends over its own K/V
        per = ranks.NOISY_LAYERS * ranks.NOISY_STEPS
        assert res["placed"]["seq"] == _seq(kv_max=per, kv_sum=per, kv_word=0 if tp else 2 * per,
                                            kv_rows=2 * per if tp and rows > 1 else 0)
        for control in ("origin_0", "block_word"):
            if control in res:
                wrong = {site for site, _ in res[control][2]}
                if control == "origin_0" and r["coords"][0] == 0:  # the first block's origin is 0
                    assert not wrong
                else:
                    assert {"attn.wuk", "attn.wuv"} <= wrong, (control, res[control])
        assert ("origin_0" in res) == (backend == "kernel" and not tp and rows == 1)


def test_the_kv_seq_decode_is_the_references(group):
    """qwen2-0.5b's digital prefill and decode steps, placed by ``kv_seq``,
    against the JAX reference's on the same parameters (``init_tree``
    under ``PRNGKey(0)``, which the ranks draw with the port's
    ``init_params``) and tokens."""
    jarch = jreg.get(ranks.QWEN)
    jc = jarch.smoke_config.pad_for_mesh(2)
    _, cfg = ranks._cfg(ranks.QWEN, "digital")
    t = ranks.KV_PROMPTS[0]
    prompt, steps = ranks.kv_inputs(cfg, t)
    params = _reference_params(ranks.QWEN)
    logits, cache = jax.jit(lambda p, b: jarch.prefill(p, b, jc, ranks.KV_MAX_SEQ))(
        params, {"tokens": jnp.asarray(prompt.numpy(), jnp.int32)})
    want = [np.asarray(logits)]
    decode = jax.jit(lambda p, tok, c: jarch.decode(p, tok, c, jc))
    for tok in steps:
        logits, cache = decode(params, jnp.asarray(tok.numpy(), jnp.int32), cache)
        want.append(np.asarray(logits))
    for res in _kv(group, ranks.QWEN, "digital", False, t):
        for got, w in zip(res["placed"]["logits"], want):
            np.testing.assert_allclose(got, w, atol=KV_ATOL, rtol=KV_RTOL)


# ---------------------------------------------------------------------------
# (e) the sequence axes' blocks against the reference's resolve_spec
# ---------------------------------------------------------------------------
MESHES = {"16x16": ((16, 16), ("data", "model")), "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _shard(shape, spec, sizes, d):
    part = spec[d] if d < len(spec) else None
    names = () if part is None else (part if isinstance(part, tuple) else (part,))
    return shape[d] // int(np.prod([sizes[a] for a in names]))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("rows", [1, 2, 16, 128])
def test_the_sequence_blocks_are_the_references_shards(mesh_name, rows):
    dims, names = MESHES[mesh_name]
    jmesh, tmesh = compat.abstract_mesh(dims, names), tshd.abstract_mesh(dims, names)
    sizes = dict(zip(names, dims))
    for leaf, axes, name in (((rows, 4096, 2, 64), ("batch", "kv_seq", "kv_heads", None), "kv_seq"),
                             ((rows, 4096, 896), ("batch", "seq_sp", None), "seq_sp")):
        placed = tshd.placed_parts({"batch": rows, name: leaf[1]}, tmesh)
        spec = jshd.resolve_spec(leaf, axes, jmesh)
        for d, logical in ((0, "batch"), (1, name)):
            want = _shard(leaf, spec, sizes, d)
            part = placed.get(logical)
            got = leaf[d] // int(np.prod([sizes[a] for a in ((part,) if isinstance(part, str) else part or ())]))
            assert got == want, (leaf, logical, placed, spec)


def _config():
    return dataclasses.replace(treg.get("qwen2-0.5b").smoke_config, d_model=64, num_heads=8)


@pytest.mark.parametrize("kind,rows", [("train", 32), ("prefill", 32), ("decode", 1)])
def test_the_dry_run_places_both_sequence_axes(kind, rows):
    cell = dryrun.run_cell("qwen2-0.5b", None, "single", device="cpu", config=_config(),
                           shape=treg.ShapeSpec(f"smoke_{kind}", 16, rows, kind))
    assert cell["ok"] and cell["replicated_by_port"] == [] and cell["replicated_by_port_bytes"] == {}
    seq = cell["seq_collectives"]
    if kind == "decode":
        assert cell["placed"]["kv_seq"] == "data" and "batch" not in cell["placed"]
        layers = _config().num_layers
        assert seq == _seq(kv_max=layers, kv_sum=layers)
        arch, cfg = treg.get("qwen2-0.5b"), _config().pad_for_mesh(16)
        (_, _), (cache, _) = arch.decode_specs(cfg, treg.ShapeSpec("s", 16, rows, "decode"))
        whole = sum(s.nbytes for s in tree_items(cache).values() if s.shape)
        assert cell["cache_bytes"] == whole // 256 + 4  # 16 positions a rank of "data", heads a rank of "model"
    else:
        assert cell["placed"]["seq_sp"] == "model"
        assert seq["gather"] > 0 and seq["kv_max"] == 0
        assert (seq["split_grad"] > 0) == (kind == "train")
        # the Megatron form: every block's output and the embedding's vocab-parallel sum reduce-scattered (the
        # remat recompute, which stops once the backward's saved inputs are back, runs attention's again); in
        # training each entry's input gradient too (the parameters placed), and no all-reduce of either
        layers = _config().num_layers
        assert seq["scatter"] == (3 if kind == "train" else 2) * layers + 1
        assert seq["gather_grad"] == seq["norm_grad"] == (2 * layers if kind == "train" else 0)
        wire = cell["seq_wire_bytes"]
        assert wire["scatter"] > 0 and (wire["gather_grad"] > 0) == (kind == "train")
        assert cell["bytes_reduce-scatter"] >= wire["scatter"] + wire["gather_grad"]
    assert cell["fits_device"]


# ---------------------------------------------------------------------------
# (f) every collective through one helper
# ---------------------------------------------------------------------------
COLLECTIVES = {"all_reduce", "all_gather", "all_gather_into_tensor", "reduce_scatter", "reduce_scatter_tensor",
               "broadcast", "reduce", "gather", "scatter", "all_to_all", "all_to_all_single", "send", "recv",
               "isend", "irecv", "batch_isend_irecv", "P2POp", "all_gather_object", "broadcast_object_list"}


def test_every_collective_of_the_port_goes_through_the_staging_helper():
    """An AST scan of ``src/repro_torch``: a ``torch.distributed`` data
    collective (or a point-to-point op) is called, or imported by name, in
    ``runtime/collectives.py`` alone, which stages CUDA tensors through the
    host on a ``gloo`` group."""
    import ast
    from pathlib import Path

    root = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
    helper = root / "runtime" / "collectives.py"
    found, outside = set(), []
    for path in sorted(root.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        aliases = {"dist"} | {a.asname or a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                              for a in n.names if a.name == "torch.distributed"}
        for node in ast.walk(tree):
            name = None
            if isinstance(node, ast.Attribute) and node.attr in COLLECTIVES and (
                    isinstance(node.value, ast.Name) and node.value.id in aliases
                    or ast.unparse(node.value) == "torch.distributed"):
                name = node.attr
            elif isinstance(node, ast.ImportFrom) and (node.module or "").startswith("torch.distributed"):
                name = next((a.name for a in node.names if a.name in COLLECTIVES), None)
            if name is not None:
                (found.add(name) if path == helper else outside.append((str(path.relative_to(root)), node.lineno,
                                                                         name)))
    assert not outside, outside
    assert {"all_reduce", "all_gather", "reduce_scatter", "batch_isend_irecv"} <= found
