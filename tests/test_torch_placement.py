"""The port's per-device placement (``repro_torch.runtime.sharding.placement``)
against the replicated program on the same mesh and against the JAX
reference's shardings.

The reference holds a step's values in blocks (GSPMD ``in_shardings`` and
``with_sharding_constraint``); the port, SPMD over ``torch.distributed``,
now holds the same blocks along the logical names it places: the batch rows
over the data axes, the q / KV heads of GQA attention and its dense cache
over ``model`` in prefill and decode, and ZeRO-1 optimizer moments in the
dry run's train step.  Held here:

* (a) on a spawned (data 2, model 2) ``gloo`` group, qwen2-0.5b's smoke
  config padded for a model degree of 2 (8 q / 2 KV heads, 4 / 1 a rank),
  photonic on the kernel backend's CPU twin with TP over "model": a prefill
  of 4 x 8 tokens and 4 decode steps with the rows and heads placed give
  logits bitwise those of the replicated program on the same mesh, on the
  ideal channel and under SMWA with its noise key (``noise_seed``), and on
  ideal bitwise TP = 1 (no mesh at all); the placed run gathers no GEMM's
  rows (``ROW_GATHERS["tp_rows"] == 0``), takes every routed GEMM's scale
  from one ``MAX`` all-reduce, runs ``attn.wq`` / ``wk`` / ``wv``
  column-parallel on its heads' columns of the whole weights (no int32
  all-reduce: half the replicated program's) and gathers only the logits;
  its cache leaves hold 2 rows and 1 KV head.  With no engine (digital) the same holds, the
  heads gathered over "model" before each ``attn.wo``;
* (b) for every batch, token, cache and moment leaf of the smoke configs of
  a dense, an MLA, two recurrent and the audio family, on the abstract
  (16, 16) and (2, 16, 16) meshes of ``repro.compat.abstract_mesh``: along
  each dimension the reference's ``resolve_spec`` places by a name the port
  places, the port's block has the reference's shard size; along every
  other dimension the reference places, the port holds the whole dimension
  and the dry run's ``replicated_by_port`` names the leaf and the logical
  name (the params' own axes on the moments of the families that hold
  their parameters whole, the dense decoders' moments being their
  parameter blocks); the sequence axes are placed (``kv_seq`` over data at
  one row or where the rows take "pod" alone, whisper's ``audio_embed``
  by ``seq_sp``), ``tests/test_torch_placement_seq.py`` holding them;
* (c) ``train(mesh=(2, 2), tp_axis="model")`` with placed rows, ideal
  channel, two steps: the losses within ``rtol=1e-5`` and every parameter
  within ``atol=1e-5`` of the replicated run (``place_rows=False``; the
  gradient is summed over the ranks in another order, 7.2e-7 apart on the
  CPU); killed at step 1 and resumed from its checkpoint, bitwise the
  uninterrupted placed run; digital, with two microbatches splitting each
  rank's rows, every parameter within ``atol=1e-5`` of the replicated
  run's two microbatches;
* (d) the ZeRO-1 update (``adamw.update(shards=)``) over "data": moments a
  rank are half along each leaf's ``zero1`` dimension, two steps from the
  same gradients bitwise the replicated update, the moments this rank's
  blocks of the replicated ones;
* (e) a placed dry-run cell at smoke size on the fake 256-rank mesh reports
  ``param_bytes`` (the rank's parameter blocks, heads, KV heads, ``d_ff``
  and vocab over ``model``) and an empty ``replicated_by_port``, its cache
  a rank 1/256 of the global cache; ``--no-zero1`` gives moments whole
  along ``zero1``, as the reference's ``zero1=False`` holds them.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import _torch_placement_ranks as ranks  # noqa: E402
from repro import compat  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.runtime import sharding as jshd  # noqa: E402
from repro_torch._tree import tree_items  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models.common import axes_tree  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import sharding as tshd  # noqa: E402


@pytest.fixture(scope="module")
def decode():
    return spawn(ranks.decode_suite, 4, backend="gloo", timeout=300)


@pytest.fixture(scope="module")
def train(tmp_path_factory):
    return spawn(ranks.train_suite, 4, backend="gloo", args=(str(tmp_path_factory.mktemp("placed")),), timeout=300)


# ---------------------------------------------------------------------------
# (a) placed prefill and decode, bitwise the replicated program
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("channel", ["ideal", "SMWA"])
def test_placed_prefill_and_decode_are_bitwise_the_replicated_program(decode, channel):
    assert sorted(r["coords"] for r in decode) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in decode:
        res = r[channel]
        assert len(res["placed"]) == 1 + ranks.STEPS
        for rep, placed, rank0 in zip(res["replicated"], res["placed"], decode[0][channel]["placed"]):
            assert placed.shape == (ranks.BATCH, 1, 256)
            np.testing.assert_array_equal(placed, rep)
            np.testing.assert_array_equal(placed, rank0)  # every rank gathers the same logits
        if channel == "ideal":
            for tp1, placed in zip(res["tp1"], res["placed"]):
                np.testing.assert_array_equal(placed, tp1)
        assert res["fallbacks"] == []


def test_a_placed_step_gathers_no_gemm_rows(decode):
    gemms = 6 * 2 * (1 + ranks.STEPS)  # six routed GEMMs a layer, two layers, five calls
    for r in decode:
        for channel in ("ideal", "SMWA"):
            res = r[channel]
            assert res["replicated_counts"] == dict(psum=gemms, tp_rows=gemms, outputs=0, amax=0, heads=0)
            # wq / wk / wv column-parallel over the placed heads: only wo, ffn.wi, ffn.wo K-shard
            assert res["placed_counts"] == dict(psum=gemms // 2, tp_rows=0, outputs=1 + ranks.STEPS, amax=gemms,
                                                heads=0)
            data, model = r["coords"]
            assert res["blocks"] == {"batch": (("data",), data, 2, ranks.BATCH), "heads": ("model", model, 2, 8),
                                     "kv_heads": ("model", model, 2, 2)}
            full = (2, ranks.BATCH, ranks.MAX_SEQ, 2, 8)
            assert res["replicated_cache"] == {"k": full, "v": full}
            assert res["placed_cache"] == {"k": (2, 2, ranks.MAX_SEQ, 1, 8), "v": (2, 2, ranks.MAX_SEQ, 1, 8)}


def test_the_digital_path_gathers_heads_before_wo(train):
    for r in train:
        d = r["digital"]
        for rep, placed in zip(d["replicated"], d["placed"]):
            np.testing.assert_array_equal(placed, rep)
        assert d["counts"] == dict(psum=0, tp_rows=0, outputs=1 + ranks.STEPS, amax=0, heads=2 * (1 + ranks.STEPS))


def test_a_global_sized_dimension_under_a_placement_raises():
    mesh = tshd.abstract_mesh((2, 2), ("data", "model"))
    x = torch.zeros(4, 3)
    pl = tshd.Placement(mesh, {"batch": tshd.Block(("data",), 0, 2, 4)})
    with tshd.reenter(pl):
        with pytest.raises(ValueError, match="not placed"):
            tshd.logical_constraint(x, ("batch", None))
        assert tshd.logical_constraint(x[:2], ("batch", None)) is not None
    assert tshd.logical_constraint(x, ("batch", None)) is x  # no placement: nothing checked


# ---------------------------------------------------------------------------
# (b) local block shapes against the reference's resolve_spec
# ---------------------------------------------------------------------------
MESHES = {"16x16": ((16, 16), ("data", "model")), "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
FAMILIES = ["qwen2-0.5b", "deepseek-v2-lite-16b", "phi3.5-moe-42b-a6.6b", "xlstm-350m", "zamba2-2.7b", "whisper-medium"]
SHAPES = [("train", 64), ("prefill", 64), ("decode", 64), ("decode", 2), ("decode", 1)]


def _ref_leaves(sds, axes):
    flat, treedef = compat.tree_flatten(sds)
    return [(tuple(s.shape), tuple(a)) for s, a in zip(flat, treedef.flatten_up_to(axes))]


def _ref_block(shape, spec, sizes):
    out = []
    for d, n in enumerate(shape):
        part = spec[d] if d < len(spec) else None
        names = () if part is None else (part if isinstance(part, tuple) else (part,))
        out.append(n // math.prod(sizes[a] for a in names))
    return tuple(out), [spec[d] if d < len(spec) else None for d in range(len(shape))]


def _check_leaves(label, ref, port_global, port_local, placed, gaps, sizes, jmesh):
    assert len(ref) == len(port_global) == len(port_local)
    for (key, gshape), (jshape, jaxes), local in zip(port_global, ref, port_local):
        assert gshape == jshape, (label, key)
        block, parts = _ref_block(jshape, jshd.resolve_spec(jshape, jaxes, jmesh), sizes)
        for d, (n, part, name) in enumerate(zip(jshape, parts, jaxes)):
            if part is not None and name in placed:
                assert local[d] == block[d], (label, key, d, name)
            else:
                assert local[d] == n, (label, key, d, name)
                if part is not None:
                    assert (key, name) in gaps, (label, key, name)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name", FAMILIES)
def test_local_blocks_are_the_references_shards(name, mesh_name):
    dims, axis_names = MESHES[mesh_name]
    jmesh = compat.abstract_mesh(dims, axis_names)
    tmesh = tshd.abstract_mesh(dims, axis_names)
    sizes = dict(zip(axis_names, dims))
    jarch, tarch = jreg.get(name), treg.get(name)
    jcfg, cfg = jarch.smoke_config.pad_for_mesh(16), tarch.smoke_config.pad_for_mesh(16)
    for kind, batch in SHAPES:
        tshape = treg.ShapeSpec(f"{kind}{batch}", 64, batch, kind)
        jshape = jreg.ShapeSpec(f"{kind}{batch}", 64, batch, kind)
        placed = set(tshd.placed_parts(tarch.placement_sizes(cfg, tshape), tmesh))
        gaps = {(g["leaf"].split("/", 1)[1], g["logical"]) for g in
                dryrun.replicated_leaves(tarch, cfg, tshape, tmesh)}
        if kind == "decode":
            (jtok, jtok_axes), (jcache, jcache_axes) = jarch.decode_specs(jcfg, jshape)
            ref = _ref_leaves({"cache": jcache, "token": jtok}, {"cache": jcache_axes, "token": jtok_axes})
            (tok, _), (cache, _) = tarch.decode_specs(cfg, tshape)
            (ltok, _), (lcache, _) = tarch.decode_specs(cfg, tshape, mesh=tmesh)
            glob, loc = {"cache": cache, "token": tok}, {"cache": lcache, "token": ltok}
        else:
            spec_fn = "train_batch_spec" if kind == "train" else "prefill_batch_spec"
            ref = _ref_leaves(*getattr(jarch, spec_fn)(jcfg, jshape))
            glob = getattr(tarch, spec_fn)(cfg, tshape)[0]
            loc = getattr(tarch, spec_fn)(cfg, tshape, mesh=tmesh)[0]
        port_global = [(k, tuple(s.shape)) for k, s in tree_items(glob).items()]
        port_local = [tuple(s.shape) for s in tree_items(loc).values()]
        _check_leaves(f"{name} {kind} B={batch}", ref, port_global, port_local, placed, gaps, sizes, jmesh)
        if (kind, batch) == ("decode", 1):
            assert "batch" not in placed  # one row: kv_seq takes data instead (xLSTM has no cache), checked above
            assert ("kv_seq" in placed) == (tarch.family != "ssm")
        if kind != "train":
            continue
        # the moments: ZeRO-1 along the reference's zero1 dimension, every other axis whole
        defs = tarch.param_defs(cfg)
        dp = math.prod(sizes[a] for a in axis_names[:-1])
        moment_axes = jshd.zero1_axes(axes_tree(defs), defs, dp)
        shards = adamw.zero1(defs, axes_tree(defs), tmesh)
        moment_gaps = {(g["leaf"].split("/", 2)[2], g["logical"]) for g in
                       dryrun.replicated_leaves(tarch, cfg, tshape, tmesh) if g["leaf"].startswith("opt/mu/")}
        ref = [(tuple(p.shape), a) for p, a in zip(tree_items(defs).values(), _axes_list(moment_axes, defs))]
        glob = [(k, tuple(p.shape)) for k, p in tree_items(defs).items()]
        # the moments are the rank's parameter blocks (the dense decoders' placed axes) split along zero1
        blocks = tree_items(tarch.param_specs(cfg, tshape, mesh=tmesh)[0]).values()
        loc = [tuple(n // shards.count if d == dim else n for d, n in enumerate(p.shape))
               for p, dim in zip(blocks, tree_items(shards.dims).values())]
        _check_leaves(f"{name} moments", ref, glob, loc, {"zero1"} | placed, moment_gaps, sizes, jmesh)
        split = any(dim is not None for dim in tree_items(shards.dims).values())
        assert shards.count == (dp if split else 1)


def _axes_list(axes, like):
    return list(tshd._axes_items(axes, tree_items(like)).values())


# ---------------------------------------------------------------------------
# (c) train(mesh=) with placed rows
# ---------------------------------------------------------------------------
def test_placed_training_stays_within_tolerance_of_the_replicated_run(train):
    for r in train:
        t = r["train"]
        np.testing.assert_allclose(t["losses"], t["rep_losses"], rtol=1e-5)
        assert t["params"].keys() == t["rep_params"].keys()
        for k in t["params"]:
            np.testing.assert_allclose(t["params"][k], t["rep_params"][k], rtol=0, atol=1e-5, err_msg=k)
        assert t["counts"]["tp_rows"] == 0 and t["counts"]["amax"] == t["counts"]["psum"] > 0
        for k in t["params"]:  # every rank holds the same parameters
            np.testing.assert_array_equal(t["params"][k], train[0]["train"]["params"][k])


def test_placed_microbatches_split_the_local_rows(train):
    for r in train:
        placed, rep = r["microbatches"][True], r["microbatches"][False]
        for k in placed:
            np.testing.assert_allclose(placed[k], rep[k], rtol=0, atol=1e-5, err_msg=k)


def test_placed_training_resumes_from_its_checkpoint_bitwise(train):
    for r in train:
        t = r["train"]
        assert t["crashed"] and t["resumed_final"] == 2
        assert t["resumed_losses"] == t["losses"][1:]
        for k in t["params"]:
            np.testing.assert_array_equal(t["resumed_params"][k], t["params"][k], err_msg=k)


# ---------------------------------------------------------------------------
# (d) ZeRO-1
# ---------------------------------------------------------------------------
def test_zero1_update_is_bitwise_the_replicated_update(train):
    for r in train:
        z = r["zero1"]
        assert z["count"] == 2 and z["part"] == ("data",)
        for k in z["rep"]:
            np.testing.assert_array_equal(z["zero1"][k], z["rep"][k], err_msg=k)
            np.testing.assert_array_equal(z["mu"][k], z["mu_block_of_rep"][k], err_msg=k)
        split = 0
        for k, (shape, moment, dim) in z["shapes"].items():
            want = list(shape)
            if dim is not None:
                want[dim] //= 2
                split += 1
            assert moment == tuple(want), k
        assert split > 0


# ---------------------------------------------------------------------------
# (e) the dry run's placed cells
# ---------------------------------------------------------------------------
def _config():
    """qwen2-0.5b's smoke config at a width the data degree divides (so
    some moments split)."""
    return dataclasses.replace(treg.get("qwen2-0.5b").smoke_config, d_model=64, num_heads=8)


def _cell(kind, **kw):
    return dryrun.run_cell("qwen2-0.5b", None, "single", device="cpu", config=_config(),
                           shape=treg.ShapeSpec(f"smoke_{kind}", 16, 32, kind), **kw)


PLACED_DENSE = {"batch": ["data"], "heads": "model", "kv_heads": "model", "d_ff": "model", "vocab": "model"}


def _block_bytes(arch, cfg, kind):
    """The bytes of this rank's parameter blocks on the (16, 16) mesh."""
    shape = treg.ShapeSpec(f"smoke_{kind}", 16, 32, kind)
    specs, _ = arch.param_specs(cfg, shape, mesh=tshd.abstract_mesh((16, 16), ("data", "model")))
    return [s.nbytes for s in tree_items(specs).values()]


def test_a_placed_decode_cell_reports_what_the_port_still_replicates():
    cell = _cell("decode")
    assert cell["ok"] and cell["placed"] == PLACED_DENSE
    arch = treg.get("qwen2-0.5b")
    cfg = _config().pad_for_mesh(16)
    (_, _), (cache, _) = arch.decode_specs(cfg, treg.ShapeSpec("s", 16, 32, "decode"))
    global_cache = sum(s.nbytes for s in tree_items(cache).values() if s.shape)
    assert cell["cache_bytes"] == global_cache // 256 + 4  # and the position, an int32 on the host
    params = sum(_block_bytes(arch, cfg, "decode"))
    whole = sum(math.prod(p.shape) * 4 for p in tree_items(arch.param_defs(cfg)).values())
    assert cell["param_bytes"] == params and 16 * params < 1.1 * whole  # the norms stay whole
    assert cell["argument_size_in_bytes"] == params + cell["cache_bytes"] + 32 // 16 * 4
    assert cell["replicated_by_port"] == [] and cell["replicated_by_port_bytes"] == {}  # the params are placed
    assert cell["fits_device"] and cell["sharding_fallbacks"] == []


@pytest.mark.parametrize("zero1", [True, False], ids=["zero1", "no_zero1"])
def test_a_placed_train_cell_holds_zero1_moments_unless_asked_not_to(zero1):
    cell = _cell("train", zero1=zero1)
    # a train step places the residual's sequence too (seq_sp over model)
    assert cell["ok"] and cell["zero1"] is zero1 and cell["placed"] == {**PLACED_DENSE, "seq_sp": "model"}
    arch = treg.get("qwen2-0.5b")
    cfg = _config().pad_for_mesh(16)
    defs = arch.param_defs(cfg)
    shards = adamw.zero1(defs, axes_tree(defs), tshd.abstract_mesh((16, 16), ("data", "model")))
    blocks = _block_bytes(arch, cfg, "train")  # f32 parameters: a moment block has the parameter block's bytes
    if zero1:
        want = sum(n // (16 if d is not None else 1) for n, d in zip(blocks, tree_items(shards.dims).values()))
        assert want < sum(blocks)
    else:
        want = sum(blocks)
    assert cell["optimizer_state_bytes"] == 2 * want + 4  # mu, nu and the int32 step
    # the moments by the parameters' axes (and zero1, unless --no-zero1), as the reference's
    assert cell["replicated_by_port"] == []

