"""The port's logical-axis sharding, mesh padding, optimizer-state axes,
gradient compression and elastic restore against the JAX reference.

Held here:

* ``resolve_spec`` (shape-aware fallback, tuple-prefix fallback, each mesh
  axis used once), ``fallback_log``, rule overrides and ``zero1_axes``,
  equal to the reference's on rank-free meshes ``(data, model)`` in
  {(1, 1), (4, 2), (2, 16)} and ``(pod, data, model) = (2, 4, 2)``, for
  every leaf of every registered smoke config; the port's ``axes_tree``
  equal to the reference's leaf for leaf (the reference's stacked layer
  axes carry one leading ``None`` per stacking);
* ``ModelConfig.pad_for_mesh`` field for field the reference's for the ten
  configs (published and smoke) at tp in {2, 4, 8, 16}, refusals included,
  and qwen2-0.5b's smoke config after ``pad_for_mesh(4)``: loss and every
  gradient leaf within ``tests/test_torch_train.py``'s digital bars
  (``rtol=1e-5``; gradients ``rtol=1e-5, atol=1e-6``);
* ``opt_state_axes``; ``quantize_dequantize`` / ``with_error_feedback``
  bitwise, a zero-size leaf included;
* on one spawned ``gloo`` group of four ranks, with subgroups of one and
  two: ``compressed_psum`` bitwise the reference's, and
  ``ring_int8_allreduce`` bitwise an f32 emulation of the reference's ring
  in which ``acc + q * s`` rounds twice; the reference (run once in a
  subprocess on four forced host devices) equals the same emulation with
  that add fused into one rounding (an FMA, computed in f64), so where the
  two differ, XLA's contraction is the whole difference (ROADMAP Queue 3
  item 3); ``restore(shardings=)`` giving DTensors on a (2, 2) mesh whose
  full tensors are bitwise the saved leaves, each rank holding its
  ``torch.chunk`` block.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.compat import abstract_mesh as jabstract_mesh  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.optim import adamw as jopt  # noqa: E402
from repro.optim import compress as jcomp  # noqa: E402
from repro.runtime import sharding as jshd  # noqa: E402
from repro_torch._tree import tree_items  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.models import common as tcm  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.optim import adamw as topt  # noqa: E402
from repro_torch.optim import compress as tcomp  # noqa: E402
from repro_torch.runtime import sharding as tshd  # noqa: E402
from repro_torch.runtime import train_loop as ttl  # noqa: E402
from repro_torch.weights import STACKED, params_from_jax  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = sorted(jreg.names())
MESHES = [((1, 1), ("data", "model")), ((4, 2), ("data", "model")), ((2, 16), ("data", "model")),
          ((2, 4, 2), ("pod", "data", "model"))]
MESH_IDS = ["1x1", "4x2", "2x16", "2x4x2"]


def _spec(p):
    """A spec as a tuple, a one-axis tuple entry as its name (JAX's
    ``PartitionSpec`` equality identifies ``("data",)`` with ``"data"``)."""
    entries = (tuple(e) if isinstance(e, list) else e for e in p)
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries)


def _ref_leaves(defs, path=()):
    if isinstance(defs, jcm.P):
        yield "/".join(path), defs
        return
    for k in sorted(defs):
        yield from _ref_leaves(defs[k], path + (k,))


def _port_leaves(defs, path=()):
    if isinstance(defs, tcm.P):
        yield "/".join(path), defs
        return
    items = enumerate(defs) if isinstance(defs, list) else ((k, defs[k]) for k in sorted(defs))
    for k, v in items:
        yield from _port_leaves(v, path + (str(k),))


def _ref_key(port_key):
    """The reference leaf a port leaf is a row of, and how many stacking
    axes lead it."""
    parts = port_key.split("/")
    for j, p in enumerate(parts):
        depth = STACKED.get(p, 0)
        if depth and all(q.isdigit() for q in parts[j + 1 : j + 1 + depth]):
            return "/".join(parts[: j + 1] + parts[j + 1 + depth :]), depth
    return port_key, 0


def _rules(cfg, extra):
    rules = dict(cfg.logical_rules or {})
    rules.update(extra)
    return rules or None


@pytest.mark.parametrize("arch", ARCHS)
def test_axes_tree_is_the_references_leaf_for_leaf(arch):
    ja, ta = jreg.get(arch), treg.get(arch)
    want = dict(_ref_leaves(ja.param_defs(ja.smoke_config)))
    tdefs = ta.param_defs(ta.smoke_config)
    seen = set()
    axes = tcm.axes_tree(tdefs)
    for key, p in _port_leaves(tdefs):
        ref_key, depth = _ref_key(key)
        node = axes
        for part in key.split("/"):
            node = node[int(part)] if isinstance(node, list) else node[part]
        assert node == p.axes
        assert want[ref_key].axes == (None,) * depth + p.axes, key
        assert want[ref_key].shape[depth:] == p.shape, key
        seen.add(ref_key)
    assert seen == set(want)


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_resolve_spec_and_fallbacks_equal_the_references(arch, mesh):
    shape, names = mesh
    ja = jreg.get(arch)
    cfg = ja.smoke_config
    leaves = list(_ref_leaves(ja.param_defs(cfg)))
    # activations too: batch-like and sequence-like names over odd sizes
    leaves += [(f"act{i}", jcm.P(s, a)) for i, (s, a) in enumerate([
        ((6, 7), ("batch", "heads")), ((2, 16), ("batch", None)), ((8, 8, 4), ("batch", "kv_seq", "kv_heads")),
        ((1, 4096, 896), ("batch", "seq_sp", None)), ((3, 5, 151936), ("batch", None, "vocab"))])]
    for extra in ({}, {"inner": None, "heads": ["data"], "kv_seq": ("pod", "data")}):
        rules = _rules(cfg, extra)
        jm, tm = jabstract_mesh(shape, names), tshd.abstract_mesh(shape, names)
        with jshd.use_rules(jm, rules), tshd.use_rules(tm, rules):
            for key, p in leaves:
                want = _spec(jshd.resolve_spec(p.shape, p.axes))
                assert _spec(tshd.resolve_spec(p.shape, p.axes)) == want, (key, extra)
                # explicit mesh and rules (not merged with the defaults), as there
                plain = {k: tuple(v) if isinstance(v, list) else v for k, v in (rules or {}).items()} or None
                assert (_spec(tshd.resolve_spec(p.shape, p.axes, tm, plain))
                        == _spec(jshd.resolve_spec(p.shape, p.axes, jm, plain))), (key, extra)
            assert tshd.fallback_log() == jshd.fallback_log()
        assert tshd.fallback_log() == jshd.fallback_log()  # kept after the scope, as there
    with pytest.raises(ValueError, match="needs a mesh"):
        tshd.resolve_spec((4,), ("batch",))


@pytest.mark.parametrize("divisor", [2, 4, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_zero1_axes_equal_the_references(arch, divisor):
    ja = jreg.get(arch)
    leaves = dict(_ref_leaves(ja.param_defs(ja.smoke_config)))
    nested_axes, nested_shapes, jshapes = {}, {}, {}
    for key, p in leaves.items():
        *path, last = key.split("/")
        a, s, j = nested_axes, nested_shapes, jshapes
        for part in path:
            a, s, j = a.setdefault(part, {}), s.setdefault(part, {}), j.setdefault(part, {})
        a[last], s[last] = p.axes, torch.empty(p.shape, device="meta")
        j[last] = jax.ShapeDtypeStruct(p.shape, jnp.float32)
    want = jshd.zero1_axes(nested_axes, jshapes, divisor)
    got = tshd.zero1_axes(nested_axes, nested_shapes, divisor)
    for key in leaves:
        w, g = want, got
        for part in key.split("/"):
            w, g = w[part], g[part]
        assert g == w, key
    assert divisor == 16 or any("zero1" in v for v in _walk(got))


def _walk(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _walk(v)
    else:
        yield tree


def test_zero1_and_rules_on_the_references_unit_cases():
    m = tshd.abstract_mesh((4, 2), ("data", "model"))
    with tshd.use_rules(m):
        assert tshd.resolve_spec((6, 7), ("batch", "heads")) == ()
        assert len(tshd.fallback_log()) == 2
        assert tshd.resolve_spec((8, 8, 4), ("batch", "kv_seq", "kv_heads")) == (("data",), None, "model")
    with tshd.use_rules(tshd.abstract_mesh((2, 4, 2), ("pod", "data", "model"))):
        assert tshd.resolve_spec((2, 16), ("batch", None)) == (("pod",),)
    shapes = {"w": torch.empty((95, 8192, 1376), device="meta")}
    assert tshd.zero1_axes({"w": (None, None, "d_ff")}, shapes, 32)["w"] == (None, "zero1", "d_ff")
    assert tshd.zero1_axes({"g": (None,)}, {"g": torch.empty((3,), device="meta")}, 32)["g"] == (None,)
    with pytest.raises(ValueError, match="disagree"):
        tshd.abstract_mesh((2,), ("data", "model"))
    x = torch.ones(6, 7)
    assert tcm.with_logical(x, ("batch", "heads")) is x  # no mesh: identity
    with tshd.use_rules(m):
        assert tcm.with_logical(x, ("batch", "heads")) is x and len(tshd.fallback_log()) == 2
        with tshd.no_constraints():
            tcm.with_logical(x, ("batch", "heads"))
        assert len(tshd.fallback_log()) == 2


# ---------------------------------------------------------------------------
# pad_for_mesh, opt_state_axes
# ---------------------------------------------------------------------------
PAD_FIELDS = ("num_heads", "num_kv_heads", "padded_heads", "padded_vocab", "vocab_size", "n_q_heads", "n_vocab")


@pytest.mark.parametrize("tp", [2, 4, 8, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_pad_for_mesh_field_for_field(arch, tp):
    ja, ta = jreg.get(arch), treg.get(arch)
    for jc, tc in ((ja.config, ta.config), (ja.smoke_config, ta.smoke_config)):
        try:
            want = jc.pad_for_mesh(tp)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                tc.pad_for_mesh(tp)
            continue
        got = tc.pad_for_mesh(tp)
        assert {f: getattr(got, f) for f in PAD_FIELDS} == {f: getattr(want, f) for f in PAD_FIELDS}
        assert (got is tc) == (want is jc)
        others = [f.name for f in dataclasses.fields(tc) if f.name not in PAD_FIELDS]
        assert all(getattr(got, f) == getattr(tc, f) for f in others)


def test_padded_smoke_config_loss_and_grads_match_the_reference():
    ja, ta = jreg.get("qwen2-0.5b"), treg.get("qwen2-0.5b")
    jc, tc = ja.smoke_config.pad_for_mesh(4), ta.smoke_config.pad_for_mesh(4)
    assert (tc.n_q_heads, tc.num_kv_heads) == (8, 4)
    jparams = jcm.init_tree(ja.param_defs(jc), jax.random.PRNGKey(0), jc.param_dtype)
    batch = jdata.SyntheticTokens(jdata.DataConfig(vocab_size=jc.vocab_size, seq_len=16, global_batch=4,
                                                   seed=1)).batch_at(0)
    want, jg = jax.jit(jax.value_and_grad(lambda p, b: ja.loss(p, b, jc)))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = params_from_jax(jax.tree.map(np.asarray, jparams), tc, "cpu")
    loss, grads = ttl._value_and_grad(lambda p, b: ta.loss(p, b, tc), tp, {k: torch.from_numpy(v)
                                                                           for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    jflat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
             for path, v in jax.tree_util.tree_leaves_with_path(jg)}
    got = tree_items(grads)
    assert len(got) == sum(v.shape[0] if k.startswith("layers/") else 1 for k, v in jflat.items())
    for key, g in got.items():
        ref_key, depth = _ref_key(key)
        w = jflat[ref_key]
        if depth:
            w = w[int(key.split("/")[1])]
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6, err_msg=key)


def test_opt_state_axes():
    axes = {"w": (None, "d_ff"), "layers": [{"b": ("heads",)}]}
    got, want = topt.opt_state_axes(axes), jopt.opt_state_axes(axes)
    assert isinstance(got, topt.OptState)
    assert (got.step, got.mu, got.nu) == (want.step, want.mu, want.nu) == ((), axes, axes)


# ---------------------------------------------------------------------------
# Compression
# ---------------------------------------------------------------------------
def _grad_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": (rng.normal(size=(37,)) * 3).astype(np.float32),
            "b": {"w": (rng.normal(size=(8, 5)) * 1e-3).astype(np.float32)},
            "e": np.zeros((0, 3), np.float32),
            "h": rng.normal(size=(16,)).astype(np.float32)}


def test_error_feedback_bitwise_the_reference():
    g = _grad_tree(0)
    r = jax.tree.map(lambda a: (a * 0.01).astype(np.float32), _grad_tree(1))
    jcomp_, jres = jcomp.with_error_feedback(jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, r))
    tg = {k: (torch.from_numpy(v) if not isinstance(v, dict) else {kk: torch.from_numpy(vv) for kk, vv in v.items()})
          for k, v in g.items()}
    tr = {k: (torch.from_numpy(v) if not isinstance(v, dict) else {kk: torch.from_numpy(vv) for kk, vv in v.items()})
          for k, v in r.items()}
    tcomp_, tres = tcomp.with_error_feedback(tg, tr)
    for want, got in ((jcomp_, tcomp_), (jres, tres)):
        wl = dict(zip(sorted(tree_items(got)), jax.tree.leaves(want)))
        for k, v in tree_items(got).items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(wl[k]), err_msg=k)
    bf = torch.tensor([0.5, -3.0, 1e-3], dtype=torch.bfloat16)
    c, res = tcomp.quantize_dequantize({"x": bf})
    jc_, jr_ = jcomp.quantize_dequantize({"x": jnp.asarray([0.5, -3.0, 1e-3], jnp.bfloat16)})
    assert c["x"].dtype == torch.bfloat16
    np.testing.assert_array_equal(c["x"].float().numpy(), np.asarray(jc_["x"], np.float32))
    np.testing.assert_array_equal(res["x"].float().numpy(), np.asarray(jr_["x"], np.float32))


def _q(g):
    """The reference's ``_quantize`` in numpy f32."""
    if g.size == 0:
        return g.astype(np.int8), np.float32(1.0)
    amax = np.float32(np.abs(g).max())
    scale = np.float32(np.maximum(amax, np.float32(1e-12)) * np.float32(1.0 / 127.0))
    return np.clip(np.round(g / scale), -127, 127).astype(np.int8), scale


def ring_emulation(inputs, fma: bool):
    """The reference's int8 ring over ``len(inputs)`` ranks, each rank's
    leaf values in f32: ``acc + q * s`` rounds twice, or once (``fma``: the
    f64 sum of the exact f64 product, rounded to f32)."""
    n = len(inputs)
    flat = inputs[0].size
    pad = (-flat) % n
    accs = [np.concatenate([x.reshape(-1).astype(np.float32), np.zeros(pad, np.float32)]).reshape(n, -1)
            for x in inputs]
    for s in range(n - 1):
        msgs = [_q(accs[d][(d - s) % n]) for d in range(n)]
        for d in range(n):
            q, sc = msgs[(d - 1) % n]
            r = (d - s - 1) % n
            if fma:
                accs[d][r] = (accs[d][r].astype(np.float64) + q.astype(np.float64) * np.float64(sc)).astype(np.float32)
            else:
                accs[d][r] = accs[d][r] + q.astype(np.float32) * sc
    for t in range(n - 1):
        msgs = [_q(accs[d][(d + 1 - t) % n]) for d in range(n)]
        for d in range(n):
            q, sc = msgs[(d - 1) % n]
            accs[d][(d - t) % n] = q.astype(np.float32) * sc
    return [a.reshape(-1)[:flat].reshape(inputs[0].shape) for a in accs]


_REFERENCE = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro import compat
from repro.compat import Mesh, PartitionSpec as P
from repro.optim.compress import compressed_psum, ring_int8_allreduce

src, dst = sys.argv[1], sys.argv[2]
data = dict(np.load(src))
out = {}
for n in (1, 2, 4):
    mesh = Mesh(np.array(jax.devices()[:n]), ("i",))
    for name, fn in (("psum", compressed_psum), ("ring", ring_int8_allreduce)):
        def body(tree):
            tree = jax.tree.map(lambda a: a[0], tree)
            return jax.tree.map(lambda a: a[None], fn(tree, "i"))
        keys = sorted({k.split("|")[1] for k in data})
        tree = {k: jnp.asarray(np.stack([data[f"{r}|{k}"] for r in range(n)]), jnp.bfloat16 if k == "bf" else None)
                for k in keys}
        res = jax.jit(compat.shard_map(body, mesh=mesh, in_specs=P("i"), out_specs=P("i"), check_vma=False))(tree)
        for k, v in res.items():
            for r in range(n):
                out[f"{n}|{name}|{r}|{k}"] = np.asarray(v[r], np.float32)
np.savez(dst, **out)
"""

LEAVES = ("a", "bw", "e", "h", "bf")


def _inputs(rank):
    g = _grad_tree(10 + rank)
    return {"a": g["a"], "bw": g["b"]["w"], "e": g["e"], "h": g["h"],
            "bf": (g["h"] * 2).astype(np.float32)}  # sent as bf16 on both sides


@pytest.fixture(scope="module")
def reference_collectives(tmp_path_factory):
    d = tmp_path_factory.mktemp("compress")
    arrays = {}
    for r in range(4):
        for k, v in _inputs(r).items():
            arrays[f"{r}|{k}"] = v
    np.savez(d / "in.npz", **arrays)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", _REFERENCE, str(d / "in.npz"), str(d / "out.npz")], env=env,
                   check=True, timeout=300, capture_output=True)
    return dict(np.load(d / "out.npz"))


@pytest.fixture(scope="module")
def quad(tmp_path_factory):
    import _torch_train_tp_ranks as ranks

    d = tmp_path_factory.mktemp("quad")
    return spawn(ranks.collectives_suite, 4, backend="gloo", args=(str(d), [_inputs(r) for r in range(4)]),
                 timeout=300)


def _f32(a):
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_compressed_psum_bitwise_the_reference(quad, reference_collectives, n):
    for r in range(n):
        for k in LEAVES:
            got = quad[r]["collectives"][f"{n}|psum|{k}"]
            np.testing.assert_array_equal(got, _f32(reference_collectives[f"{n}|psum|{r}|{k}"]), err_msg=f"{r} {k}")


@pytest.mark.parametrize("n", [1, 2, 4])
def test_ring_int8_allreduce_against_the_reference_and_its_fma(quad, reference_collectives, n):
    fused = {}
    for k in LEAVES:
        inputs = [_inputs(r)[k] for r in range(n)]
        if k == "bf":
            inputs = [_f32(jnp.asarray(x, jnp.bfloat16)) for x in inputs]
        if inputs[0].size == 0 or n == 1:
            plain = fma = inputs
        else:
            plain, fma = ring_emulation(inputs, False), ring_emulation(inputs, True)
        for r in range(n):
            got = quad[r]["collectives"][f"{n}|ring|{k}"]
            want = _f32(reference_collectives[f"{n}|ring|{r}|{k}"])
            cast = (lambda a: _f32(jnp.asarray(a, jnp.bfloat16))) if k == "bf" else (lambda a: a)
            np.testing.assert_array_equal(got, cast(plain[r]), err_msg=f"port {r} {k}")
            ok = np.array_equal(want, cast(fma[r])) or np.array_equal(want, cast(plain[r]))
            assert ok, f"reference {r} {k}: neither the one- nor the two-rounding ring"
            fused[(r, k)] = not np.array_equal(want, got)
    if n == 1:
        assert not any(fused.values())


def test_restore_with_shardings_gives_dtensors_of_the_saved_leaves(quad):
    for r in quad:
        res = r["restore"]
        assert res["types"] == ["DTensor"] * len(res["types"])
        for key, (full, saved, local, want_local, placements) in res["leaves"].items():
            np.testing.assert_array_equal(full, saved, err_msg=key)
            np.testing.assert_array_equal(local, want_local, err_msg=key)
        assert res["placements"] == quad[0]["restore"]["placements"]
    assert quad[0]["restore"]["placements"]["params/embed"] == ["Shard(0)", "Replicate"]
    assert quad[0]["restore"]["placements"]["params/w"] == ["Replicate", "Shard(1)"]
    assert quad[0]["restore"]["placements"]["params/s"] == ["Replicate", "Replicate"]  # 5 rows: fallback


def test_make_global_batch_gives_this_ranks_rows_of_the_one_stream(quad):
    for r in quad:
        rows = r["batch_rows"]
        i = r["coords"][0]
        np.testing.assert_array_equal(rows["tokens"], rows["global"][i * 2:(i + 1) * 2])


def test_json_rules_override_normalizes_lists():
    m = tshd.abstract_mesh((2, 4, 2), ("pod", "data", "model"))
    with tshd.use_rules(m, json.loads('{"heads": ["pod", "data"]}')):
        assert tshd.resolve_spec((16, 8), (None, "heads")) == (None, ("pod", "data"))
