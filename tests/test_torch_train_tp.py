"""The port's tensor- and data-parallel training against the JAX reference
and against the port's own unsharded training.

The port trains SPMD over ``torch.distributed`` (every rank runs the
model); the reference is single-controller (``shard_map`` / GSPMD).  The
port's ranks run in spawned ``gloo`` groups of one, two and four ranks on
the CPU (``tests/_torch_train_tp_ranks.py``, one group per size), on
qwen2-0.5b's smoke config on the ideal channel (the kernel backend, its
twin here).  Held here:

* ``make_dp_train_step`` on one rank (a (1, 1) mesh) against the
  reference's on a 1 x 1 mesh from the same (reference) parameters: loss
  and grad norm within ``rtol=1e-5``, parameters within the reference's own
  ``atol=2e-2`` (``tests/test_runtime.py::TestDPShardMap``);
* the port's DP step on (2, 1) and (2, 2) meshes (TP over "model") against
  the port's unsharded ``build_train_step`` on the whole batch: digital,
  loss and grad norm ``rtol=1e-5`` (the reference's bar,
  ``tests/test_sharded_engine.py``); on the ideal channel, where each data
  rank quantizes its own rows as the reference's ``shard_map`` body does,
  the same bar against the mean over the two data blocks of the unsharded
  loss and gradient; parameters within ``atol=2e-2`` of the whole batch's
  step and bitwise equal across ranks; with ``compress_grads`` finite, the
  loss equal to the plain step's, parameters within ``atol=2e-2`` of it;
* an unknown ``tp_axis`` refused by ``make_dp_train_step`` and ``train``;
* ``train(mesh=(1, 2), tp_axis="model")`` bitwise the unsharded
  ``train()`` (losses and parameters), one all-reduce per routed GEMM
  (the remat recompute included, and it re-enters the forward's TP scope
  when the backward runs outside it, as autograd's device thread does on
  the card), only rank 0 writing; killed at step 6
  and resumed, bitwise the uninterrupted run, rank 0 the only writer;
* on the (2, 2) mesh: ``dense`` with rows split over "data" bitwise the
  unsharded port on the ideal channel (one all-reduce and one row gather a
  GEMM; rows the axis does not divide replicate, no gather), and under
  SMWA each data block's sum the reference's ``shard_local_engine(...)
  .int_gemm(shard=i)`` summed over the shards on that block's rows (the
  reference's row-local draws), within ``tests/test_torch_sharded.py``'s
  noisy tier (at most 0.1% of outputs off, each by at most two top-pass
  LSBs per shard); ``train(mesh=(2, 2), tp_axis="model",
  place_rows=False)``, the replicated program, bitwise the unsharded
  ``train()`` with one row gather per all-reduce (the placed rows are
  held in ``tests/test_torch_placement.py``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import _torch_train_tp_ranks as ranks  # noqa: E402
from repro.compat import Mesh  # noqa: E402
from repro.core.dpu import DPUConfig as JDPU  # noqa: E402
from repro.core.dpu import quantize_symmetric as jquant  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.noise.channel import build_channel_model as jbuild  # noqa: E402
from repro.optim import adamw as jopt  # noqa: E402
from repro.photonic import engine_for as jengine_for  # noqa: E402
from repro.photonic import shard_local_engine as jshard_engine  # noqa: E402
from repro.runtime.dp_step import make_dp_train_step as jdp_step  # noqa: E402
from repro_torch._tree import tree_items  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.models.common import init_params  # noqa: E402
from repro_torch.optim import adamw as topt  # noqa: E402
from repro_torch.runtime import sharding as tshd  # noqa: E402
from repro_torch.runtime import train_loop as ttl  # noqa: E402
from repro_torch.runtime.dp_step import make_dp_train_step  # noqa: E402

LAYERS = 2  # the smoke config's
DATA = dict(vocab_size=256, **ranks.DATA)


@pytest.fixture(scope="module")
def one():
    """The reference's DP step on a 1 x 1 mesh, and the port's on one rank
    from the same parameters and batch."""
    ja = jreg.get("qwen2-0.5b")
    jc = dataclasses.replace(ja.smoke_config, remat=False)
    params = jcm.init_tree(ja.param_defs(jc), jax.random.PRNGKey(0), jc.param_dtype)
    batch = jdata.SyntheticTokens(jdata.DataConfig(**DATA)).batch_at(0)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    step = jdp_step(lambda p, b: ja.loss(p, b, jc), jopt.AdamWConfig(), mesh)
    p, _, loss, gnorm = jax.jit(step)(params, jopt.init(params), {k: jnp.asarray(v) for k, v in batch.items()})
    want = (float(loss), float(gnorm), p)
    got, = spawn(ranks.one_rank_suite, 1, backend="gloo", args=(jax.tree.map(np.asarray, params), batch), timeout=300)
    return want, got


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return spawn(ranks.pair_suite, 2, backend="gloo", args=(str(tmp_path_factory.mktemp("pair")),), timeout=300)


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    return spawn(ranks.grid_suite, 4, backend="gloo", args=(str(tmp_path_factory.mktemp("grid")),), timeout=300)


@pytest.fixture(scope="module", params=[True, False], ids=["ideal", "digital"])
def unsharded_step(request):
    """The port's unsharded step on the whole batch of step 0, and the
    mean loss and the norm of the mean gradient over the batch's two halves
    (the rows a data rank sees)."""
    photonic = request.param
    arch, cfg = ranks.smoke() if photonic else ranks.smoke(photonic=None)
    params = init_params(cfg, 0, "cpu")
    batch = ranks._global_batch(cfg)
    step = ttl.build_train_step(lambda p, b: arch.loss(p, b, cfg), topt.AdamWConfig(**ranks.OPT))
    p, _, m = step(params, topt.init(params), batch)
    halves = [ttl._value_and_grad(lambda p_, b: arch.loss(p_, b, cfg), params, {k: v[i * 2:(i + 1) * 2]
                                                                                  for k, v in batch.items()})
              for i in range(2)]
    mean_grads = [(a + b) / 2 for a, b in zip(tree_items(halves[0][1]).values(), tree_items(halves[1][1]).values())]
    blocks = dict(loss=float((halves[0][0] + halves[1][0]) / 2),
                  grad_norm=float(torch.sqrt(sum((g.to(torch.float32) ** 2).sum() for g in mean_grads))))
    whole = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                 params={k: v.numpy() for k, v in tree_items(p).items()})
    return ("dp" if photonic else "dp_digital"), whole, blocks


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---------------------------------------------------------------------------
# The DP step
# ---------------------------------------------------------------------------
def test_dp_step_on_one_rank_matches_the_references_on_a_1x1_mesh(one):
    (jloss, jnorm, jp), (loss, norm, p) = one
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    np.testing.assert_allclose(norm, jnorm, rtol=1e-5)
    jflat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v, np.float32)
             for path, v in jax.tree_util.tree_leaves_with_path(jp)}
    for key, g in p.items():
        parts = key.split("/")
        if parts[0] == "layers":
            w = jflat["/".join(parts[:1] + parts[2:])][int(parts[1])]
        else:
            w = jflat[key]
        np.testing.assert_allclose(g, w, atol=2e-2, err_msg=key)


@pytest.mark.parametrize("mesh", ["2x1", "2x2"])
def test_dp_step_matches_the_unsharded_step(pair, grid, unsharded_step, mesh):
    """Digital, the DP loss and grad norm are the whole batch's.  On the
    photonic channel a data rank quantizes its own rows at their abs-max,
    as the reference's ``shard_map`` body does, so the bar is the mean over
    the batch's halves of the unsharded loss and gradient; the update stays
    within the reference's ``atol`` of the whole batch's."""
    key, whole, blocks = unsharded_step
    res = [r[key] for r in (pair if mesh == "2x1" else grid)]
    want = whole if key == "dp_digital" else blocks
    for r_loss, r_norm, r_params in res:
        np.testing.assert_allclose(r_loss, want["loss"], rtol=1e-5)
        np.testing.assert_allclose(r_norm, want["grad_norm"], rtol=1e-5)
        for k, v in whole["params"].items():
            np.testing.assert_allclose(r_params[k], v, atol=2e-2, err_msg=k)
        _same(r_params, res[0][2])  # every rank holds the same update
    assert len({r[0] for r in res}) == 1


def test_int8_compressed_dp_step_is_finite_and_close_to_the_plain_step(grid):
    for r in grid:
        loss, norm, params = r["dp_int8"]
        assert loss == r["dp"][0]  # the loss is reduced before any compression
        assert np.isfinite(norm) and all(np.isfinite(v).all() for v in params.values())
        for k, v in params.items():
            np.testing.assert_allclose(v, r["dp"][2][k], atol=2e-2, err_msg=k)


def test_unknown_tp_axis_is_refused(tmp_path):
    mesh = tshd.abstract_mesh((1, 2), ("data", "model"))
    with pytest.raises(ValueError, match="tp_axis 'nope' not in mesh axes"):
        make_dp_train_step(lambda p, b: 0.0, topt.AdamWConfig(total_steps=1), mesh, tp_axis="nope")
    arch, cfg = ranks.smoke()
    with pytest.raises(ValueError, match=r"tp_axis 'nope' not in mesh axes \('data', 'model'\)"):
        ranks._train(arch, cfg, tmp_path, mesh=mesh, tp_axis="nope")


# ---------------------------------------------------------------------------
# train() on a mesh
# ---------------------------------------------------------------------------
def test_train_on_a_tp_mesh_is_bitwise_the_unsharded_train(pair):
    for rank, r in enumerate(pair):
        assert r["tp"]["losses"] == r["unsharded"]["losses"]
        _same(r["tp"]["params"], r["unsharded"]["params"])
        assert r["tp"]["final_step"] == 3 and r["unsharded"]["all_reduces"] == 0
        assert (r["tp"]["all_reduces"], r["tp"]["row_gathers"]) == (6 * LAYERS * 2 * 3, 0)
        assert r["tp"]["saves"] == (1 if rank == 0 else 0)
    _same(pair[1]["tp"]["params"], pair[0]["tp"]["params"])


def test_the_remat_recompute_reenters_the_forwards_tp_scope(pair):
    for r in pair:
        forward, total, same = r["remat_outside_scope"]
        assert (forward, total, same) == (6 * LAYERS, 2 * 6 * LAYERS, True)


def test_a_killed_and_resumed_tp_run_is_bitwise_the_uninterrupted_run(pair):
    for rank, r in enumerate(pair):
        assert r["failed"] == "simulated node failure at step 6"
        assert r["latest_after_failure"] == 6
        res = r["resume"]
        assert res["final_step"] == 10 and res["losses"] == res["ref_losses"][6:]
        _same(res["params"], res["ref_params"])
        assert res["saves"] == ((4, 2) if rank == 0 else (0, 0))  # steps 3, 6, 9, 10; then 9, 10


def test_train_on_a_dp_tp_grid_is_bitwise_the_unsharded_train(grid):
    assert sorted(r["coords"] for r in grid) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for rank, r in enumerate(grid):
        t = r["train"]
        assert t["losses"] == t["base_losses"]
        _same(t["params"], t["base_params"])
        assert t["all_reduces"] == t["row_gathers"] == 6 * LAYERS * 2 * 2
        assert t["saves"] == (1 if rank == 0 else 0)


# ---------------------------------------------------------------------------
# Row-sharded TP GEMMs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["float", "packed"])
@pytest.mark.parametrize("rows", ["split", "odd"])
def test_row_sharded_gemms_are_bitwise_unsharded_on_the_ideal_channel(grid, kind, rows):
    for r in grid:
        base, tp, n_ar, n_rg = r["gemms"][f"ideal/{kind}/{rows}"]
        np.testing.assert_array_equal(tp, base)
        assert (n_ar, n_rg) == ((1, 1) if rows == "split" else (1, 0))


def test_row_sharded_noise_follows_the_references_row_local_draws(grid):
    g = grid[0]["gemms"]
    x, w, b = g["x"].reshape(-1, 64), g["w"], g["b"]
    jd = JDPU(organization="SMWA", bits=4, dpe_size=16, channel=jbuild("SMWA", n=16), noise_seed=3)
    xq, sx = jquant(jnp.asarray(x), jd.operand_bits)
    wq, sw = jquant(jnp.asarray(w), jd.operand_bits, axis=0)
    xq, wq, sx, sw = np.asarray(xq), np.asarray(wq), np.float32(sx), np.asarray(sw, np.float32)
    local = jshard_engine(jengine_for(jd, "ref"), 32)
    ref = jax.jit(lambda a, c, s: local.int_gemm(a, c, site=ranks.SITE, fold=jnp.int32(1), shard=s))
    blocks = []
    for d in range(2):  # the data axis: rows 0-5, 6-11
        rows = xq[d * 6:(d + 1) * 6]
        blocks.append(sum(np.asarray(ref(jnp.asarray(rows[:, i * 32:(i + 1) * 32]), jnp.asarray(wq[i * 32:(i + 1) * 32]),
                                         jnp.int32(i)), np.int64) for i in range(2)))
    want = np.concatenate(blocks)
    want_y = want.astype(np.float32) * sx * sw + b
    for r in grid:
        base, tp, n_ar, n_rg = r["gemms"]["SMWA/float/split"]
        assert (n_ar, n_rg) == (1, 1)
        np.testing.assert_array_equal(tp, grid[0]["gemms"]["SMWA/float/split"][1])  # ranks agree
        acc = np.rint((tp.reshape(-1, 24) - want_y) / (sx * sw)).astype(np.int64)
        assert (acc != 0).mean() <= 1e-3 and np.abs(acc).max() <= 2 * 2 * 2 ** 8, np.abs(acc).max()
        assert not np.array_equal(tp, base)  # not the unsharded draw
