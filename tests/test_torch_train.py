"""The port's training slice against the JAX reference: the optimizer,
the loss, the data stream, ``lm_loss`` and its gradients, and the trainer
with its checkpoints.

Tolerances, fixed before the first run:

* ``adamw.update``: within ``rtol=2e-6`` of the reference (f32 ops in the
  reference's order), plus an absolute ``2e-6`` of the leaf's max abs:
  XLA and torch sum the squares of ``global_norm`` in other orders, and the
  ulp that moves the clipped step leaves a parameter near zero (``p - lr x
  delta`` cancels) 2.5e-6 apart in relative terms (1.9e-9 absolute);
* ``softmax_cross_entropy``: ``rtol=1e-6``; ``SyntheticTokens``: bitwise;
* ``lm_loss`` on the smoke config (f32, the port's ``kernel`` backend,
  its twin on the CPU): the loss within ``1e-5`` relative; with
  ``photonic=None`` every gradient leaf within ``rtol=1e-5, atol=1e-6``;
  with the ideal channel every leaf within ``1e-3`` of its max abs (rare
  one-LSB quantization flips, parity tier "Float tolerance"); the same
  under the SMWA channel with ``noise_seed`` on both packages' ``ref``
  backend; ``remat`` on and off bitwise equal;
* ``train()``: losses within ``rtol=1e-4`` of the reference's
  ``train()`` (which runs its ``exact`` backend: under the ideal channel
  every backend is bitwise the same); a run killed at step 6 and resumed
  equals the uninterrupted run bitwise.

The reference's parameters are carried over (``repro_torch.weights``):
the port cannot reproduce ``jax.random``.  A carried state enters the
port's ``train()`` as a checkpoint of its step, which ``train()`` resumes.
"""

import dataclasses
import os
import signal
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.core.dpu import DPUConfig as JDPU  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.noise.channel import build_channel_model as jbuild  # noqa: E402
from repro.optim import adamw as jopt  # noqa: E402
from repro.runtime import train_loop as jtl  # noqa: E402
from repro_torch._tree import tree_items  # noqa: E402
from repro_torch.checkpoint import ckpt as tckpt  # noqa: E402
from repro_torch.core.dpu import DPUConfig as TDPU  # noqa: E402
from repro_torch.data import pipeline as tdata  # noqa: E402
from repro_torch.models import common as tcm  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.noise.channel import build_channel_model as tbuild  # noqa: E402
from repro_torch.optim import adamw as topt  # noqa: E402
from repro_torch.runtime import train_loop as ttl  # noqa: E402
from repro_torch.weights import params_from_jax, train_state_from_jax  # noqa: E402

JA = jreg.get("qwen2-0.5b")
TA = treg.get("qwen2-0.5b")
DATA = dict(vocab_size=JA.smoke_config.vocab_size, seq_len=16, global_batch=4, seed=1)
OPT = dict(lr=3e-3, warmup_steps=1, total_steps=3)


def _quiet(msg):
    pass


def _cfgs(photonic: bool, **kw):
    jc = dataclasses.replace(JA.smoke_config, **kw)
    tc = dataclasses.replace(TA.smoke_config, **kw)
    if photonic:
        jc = dataclasses.replace(jc, photonic=JDPU(organization="SMWA", bits=4, datarate_gs=5.0),
                                 photonic_backend="exact")
        tc = dataclasses.replace(tc, photonic=TDPU(organization="SMWA", bits=4, datarate_gs=5.0),
                                 photonic_backend="kernel")
    return jc, tc


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jparams():
    jc, _ = _cfgs(False)
    return jcm.init_tree(JA.param_defs(jc), jax.random.PRNGKey(0), jc.param_dtype)


def _stacked(port_tree):
    """The port's per-layer tree in the reference's stacked layout (numpy)."""
    out = {}
    for k, v in port_tree.items():
        if k == "layers":
            out[k] = jax.tree.map(lambda *xs: np.stack(xs), *[_stacked_leaves(p) for p in v])
        else:
            out[k] = _stacked_leaves(v)
    return out


def _stacked_leaves(node):
    if isinstance(node, dict):
        return {k: _stacked_leaves(v) for k, v in node.items()}
    return node.detach().numpy()


# ---------------------------------------------------------------------------
# Optimizer, loss, data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("clip", [1.0, None])
@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_adamw_update_matches_reference(schedule, clip):
    rng = np.random.default_rng(0)
    shapes = {"a": (7, 5), "b": {"c": (11,), "d": (3, 4, 2)}}

    def tree(scale):
        return jax.tree.map(lambda s: (rng.normal(size=s) * scale).astype(np.float32), shapes,
                            is_leaf=lambda s: isinstance(s, tuple))

    params = tree(1.0)
    grads = [tree(3.0) for _ in range(3)]
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=5, schedule=schedule, clip_norm=clip)
    jp, js = jax.tree.map(jnp.asarray, params), jopt.init(jax.tree.map(jnp.asarray, params))
    tp = jax.tree.map(torch.from_numpy, params)
    ts = topt.init(tp)
    for g in grads:
        jp, js, jm = jopt.update(jopt.AdamWConfig(**cfg), jp, jax.tree.map(jnp.asarray, g), js)
        tp, ts, tm = topt.update(topt.AdamWConfig(**cfg), tp, jax.tree.map(torch.from_numpy, g), ts)
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-6)
    assert int(ts.step) == int(js.step) == 3 and ts.step.dtype == torch.int32
    for want, got in ((jp, tp), (js.mu, ts.mu), (js.nu, ts.nu)):
        for (k, g), w in zip(tree_items(got).items(), jax.tree.leaves(want)):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=2e-6, atol=2e-6 * np.abs(w).max(), err_msg=k)


def test_adamw_moments_are_f32_for_bf16_params():
    p = {"w": torch.ones(4, 3, dtype=torch.bfloat16)}
    s = topt.init(p)
    assert s.mu["w"].dtype == torch.float32 and s.nu["w"].dtype == torch.float32
    p2, s2, _ = topt.update(topt.AdamWConfig(), p, {"w": torch.full((4, 3), 0.5, dtype=torch.bfloat16)}, s)
    assert p2["w"].dtype == torch.bfloat16 and s2.mu["w"].dtype == torch.float32


def test_softmax_cross_entropy_with_padded_vocab_matches_reference():
    rng = np.random.default_rng(1)
    logits = (rng.normal(size=(2, 5, 40)) * 4).astype(np.float32)
    labels = rng.integers(0, 33, (2, 5)).astype(np.int32)
    want, jg = jax.value_and_grad(lambda z: jcm.softmax_cross_entropy(z, jnp.asarray(labels), 33))(
        jnp.asarray(logits))
    z = torch.from_numpy(logits).requires_grad_(True)
    got = tcm.softmax_cross_entropy(z, torch.from_numpy(labels), 33)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-9)
    assert (z.grad[..., 33:] == 0).all()


@pytest.mark.parametrize("shards", [1, 2])
def test_synthetic_tokens_bitwise_equal_reference(shards):
    cfg = dict(DATA, global_batch=4)
    for shard in range(shards):
        js = jdata.SyntheticTokens(jdata.DataConfig(**cfg), shard, shards)
        ts = tdata.SyntheticTokens(tdata.DataConfig(**cfg), shard, shards)
        for step in (0, 3, 11):
            want, got = js.batch_at(step), ts.batch_at(step)
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(got[k], want[k])
    batch = tdata.make_global_batch(ts, 3, "cpu")
    assert batch["tokens"].dtype == torch.int32 and batch["tokens"].device.type == "cpu"
    np.testing.assert_array_equal(batch["labels"].numpy(), js.batch_at(3)["labels"])


# ---------------------------------------------------------------------------
# lm_loss and its gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("photonic", [False, True], ids=["float", "ideal-photonic"])
def test_lm_loss_and_grads_match_reference(jparams, photonic):
    jc, tc = _cfgs(photonic)
    batch = jdata.SyntheticTokens(jdata.DataConfig(**DATA)).batch_at(0)
    want, jg = jax.value_and_grad(jlm.lm_loss)(jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jc)
    tp = params_from_jax(_np_tree(jparams), tc, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, grads = ttl._value_and_grad(lambda p, b: TA.loss(p, b, tc), tp, tb)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    got = _stacked(grads)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(_np_tree(jg))):
        if photonic:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-3 * np.abs(w).max(), err_msg=str(path))
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=str(path))
    # remat recomputes each block with the same layer index: bitwise the same.
    loss2, grads2 = ttl._value_and_grad(lambda p, b: TA.loss(p, b, dataclasses.replace(tc, remat=False)), tp, tb)
    assert torch.equal(loss, loss2)
    for (k, a), b in zip(tree_items(grads).items(), tree_items(grads2).values()):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("photonic", [False, True], ids=["float", "ideal-photonic"])
def test_dots_remat_policy_equals_full_bitwise(jparams, photonic):
    """``remat_policy="dots"`` (a selective checkpoint that saves the
    outputs of products without batch dimensions) gives the loss and the
    gradients of ``"full"`` bit for bit; its loss is the reference's
    ``"dots"`` loss within ``1e-5`` relative, as for ``"full"``."""
    jc, tc = _cfgs(photonic)
    batch = jdata.SyntheticTokens(jdata.DataConfig(**DATA)).batch_at(1)
    tp = params_from_jax(_np_tree(jparams), tc, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    runs = {}
    for policy in ("full", "dots"):
        cfg = dataclasses.replace(tc, remat_policy=policy)
        runs[policy] = ttl._value_and_grad(lambda p, b: TA.loss(p, b, cfg), tp, tb)
    assert torch.equal(runs["full"][0], runs["dots"][0])
    for (k, a), b in zip(tree_items(runs["full"][1]).items(), tree_items(runs["dots"][1]).values()):
        assert torch.equal(a, b), k
    want = jlm.lm_loss(jparams, {k: jnp.asarray(v) for k, v in batch.items()},
                       dataclasses.replace(jc, remat_policy="dots"))
    np.testing.assert_allclose(float(runs["dots"][0]), float(want), rtol=1e-5)


def test_lm_loss_and_grads_match_reference_under_smwa(jparams):
    """The analog channel in training: SMWA (filter truncation and detector
    noise, ``noise_seed=0``) at its calibrated N on the ``ref`` backend of
    both packages (the same untiled stream; the reference's interpret-mode
    kernel under ``value_and_grad`` takes minutes here), the loss within
    ``1e-5`` relative and each gradient leaf within ``1e-3`` of its max abs,
    as for the ideal channel.  The gradients go straight through the noisy
    forward, so they differ from the ideal channel's only through the
    activations the noise moved."""
    n = JDPU(organization="SMWA", bits=4, datarate_gs=5.0).n
    jd = JDPU(organization="SMWA", bits=4, datarate_gs=5.0, noise_seed=0,
              channel=jbuild("SMWA", n=n, bits=4, datarate_gs=5.0))
    td = TDPU(organization="SMWA", bits=4, datarate_gs=5.0, noise_seed=0,
              channel=tbuild("SMWA", n=n, bits=4, datarate_gs=5.0))
    jc = dataclasses.replace(JA.smoke_config, photonic=jd, photonic_backend="ref")
    tc = dataclasses.replace(TA.smoke_config, photonic=td, photonic_backend="ref")
    batch = jdata.SyntheticTokens(jdata.DataConfig(**DATA)).batch_at(0)
    want, jg = jax.value_and_grad(jlm.lm_loss)(jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jc)
    tp = params_from_jax(_np_tree(jparams), tc, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, grads = ttl._value_and_grad(lambda p, b: TA.loss(p, b, tc), tp, tb)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    ideal, _ = ttl._value_and_grad(lambda p, b: TA.loss(p, b, _cfgs(True)[1]), tp, tb)
    assert float(loss) != float(ideal)  # the channel is live
    got = _stacked(grads)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(_np_tree(jg))):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-3 * np.abs(w).max(), err_msg=str(path))


def test_lm_logits_is_differentiable_through_the_photonic_engine(jparams):
    """Every routed weight gets a nonzero gradient through the kernel
    backend (the twin's rounding alone would give zeros)."""
    _, tc = _cfgs(True)
    tp = params_from_jax(_np_tree(jparams), tc, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in tdata.SyntheticTokens(tdata.DataConfig(**DATA)).batch_at(2).items()}
    _, grads = ttl._value_and_grad(lambda p, b: tlm.lm_loss(p, b, tc), tp, batch)
    routed = {k: v for k, v in tree_items(grads).items() if k.endswith("/w")}
    assert len(routed) == 6 * tc.num_layers
    assert all(float(v.abs().max()) > 0 for v in routed.values())


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference's ``train()``: 3 steps, ideal channel, a checkpoint
    after every step."""
    d = tmp_path_factory.mktemp("jax_ckpt")
    jc, _ = _cfgs(True)
    out = jtl.train(
        arch=JA, model_cfg=jc, data_cfg=jdata.DataConfig(**DATA),
        train_cfg=jtl.TrainConfig(steps=3, ckpt_every=1, ckpt_dir=str(d), log_every=100,
                                  async_checkpoint=False),
        opt_cfg=jopt.AdamWConfig(**OPT), log=_quiet,
    )
    return d, out


def _port_train(d, tc, steps=3, **kw):
    return ttl.train(
        arch=TA, model_cfg=tc, data_cfg=tdata.DataConfig(**DATA),
        train_cfg=ttl.TrainConfig(steps=steps, ckpt_every=kw.pop("ckpt_every", 1000), ckpt_dir=str(d),
                                  log_every=100, async_checkpoint=kw.pop("async_checkpoint", True)),
        opt_cfg=topt.AdamWConfig(**OPT), log=kw.pop("log", _quiet), device="cpu", **kw,
    )


@pytest.mark.parametrize("start", ["from_key", "from_checkpoint"])
def test_train_matches_reference_losses(reference_run, jparams, tmp_path, start):
    """From nothing, the port's ``train()`` draws the reference's weights
    from ``PRNGKey(seed)`` itself; from a step-0 checkpoint of the
    reference's ``init_tree`` it restores the same weights."""
    _, ref = reference_run
    _, tc = _cfgs(True)
    if start == "from_checkpoint":
        tp = params_from_jax(_np_tree(jparams), tc, "cpu")
        tckpt.save(tmp_path, 0, {"params": tp, "opt": topt.init(tp)})
    out = _port_train(tmp_path, tc)
    assert out["final_step"] == 3 and len(out["step_seconds"]) == 3
    np.testing.assert_allclose(out["losses"], ref["losses"], rtol=1e-4)
    assert tckpt.latest_step(tmp_path) == 3


def test_train_state_from_jax_continues_a_reference_run(reference_run, tmp_path):
    d, ref = reference_run
    jc, tc = _cfgs(True)
    like = jcm.init_tree(JA.param_defs(jc), jax.random.PRNGKey(0), jc.param_dtype)
    state = jckpt.restore(d, 2, {"params": like, "opt": jopt.init(like)})
    ts = train_state_from_jax(_np_tree(state["params"]), _np_tree(state["opt"]), tc, "cpu")
    assert ts.step == 2 and int(ts.opt_state.step) == 2
    assert all(v.dtype == torch.float32 for v in tree_items(ts.opt_state.mu).values())
    tckpt.save(tmp_path, ts.step, {"params": ts.params, "opt": ts.opt_state})
    out = _port_train(tmp_path, tc)
    assert out["final_step"] == 3 and len(out["losses"]) == 1
    np.testing.assert_allclose(out["losses"][0], ref["losses"][2], rtol=1e-4)


def test_crash_and_resume_equals_uninterrupted_bitwise(tmp_path):
    """Mirrors ``tests/test_runtime.py::TestFaultTolerance``: killed at step
    6 and resumed, the run gives the uninterrupted run's losses bitwise."""
    _, tc = _cfgs(True)

    def run(d, **kw):
        return _port_train(d, tc, steps=10, ckpt_every=3, async_checkpoint=False, **kw)

    ref = run(tmp_path / "ref")
    with pytest.raises(RuntimeError, match="simulated node failure"):
        run(tmp_path / "ft", fail_at_step=6)
    assert tckpt.latest_step(tmp_path / "ft") == 6
    resumed = run(tmp_path / "ft")
    assert resumed["final_step"] == 10
    assert resumed["losses"] == ref["losses"][6:]
    for (k, a), b in zip(tree_items(resumed["params"]).items(), tree_items(ref["params"]).values()):
        assert torch.equal(a, b), k


def test_sigterm_checkpoints_and_stops(tmp_path):
    if threading.current_thread() is not threading.main_thread():
        pytest.skip("train() installs its signal handlers only on the main thread")
    _, tc = _cfgs(False)

    def log(msg):
        if msg.startswith("[train] step 0 "):
            os.kill(os.getpid(), signal.SIGTERM)

    before = signal.getsignal(signal.SIGTERM)
    out = _port_train(tmp_path, tc, steps=10, log=log)
    assert out["preempted"] and out["final_step"] == 1
    assert tckpt.latest_step(tmp_path) == 1
    assert signal.getsignal(signal.SIGTERM) is before


def test_microbatched_step_matches_reference(jparams):
    jc, tc = _cfgs(False)
    batch = jdata.SyntheticTokens(jdata.DataConfig(**DATA)).batch_at(4)
    jstep = jtl.build_train_step(lambda p, b: JA.loss(p, b, jc), jopt.AdamWConfig(**OPT), microbatches=2)
    _, js, jm = jstep(jparams, jopt.init(jparams), {k: jnp.asarray(v) for k, v in batch.items()})
    tp = params_from_jax(_np_tree(jparams), tc, "cpu")
    tstep = ttl.build_train_step(lambda p, b: TA.loss(p, b, tc), topt.AdamWConfig(**OPT), microbatches=2)
    _, ts, tm = tstep(tp, topt.init(tp), {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    # After one step mu is 0.1 x the clipped mean gradient: the gradient
    # tolerance of lm_loss, scaled by 0.1.  (The updated parameters are not
    # compared: Adam divides by |g|, which blows an ulp of a near-zero
    # gradient up to a step of lr.)
    got = _stacked(ts.mu)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(_np_tree(js.mu))):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7, err_msg=str(path))


def test_train_refuses_a_mesh(tmp_path):
    """A mesh without the TP axis asked for is refused before any step,
    naming the axis (training on a mesh is held in
    ``tests/test_torch_train_tp.py``)."""
    from repro_torch.runtime.sharding import abstract_mesh

    _, tc = _cfgs(False)
    with pytest.raises(ValueError, match=r"tp_axis 'tensor' not in mesh axes \('data', 'model'\)"):
        _port_train(tmp_path, tc, mesh=abstract_mesh((1, 2), ("data", "model")), tp_axis="tensor")
    assert ttl.ckpt.latest_step(tmp_path) is None


# ---------------------------------------------------------------------------
# Checkpoints and the watchdog
# ---------------------------------------------------------------------------
def test_checkpoint_roundtrip_keeps_dtypes_and_bits(tmp_path):
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(5, 3, generator=gen).to(torch.bfloat16), "layers": [
        {"b": torch.randn(3, generator=gen)}, {"b": torch.randn(3, generator=gen)}]}
    tree = {"params": params, "opt": topt.init(params)}
    tckpt.save(tmp_path, 7, tree)
    assert tckpt.latest_step(tmp_path) == 7
    d = tmp_path / "step_00000007"
    assert sorted(p.name for p in d.iterdir()) == ["leaves.npz", "manifest.json"]
    like = {"params": {"w": torch.zeros(5, 3, dtype=torch.bfloat16),
                       "layers": [{"b": torch.zeros(3)}, {"b": torch.zeros(3)}]},
            "opt": topt.init(params)}
    back = tckpt.restore(tmp_path, 7, like)
    assert isinstance(back["opt"], topt.OptState)
    for (k, a), b in zip(tree_items(tree).items(), tree_items(back).values()):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore(tmp_path, 7, {**like, "params": {**like["params"], "w": torch.zeros(3, 5)}})


def test_restore_reads_a_reference_checkpoint_bitwise(jparams, tmp_path):
    """A checkpoint written by the reference's ``ckpt.save`` (bf16 params
    with the layer axis stacked, AdamW's ``OptState`` printed as ``.mu`` /
    ``.nu`` / ``.step``, bf16 leaves stored as void ``V2``) restores into
    the port's per-layer tree bit for bit."""
    jc, tc = _cfgs(False, param_dtype=jnp.bfloat16)
    tc = dataclasses.replace(tc, param_dtype=torch.bfloat16)
    params = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
    rng = np.random.default_rng(3)
    mu = jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32)), params)
    nu = jax.tree.map(lambda a: jnp.asarray(rng.random(size=a.shape).astype(np.float32)), params)
    opt = jopt.OptState(jnp.asarray(5, jnp.int32), mu, nu)
    jckpt.save(tmp_path, 5, {"params": params, "opt": opt})
    assert "opt/.step" in (tmp_path / "step_00000005" / "manifest.json").read_text()
    want = train_state_from_jax(_np_tree(params), _np_tree(opt), tc, "cpu")
    like = jax.tree.map(np.zeros_like, _np_tree(params))
    start = train_state_from_jax(like, _np_tree(jopt.init(like)), tc, "cpu")
    back = tckpt.restore(tmp_path, 5, {"params": start.params, "opt": start.opt_state})
    assert isinstance(back["opt"], topt.OptState) and int(back["opt"].step) == 5
    got = {"params": back["params"], "opt": back["opt"]}
    ref = {"params": want.params, "opt": want.opt_state}
    assert tree_items(got).keys() == tree_items(ref).keys()
    for (k, a), b in zip(tree_items(got).items(), tree_items(ref).values()):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    assert back["params"]["layers"][0]["attn"]["wq"]["w"].dtype == torch.bfloat16


def test_async_save_cleanup_and_atomicity(tmp_path):
    tree = {"x": torch.arange(10)}
    for s in (1, 2, 3, 4):
        t = tckpt.save(tmp_path, s, tree, blocking=False)
        if t:
            t.join()
    tckpt.cleanup(tmp_path, keep=2)
    assert tckpt.latest_step(tmp_path) == 4
    assert (tmp_path / "step_00000003").exists() and not (tmp_path / "step_00000001").exists()
    assert not any(p.name.startswith(".tmp") for p in tmp_path.iterdir())
    (tmp_path / "step_00000009").mkdir()  # a directory without its manifest is not complete
    (tmp_path / ".tmp_step_00000010").mkdir()
    assert tckpt.latest_step(tmp_path) == 4


def test_straggler_watchdog():
    w = ttl.StragglerWatchdog(factor=2.0)
    for s in range(10):
        assert not w.observe(s, 0.1)
    assert w.observe(10, 0.5)
    assert len(w.events) == 1
    assert w.ewma == pytest.approx(0.1, rel=0.01)
