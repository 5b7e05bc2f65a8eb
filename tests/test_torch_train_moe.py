"""Training the port's moe family against the reference: the loss and
every gradient leaf of ``lm_loss`` (MLA with its STE over ``wq`` / ``wdkv``
/ ``wuk`` / ``wuv`` / ``wo``, the top-k MoE with its digital router and the
``0.01 x aux`` load-balancing term), both remat policies, the int8-stored
layout of the whole ``lm_def``, and ``train()``, at deepseek-v2-lite-16b's
and phi3.5-moe-42b-a6.6b's smoke configs with the reference's weights
carried over (``params_from_jax``) and ``tests/test_archs_smoke.py``'s
``_make_batch`` inputs (B = 2, T = 16, ``default_rng(0)``).

Tolerances, fixed before the first run:

* digitally (``photonic=None``): the loss within ``1e-5`` relative, every
  gradient leaf within ``rtol=1e-5`` plus ``1e-5`` of the leaf's max abs
  (f32 einsums, softmax and ``rmsnorm`` sum in other orders; the dense
  family's gradients hold ``rtol=1e-5``);
* on the ideal channel (the port's kernel twin against the reference's
  ``ref``, both exact): every leaf within ``1e-3`` of its max abs, or,
  after a one-code quantization flip (the losses more than ``1e-5``
  apart: an f32 activation within an ulp of an int8 rounding boundary
  takes the next code on one side), the chip's bf16 floor: the loss within
  ``1e-3`` relative and every leaf within ``2e-2`` of its max abs;
* ``remat_policy="dots"`` against ``"full"``: bitwise;
* the int8 layout: bitwise; its logits on the ideal channel within
  ``1e-5`` (or the bf16 floor after a flip); ``train()`` against the
  reference's ``train()`` (which runs its ``exact`` backend; on the ideal
  channel every backend is bitwise the same): losses within ``1e-4``
  relative, as for the dense family.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core.dpu import DPUConfig as JDPU  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models.common import init_tree  # noqa: E402
from repro.models.common import quantize_params as jquantize  # noqa: E402
from repro.optim import adamw as jopt  # noqa: E402
from repro.runtime import train_loop as jtl  # noqa: E402
from repro_torch._tree import tree_items  # noqa: E402
from repro_torch.checkpoint import ckpt as tckpt  # noqa: E402
from repro_torch.core.dpu import DPUConfig as TDPU  # noqa: E402
from repro_torch.data import pipeline as tdata  # noqa: E402
from repro_torch.models import common as tcm  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models.common import quantize_params as tquantize  # noqa: E402
from repro_torch.optim import adamw as topt  # noqa: E402
from repro_torch.runtime import train_loop as ttl  # noqa: E402
from repro_torch.weights import params_from_jax, params_to_reference  # noqa: E402

NAMES = ("deepseek-v2-lite-16b", "phi3.5-moe-42b-a6.6b")
MODES = pytest.mark.parametrize("photonic", [False, True], ids=["digital", "ideal-photonic"])
B, T = 2, 16


def _cfgs(name, photonic, **kw):
    jc = dataclasses.replace(jreg.get(name).smoke_config, **kw)
    tc = dataclasses.replace(treg.get(name).smoke_config, **kw)
    if photonic:
        jc = dataclasses.replace(jc, photonic=JDPU(organization="SMWA", bits=4, dpe_size=16), photonic_backend="ref")
        tc = dataclasses.replace(tc, photonic=TDPU(organization="SMWA", bits=4, dpe_size=16),
                                 photonic_backend="kernel")
    return jc, tc


@pytest.fixture(scope="module")
def weights():
    """The reference's smoke weights (jitted ``init_tree``, PRNGKey(0)) as
    numpy trees, by arch."""
    out = {}
    for name in NAMES:
        arch = jreg.get(name)
        jp = jax.jit(lambda k, a=arch: init_tree(a.param_defs(a.smoke_config), k, jnp.float32))(jax.random.PRNGKey(0))
        out[name] = jax.tree.map(np.asarray, jp)
    return out


def _batch(cfg):
    """``tests/test_archs_smoke.py::_make_batch`` (tokens and labels)."""
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    return {"tokens": toks, "labels": rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)}


def _t(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


@pytest.fixture(scope="module")
def reference(weights):
    """``reference(name, photonic)``: the reference's jitted
    ``jax.value_and_grad(arch.loss)`` on ``_batch``, (loss, numpy grads),
    computed once a case."""
    done = {}

    def get(name, photonic):
        if (name, photonic) not in done:
            arch, (jc, _) = jreg.get(name), _cfgs(name, photonic)
            loss, g = jax.jit(jax.value_and_grad(lambda p, b: arch.loss(p, b, jc)))(
                jax.tree.map(jnp.asarray, weights[name]), _batch(jc))
            done[name, photonic] = float(loss), jax.tree.map(np.asarray, g)
        return done[name, photonic]

    return get


def _port(name, tc, npt, batch, loss_fn=None):
    """The port's loss and gradients, the gradients in the reference's
    stacked layout."""
    loss_fn = loss_fn or treg.get(name).loss
    loss, grads = ttl._value_and_grad(lambda p, b: loss_fn(p, b, tc), params_from_jax(npt, tc, "cpu"), _t(batch))
    return float(loss), params_to_reference(grads)


def _assert_grads(got, want, loss, want_loss, photonic):
    """The tolerances of the module docstring, leaf by leaf."""
    assert jax.tree.structure(got) == jax.tree.structure(want)
    flipped = photonic and abs(loss - want_loss) > 1e-5 * abs(want_loss)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-3 if flipped else 1e-5)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want), jax.tree.leaves(got)):
        assert np.isfinite(g).all(), path
        m = np.abs(w).max()
        if not photonic:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * m, err_msg=jax.tree_util.keystr(path))
        else:
            tol = 2e-2 if flipped else 1e-3
            np.testing.assert_allclose(g, w, rtol=0, atol=tol * m, err_msg=jax.tree_util.keystr(path))


@MODES
@pytest.mark.parametrize("name", NAMES)
def test_loss_and_grads_match_reference(weights, reference, name, photonic):
    """Every leaf, the router and the expert banks included; on the ideal
    channel each routed weight gets a nonzero gradient through the STE
    (the twin's rounding alone would give zeros)."""
    jc, tc = _cfgs(name, photonic)
    want_loss, want = reference(name, photonic)
    loss, got = _port(name, tc, weights[name], _batch(jc))
    _assert_grads(got, want, loss, want_loss, photonic)
    flat = {jax.tree_util.keystr(p): g for p, g in jax.tree_util.tree_leaves_with_path(got)}
    routed = [k for k in flat if k.endswith("['w']") and "router" not in k]
    sites = ("wq", "wdkv", "wuk", "wuv", "wo") if jc.mla else ("wq", "wk", "wv", "wo")
    assert all(any(f"['{s}']['w']" in k for k in routed) for s in sites)
    assert all(float(np.abs(flat[k]).max()) > 0 for k in routed)
    assert float(np.abs(flat["['layers']['ffn']['router']['w']"]).max()) > 0


@pytest.mark.parametrize("name", NAMES)
def test_loss_without_the_aux_term_fails_the_router_gradient_check(weights, reference, name):
    """Negative control: with the port's cross-entropy alone (``lm_loss``
    without ``0.01 x aux``) every router leaf fails the digital tolerance
    (and, through the router's input, the leaves upstream of it move too).
    The aux term reaches the router through ``prob = mean(gates)``;
    ``frac`` (a one-hot of the top-1 expert) carries no gradient."""
    jc, tc = _cfgs(name, False)
    _, want = reference(name, False)

    def ce_only(p, b, cfg):
        logits, _ = tlm.lm_logits(p, b["tokens"], cfg)
        return tcm.softmax_cross_entropy(logits, b["labels"], cfg.vocab_size)

    _, got = _port(name, tc, weights[name], _batch(jc), loss_fn=ce_only)
    failed = []
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want), jax.tree.leaves(got)):
        if not np.allclose(g, w, rtol=1e-5, atol=1e-5 * np.abs(w).max()):
            failed.append(jax.tree_util.keystr(path))
    routers = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(want) if "router" in str(p)]
    assert routers and set(routers) <= set(failed), failed


@MODES
def test_dots_remat_policy_equals_full_bitwise(weights, photonic):
    """``remat_policy="dots"`` saves the expert einsums' and the digital
    router's products; the photonic kernel is recomputed under both
    policies.  Loss and every gradient bitwise equal ``"full"``'s, and
    both equal the run without remat."""
    name = NAMES[0]
    runs = {}
    for label, kw in (("full", {}), ("dots", dict(remat_policy="dots")), ("off", dict(remat=False))):
        _, tc = _cfgs(name, photonic, **kw)
        runs[label] = ttl._value_and_grad(lambda p, b, c=tc: treg.get(name).loss(p, b, c),
                                          params_from_jax(weights[name], tc, "cpu"), _t(_batch(tc)))
    for label in ("dots", "off"):
        assert torch.equal(runs["full"][0], runs[label][0]), label
        for (k, a), b in zip(tree_items(runs["full"][1]).items(), tree_items(runs[label][1]).values()):
            assert torch.equal(a, b), (label, k)


@pytest.mark.parametrize("name", NAMES)
def test_quantize_params_over_the_whole_moe_lm_def(weights, name):
    """``quantize_params`` over the whole ``lm_def`` of the moe smoke
    config (``photonic_scope="weights_int8"``): the router and every
    attention and shared-expert bank int8 with an f32 ``w_scale``, the
    routed experts' ``wi`` / ``wo`` float (plain ``P`` in the reference,
    ``ffn.py:57-66``), bitwise the reference's layout; the int8-layout
    logits and aux on the ideal channel equal the reference's."""
    jc, tc = _cfgs(name, True, photonic_scope="weights_int8")
    jq = jquantize(jax.tree.map(jnp.asarray, weights[name]), jreg.get(name).param_defs(jc))
    tq = tquantize(params_from_jax(weights[name], tc, "cpu"), treg.get(name).param_defs(tc))
    for layer in tq["layers"]:
        assert layer["ffn"]["router"]["w"].dtype == torch.int8
        assert layer["ffn"]["router"]["w_scale"].dtype == torch.float32
        assert layer["ffn"]["wi"].dtype == layer["ffn"]["wo"].dtype == torch.float32
        assert all(v["w"].dtype == torch.int8 for v in layer["attn"].values())
    want = jax.tree.map(np.asarray, jq)
    got = params_to_reference(tq)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want), jax.tree.leaves(got)):
        assert g.dtype == w.dtype, path
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))
    toks = _batch(jc)["tokens"]
    wl, waux = jax.jit(lambda p, t: jlm.lm_logits(p, t, jc))(jq, toks)
    with torch.no_grad():
        gl, gaux = tlm.lm_logits(tq, torch.from_numpy(toks).long(), tc)
    wl, gl = np.asarray(wl, np.float64), gl.numpy().astype(np.float64)
    if np.allclose(gl, wl, rtol=1e-5, atol=1e-5):
        np.testing.assert_allclose(float(gaux), float(waux), rtol=1e-5)
    else:  # a one-code flip: the bf16 floor
        assert np.abs(gl - wl).max() <= 2e-2 * np.abs(wl).max()
        assert (gl.argmax(-1) == wl.argmax(-1)).mean() >= 0.9


DATA = dict(seq_len=16, global_batch=4, seed=1)
OPT = dict(lr=3e-3, warmup_steps=1, total_steps=3)


def test_train_matches_reference_losses(weights, tmp_path):
    """deepseek-v2-lite's smoke config through ``train()``, ideal channel,
    3 steps: the port (its kernel twin) against the reference's
    ``train()``; the reference's init (PRNGKey(0)) enters the port as a
    step-0 checkpoint, which ``train()`` resumes.  The final checkpoint
    holds the first block, the per-layer list and the expert banks."""
    name = NAMES[0]
    jc, tc = _cfgs(name, True)
    data = dict(DATA, vocab_size=jc.vocab_size)
    ref = jtl.train(
        arch=jreg.get(name), model_cfg=jc, data_cfg=jdata.DataConfig(**data),
        train_cfg=jtl.TrainConfig(steps=3, ckpt_every=1000, ckpt_dir=str(tmp_path / "jax"), log_every=100,
                                  async_checkpoint=False),
        opt_cfg=jopt.AdamWConfig(**OPT), log=lambda m: None,
    )
    tp = params_from_jax(weights[name], tc, "cpu")
    tckpt.save(tmp_path / "port", 0, {"params": tp, "opt": topt.init(tp)})
    out = ttl.train(
        arch=treg.get(name), model_cfg=tc, data_cfg=tdata.DataConfig(**data),
        train_cfg=ttl.TrainConfig(steps=3, ckpt_every=1000, ckpt_dir=str(tmp_path / "port"), log_every=100),
        opt_cfg=topt.AdamWConfig(**OPT), log=lambda m: None, device="cpu",
    )
    assert out["final_step"] == 3 and tckpt.latest_step(tmp_path / "port") == 3
    np.testing.assert_allclose(out["losses"], ref["losses"], rtol=1e-4)
    assert set(out["params"]) >= {"first_block", "layers"}
