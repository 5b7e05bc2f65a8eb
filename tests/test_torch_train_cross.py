"""Training the port's cross-attention families against the reference:
the loss and every gradient leaf of llama-3.2-vision's ``lm_loss(vision=)``
(gated cross layers, gates at their zero init and opened to 0.5) and of
whisper's ``whisper_loss`` (the encoder included; no GEMM passes
``layer=``), and one ``build_train_step`` step on a batch that carries
``vision`` / ``audio_embed`` (``train()``'s data stream yields tokens and
labels only, as the reference's does), at each smoke config with the
reference's weights carried over (``params_from_jax``) and
``tests/test_archs_smoke.py``'s ``_make_batch`` inputs (B = 2, T = 16,
vision (B, vision_seq, d) and audio (B, 2T, d) f32 normals,
``default_rng(0)``).

Tolerances, fixed before the first run:

* digitally (``photonic=None``): the loss within ``1e-5`` relative, every
  gradient leaf within ``rtol=1e-5`` plus ``1e-5`` of the leaf's max abs
  (f32 einsums, softmax and ``rmsnorm`` sum in other orders; the dense
  family's gradients hold ``rtol=1e-5``); a leaf the loss does not reach
  is zero in both;
* on the ideal channel (the port's kernel twin against the reference's
  ``ref``, both exact): every leaf within ``1e-3`` of its max abs, or,
  after a one-code quantization flip (the losses more than ``1e-5``
  apart), the chip's bf16 floor: the loss within ``1e-3`` relative and
  every leaf within ``2e-2`` of its max abs;
* ``build_train_step``: the loss and the clipped gradient norm within
  ``1e-5`` relative, AdamW's first moment (0.1 x the clipped gradient after
  one step) within the digital gradient tolerance scaled by 0.1.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core.dpu import DPUConfig as JDPU  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models.common import init_tree  # noqa: E402
from repro.optim import adamw as jopt  # noqa: E402
from repro.runtime import train_loop as jtl  # noqa: E402
from repro_torch.core.dpu import DPUConfig as TDPU  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.optim import adamw as topt  # noqa: E402
from repro_torch.runtime import train_loop as ttl  # noqa: E402
from repro_torch.weights import params_from_jax, params_to_reference  # noqa: E402

VISION, WHISPER = "llama-3.2-vision-90b", "whisper-medium"
MODES = pytest.mark.parametrize("photonic", [False, True], ids=["digital", "ideal-photonic"])
CASES = pytest.mark.parametrize("case", ["vision-gates-0", "vision-gates-0.5", "whisper"])
B, T = 2, 16


def _name(case):
    return WHISPER if case == "whisper" else VISION


def _cfgs(name, photonic):
    jc = jreg.get(name).smoke_config
    tc = treg.get(name).smoke_config
    if photonic:
        jc = dataclasses.replace(jc, photonic=JDPU(organization="SMWA", bits=4, dpe_size=16), photonic_backend="ref")
        tc = dataclasses.replace(tc, photonic=TDPU(organization="SMWA", bits=4, dpe_size=16),
                                 photonic_backend="kernel")
    return jc, tc


@pytest.fixture(scope="module")
def weights():
    """The reference's smoke weights (jitted ``init_tree``, PRNGKey(0)) as
    numpy trees, by case: the vision tree with both gates of every cross
    layer (``attn.gate``, ``gate_ffn``) at their zero init and at 0.5."""
    out = {}
    for name in (VISION, WHISPER):
        arch = jreg.get(name)
        jp = jax.jit(lambda k, a=arch: init_tree(a.param_defs(a.smoke_config), k, jnp.float32))(jax.random.PRNGKey(0))
        out[name] = jax.tree.map(np.asarray, jp)
    cross = out[VISION]["cross"]
    assert not cross["gate_ffn"].any() and not cross["attn"]["gate"].any()
    opened = dict(cross, gate_ffn=np.full_like(cross["gate_ffn"], 0.5),
                  attn=dict(cross["attn"], gate=np.full_like(cross["attn"]["gate"], 0.5)))
    return {"vision-gates-0": out[VISION], "vision-gates-0.5": dict(out[VISION], cross=opened),
            "whisper": out[WHISPER]}


def _batch(name, cfg):
    """``tests/test_archs_smoke.py::_make_batch``."""
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    batch = {"tokens": toks, "labels": rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)}
    if name == VISION:
        batch["vision"] = rng.normal(size=(B, cfg.vision_seq, cfg.d_model)).astype(np.float32)
    else:
        batch["audio_embed"] = rng.normal(size=(B, 2 * T, cfg.d_model)).astype(np.float32)
    return batch


def _t(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v) for k, v in batch.items()}


def _leaves(tree):
    return {jax.tree_util.keystr(p): g for p, g in jax.tree_util.tree_leaves_with_path(tree)}


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
@CASES
def test_loss_and_grads_match_reference(weights, case, photonic):
    name = _name(case)
    jc, tc = _cfgs(name, photonic)
    batch = _batch(name, jc)
    arch = jreg.get(name)
    want_loss, want = jax.jit(jax.value_and_grad(lambda p, b: arch.loss(p, b, jc)))(
        jax.tree.map(jnp.asarray, weights[case]), batch)
    loss, grads = ttl._value_and_grad(lambda p, b: treg.get(name).loss(p, b, tc),
                                      params_from_jax(weights[case], tc, "cpu"), _t(batch))
    _assert_grads(params_to_reference(grads), jax.tree.map(np.asarray, want), float(loss), float(want_loss),
                  photonic)


def test_closed_gates_take_gradients_that_the_cross_branch_does_not(weights):
    """At their zero init (``tanh(0) = 0``) a cross layer is the identity:
    its ``attn.gate`` and ``gate_ffn`` get gradients, the cross branch's
    own weights (``wq``/``wk``/``wv``/``wo``, the MLP, both norms) get
    exact zeros, in the port as in the reference; opened to 0.5, every
    cross leaf moves."""
    jc, tc = _cfgs(VISION, False)
    batch = _batch(VISION, jc)
    for case, closed in (("vision-gates-0", True), ("vision-gates-0.5", False)):
        want = jax.jit(jax.grad(lambda p, b: jreg.get(VISION).loss(p, b, jc)))(
            jax.tree.map(jnp.asarray, weights[case]), batch)
        _, grads = ttl._value_and_grad(lambda p, b: treg.get(VISION).loss(p, b, tc),
                                       params_from_jax(weights[case], tc, "cpu"), _t(batch))
        for side in (jax.tree.map(np.asarray, want["cross"]), params_to_reference(grads)["cross"]):
            for k, g in _leaves(side).items():
                gate = k.endswith("['gate']") or k == "['gate_ffn']"
                assert (np.abs(g).max() > 0) == (gate or not closed), (case, k)


@pytest.mark.parametrize("name", [VISION, WHISPER])
def test_build_train_step_with_a_vision_or_audio_batch_matches_reference(weights, name):
    """One AdamW step of ``build_train_step`` on a hand-made batch that
    carries ``vision`` / ``audio_embed`` (the gates opened to 0.5)."""
    case = "vision-gates-0.5" if name == VISION else "whisper"
    jc, tc = _cfgs(name, False)
    batch = _batch(name, jc)
    opt = dict(lr=3e-3, warmup_steps=1, total_steps=3)
    jp = jax.tree.map(jnp.asarray, weights[case])
    jstep = jtl.build_train_step(lambda p, b: jreg.get(name).loss(p, b, jc), jopt.AdamWConfig(**opt))
    _, js, jm = jax.jit(jstep)(jp, jopt.init(jp), {k: jnp.asarray(v) for k, v in batch.items()})
    tp = params_from_jax(weights[case], tc, "cpu")
    tstep = ttl.build_train_step(lambda p, b: treg.get(name).loss(p, b, tc), topt.AdamWConfig(**opt))
    _, ts, tm = tstep(tp, topt.init(tp), _t(batch))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    assert int(ts.step) == 1
    want = jax.tree.map(np.asarray, js.mu)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want), jax.tree.leaves(params_to_reference(ts.mu))):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * np.abs(w).max(), err_msg=jax.tree_util.keystr(path))
