"""Training the port's hybrid family (Zamba2: Mamba2's SSD scan and the
weight-shared attention block) against the reference: the loss and every
gradient leaf of ``zamba2_loss``, the SSD's masked ``exp`` and the
reference's NaN gradient at its published ``ssm_chunk = 256``, both remat
policies and ``train()``, at zamba2-2.7b's smoke config (2 groups of 2
Mamba2 layers, d 64, 8 SSD heads of 16, chunk 16) with the reference's
weights carried over (``params_from_jax``) and
``tests/test_archs_smoke.py``'s ``_make_batch`` inputs (B = 2, T = 16,
``default_rng(0)``).

The reference's SSD takes ``exp(gap)`` of every intra-chunk entry and
drops the ones above the diagonal afterwards (``src/repro/models/ssm.py:
114-117``).  There ``gap = b_t - b_s > 0`` grows to about ``0.7 x (chunk -
1)`` at the zero init of ``a_log`` / ``dt_bias``; at chunk 256 it passes
f32's ``exp`` limit (88.7), and the backward multiplies the dropped
``inf`` by a zero cotangent: NaN.  The port masks ``gap`` before the exp
(``models/ssm.py::_live_exp``): its forward is bitwise the unmasked form,
and its gradient is finite and equals the reference's wherever that is
(ROADMAP Queue 3 item 11).  The chunked SSD does not depend on the chunk,
so the port at chunk 256 is held to the unmodified reference at chunk 16.

``conv_b``, ``a_log`` and ``dt_bias`` init to zero; the gradient tests
give them seeded normals (0.5 x N(0, 1)), as the serving tests do, and the
chunk-256 tests keep the reference's init, where the overflow happens.

Tolerances, fixed before the first run (the recurrent tier, ROADMAP Queue
3 item 10):

* digitally: the loss within ``1e-5`` relative; every gradient leaf
  within ``1e-3`` of its max abs; the port's gradient no further from the
  port's f64 gradient than twice the reference's f32 gradient is
  (distance: each leaf's max |d| over its f64 max abs, the max over
  leaves);
* on the ideal channel (the port's kernel twin against the reference's
  ``ref``): the same ``1e-3``, or, after a one-code quantization flip (the
  losses more than ``1e-5`` apart), the loss within ``1e-3`` relative and
  every leaf within ``5e-2`` of its max abs;
* the masked SSD forward against the unmasked one, and ``"dots"`` / no
  remat against ``"full"``: bitwise; ``train()`` against the reference's
  ``train()``: losses within ``1e-3`` relative (``test_torch_train_xlstm``
  says why Adam's first step needs the recurrent tier).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core.dpu import DPUConfig as JDPU  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.common import init_tree  # noqa: E402
from repro.optim import adamw as jopt  # noqa: E402
from repro.runtime import train_loop as jtl  # noqa: E402
from repro_torch._tree import tree_items  # noqa: E402
from repro_torch.checkpoint import ckpt as tckpt  # noqa: E402
from repro_torch.core.dpu import DPUConfig as TDPU  # noqa: E402
from repro_torch.data import pipeline as tdata  # noqa: E402
from repro_torch.models import common as tcm  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.optim import adamw as topt  # noqa: E402
from repro_torch.runtime import train_loop as ttl  # noqa: E402
from repro_torch.weights import params_from_jax, params_to_reference  # noqa: E402

NAME = "zamba2-2.7b"
JA, TA = jreg.get(NAME), treg.get(NAME)
B, T = 2, 16
T_LONG = 300  # one chunk of 256 and a padded one


def _cfgs(photonic, **kw):
    jc = dataclasses.replace(JA.smoke_config, **kw)
    tc = dataclasses.replace(TA.smoke_config, **kw)
    if photonic:
        jc = dataclasses.replace(jc, photonic=JDPU(organization="SMWA", bits=4, dpe_size=16), photonic_backend="ref")
        tc = dataclasses.replace(tc, photonic=TDPU(organization="SMWA", bits=4, dpe_size=16),
                                 photonic_backend="kernel")
    return jc, tc


@pytest.fixture(scope="module")
def weights():
    """The reference's smoke weights (jitted ``init_tree``, PRNGKey(0)) as
    numpy trees: at init, and with ``conv_b`` / ``a_log`` / ``dt_bias``
    seeded."""
    jp = jax.jit(lambda k: init_tree(JA.param_defs(JA.smoke_config), k, jnp.float32))(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(11)
    mamba = dict(init["mamba"])
    for leaf in ("conv_b", "a_log", "dt_bias"):
        assert not mamba[leaf].any()
        mamba[leaf] = (0.5 * rng.normal(size=mamba[leaf].shape)).astype(np.float32)
    return {"init": init, "seeded": dict(init, mamba=mamba)}


def _batch(cfg, t=T):
    """``tests/test_archs_smoke.py::_make_batch`` (tokens and labels), T
    tokens."""
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, t)).astype(np.int32)
    return {"tokens": toks, "labels": rng.integers(0, cfg.vocab_size, (B, t)).astype(np.int32)}


def _t(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _reference(jc, npt, batch):
    loss, g = jax.jit(jax.value_and_grad(lambda p, b: JA.loss(p, b, jc)))(jax.tree.map(jnp.asarray, npt), batch)
    return float(loss), jax.tree.map(np.asarray, g)


def _port(tc, npt, batch):
    loss, grads = ttl._value_and_grad(lambda p, b: TA.loss(p, b, tc), params_from_jax(npt, tc, "cpu"), _t(batch))
    return float(loss), params_to_reference(grads)


def _f64(tc, npt, batch):
    return _port(dataclasses.replace(tc, param_dtype=torch.float64, compute_dtype=torch.float64), npt, batch)[1]


def _distance(tree, g64):
    return max(np.abs(a.astype(np.float64) - b).max() / np.abs(b).max()
               for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(g64)))


def _assert_recurrent(got, want, loss, want_loss, photonic, g64=None):
    """The tolerances of the module docstring."""
    assert jax.tree.structure(got) == jax.tree.structure(want)
    flipped = photonic and abs(loss - want_loss) > 1e-5 * abs(want_loss)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-3 if flipped else 1e-5)
    tol = 5e-2 if flipped else 1e-3
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want), jax.tree.leaves(got)):
        assert np.isfinite(g).all(), path
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * np.abs(w).max(), err_msg=jax.tree_util.keystr(path))
    if g64 is not None:
        assert _distance(got, g64) <= 2 * _distance(want, g64)


def _nonfinite(tree):
    return [jax.tree_util.keystr(p) for p, g in jax.tree_util.tree_leaves_with_path(tree) if not np.isfinite(g).all()]


@pytest.mark.parametrize("photonic", [False, True], ids=["digital", "ideal-photonic"])
def test_loss_and_grads_match_reference(weights, photonic):
    jc, tc = _cfgs(photonic)
    npt, batch = weights["seeded"], _batch(jc)
    want_loss, want = _reference(jc, npt, batch)
    loss, got = _port(tc, npt, batch)
    _assert_recurrent(got, want, loss, want_loss, photonic, None if photonic else _f64(tc, npt, batch))


def _ssd_inputs(t=256, h=2, dh=4, st=8):
    """``_ssd_chunked``'s inputs at B = 1, the raw dt (before softplus) and
    ``a_log`` at its zero init."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, t, h, dh)).astype(np.float32)
    b_mat, c_mat = (rng.normal(size=(1, t, st)).astype(np.float32) for _ in range(2))
    raw_dt = rng.normal(size=(1, t, h)).astype(np.float32)
    return x, b_mat, c_mat, raw_dt, np.zeros(h, np.float32)


def _port_ssd_grad(chunk):
    """The port's ``_ssd_chunked`` output and the gradient of ``sum(y^2)``
    with respect to the raw dt."""
    x, b_mat, c_mat, raw_dt, a_log = (torch.from_numpy(a) for a in _ssd_inputs())
    raw_dt.requires_grad_(True)
    y, s = tssm._ssd_chunked(x, b_mat, c_mat, tcm.softplus(raw_dt), a_log, chunk)
    (y**2).sum().backward()
    return y.detach(), s.detach(), raw_dt.grad


def test_masked_exp_keeps_the_forward_bitwise_and_its_gradient_finite(monkeypatch):
    """At chunk 256 (T = 256, H = 2, ``a_log`` 0): the port's SSD with the
    masked exp gives the unmasked form's output and state bit for bit; its
    gradient is finite where the reference's is all NaN (512 of 512
    entries; 0 at chunk 16), and, with the exp left unmasked, the port's is
    NaN too (negative control)."""
    x, b_mat, c_mat, raw_dt, a_log = _ssd_inputs()

    def ref_grad(chunk):
        def f(raw):
            y, _ = jssm._ssd_chunked(x, b_mat, c_mat, jax.nn.softplus(raw), a_log, chunk)
            return jnp.sum(y**2)

        return np.asarray(jax.grad(f)(raw_dt))

    assert np.isnan(ref_grad(256)).all() and np.isfinite(ref_grad(16)).all()
    y, s, g = _port_ssd_grad(256)
    assert torch.isfinite(g).all()
    monkeypatch.setattr(tssm, "_live_exp", lambda gap, live: torch.exp(gap))
    y_unmasked, s_unmasked, g_unmasked = _port_ssd_grad(256)
    assert torch.equal(y, y_unmasked) and torch.equal(s, s_unmasked)
    assert not torch.isfinite(g_unmasked).any()


def test_chunk_256_gradients_are_finite_where_the_reference_s_are_not(weights):
    """The whole smoke model at the reference's init (``a_log`` and
    ``dt_bias`` zero), ``ssm_chunk = 256``, T = 300: the reference's loss is
    finite but 18 gradient leaves are not (the embedding table among them);
    the port's loss equals the reference's and every leaf is finite."""
    jc, tc = _cfgs(False, ssm_chunk=256)
    npt, batch = weights["init"], _batch(jc, T_LONG)
    want_loss, want = _reference(jc, npt, batch)
    loss, got = _port(tc, npt, batch)
    bad = _nonfinite(want)
    assert np.isfinite(want_loss) and len(bad) == 18 and "['embed']['table']" in bad
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    assert not _nonfinite(got)


def test_chunk_256_gradients_match_the_reference_at_chunk_16(weights):
    """The port at ``ssm_chunk = 256`` (its masked, padded chunk path)
    against the unmodified reference at chunk 16 on the same weights and
    T = 300 tokens, within the recurrent tier; the f64 run is the port's at
    chunk 256."""
    jc, _ = _cfgs(False, ssm_chunk=16)
    _, tc = _cfgs(False, ssm_chunk=256)
    npt, batch = weights["init"], _batch(jc, T_LONG)
    want_loss, want = _reference(jc, npt, batch)
    loss, got = _port(tc, npt, batch)
    _assert_recurrent(got, want, loss, want_loss, False, _f64(tc, npt, batch))


@pytest.mark.parametrize("photonic", [False, True], ids=["digital", "ideal-photonic"])
def test_dots_remat_policy_and_no_remat_equal_full_bitwise(weights, photonic):
    """Each Mamba2 block runs under ``apply_remat``: ``"dots"`` and no remat
    give ``"full"``'s loss and gradients bit for bit."""
    runs = {}
    for label, kw in (("full", {}), ("dots", dict(remat_policy="dots")), ("off", dict(remat=False))):
        _, tc = _cfgs(photonic, **kw)
        runs[label] = ttl._value_and_grad(lambda p, b, c=tc: TA.loss(p, b, c),
                                          params_from_jax(weights["seeded"], tc, "cpu"), _t(_batch(tc)))
    for label in ("dots", "off"):
        assert torch.equal(runs["full"][0], runs[label][0]), label
        for (k, a), b in zip(tree_items(runs["full"][1]).items(), tree_items(runs[label][1]).values()):
            assert torch.equal(a, b), (label, k)


def test_train_matches_reference_losses(weights, tmp_path):
    """3 steps of ``train()`` on the ideal channel from the reference's init,
    which enters the port as a step-0 checkpoint (the doubly stacked
    ``mamba`` as lists of lists), against the reference's ``train()``."""
    jc, tc = _cfgs(True)
    data = dict(vocab_size=jc.vocab_size, seq_len=16, global_batch=4, seed=1)
    opt = dict(lr=3e-3, warmup_steps=1, total_steps=3)
    ref = jtl.train(
        arch=JA, model_cfg=jc, data_cfg=jdata.DataConfig(**data),
        train_cfg=jtl.TrainConfig(steps=3, ckpt_every=1000, ckpt_dir=str(tmp_path / "jax"), log_every=100,
                                  async_checkpoint=False),
        opt_cfg=jopt.AdamWConfig(**opt), log=lambda m: None,
    )
    tp = params_from_jax(weights["init"], tc, "cpu")
    tckpt.save(tmp_path / "port", 0, {"params": tp, "opt": topt.init(tp)})
    out = ttl.train(
        arch=TA, model_cfg=tc, data_cfg=tdata.DataConfig(**data),
        train_cfg=ttl.TrainConfig(steps=3, ckpt_every=1000, ckpt_dir=str(tmp_path / "port"), log_every=100),
        opt_cfg=topt.AdamWConfig(**opt), log=lambda m: None, device="cpu",
    )
    assert out["final_step"] == 3 and tckpt.latest_step(tmp_path / "port") == 3
    np.testing.assert_allclose(out["losses"], ref["losses"], rtol=1e-3)
