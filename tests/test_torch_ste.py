"""The port's straight-through estimators (STE) and training-time noise
stages against the JAX reference, on the same numpy inputs.

* ``noise.stages``: ``round_ste``, ``adc_quantize(differentiable=True)``,
  ``filter_truncation``, ``detector_noise``; ``noise.channel.
  apply_channel_psum`` and its gradient;
* ``core.dpu``: ``dpu_int_gemm``, ``photonic_matmul`` and
  ``photonic_matmul_ste``;
* the engine's ``matmul_float`` (per-call weight quantization) and
  ``matmul`` (prepacked) as autograd functions, reached through
  ``models.common.dense`` as the models reach them.

Tolerances, fixed before the first run:

* forward values: bitwise where the reference is (ideal channel, f32
  quantization, deterministic stages); under detector noise the psums may
  round one LSB apart at <= 1% of elements (ulp-close Box-Muller draws);
  the bias/activation tail within 1e-5 relative (FMA contraction in the
  reference's compiled epilogue);
* gradients: ``rtol=1e-5, atol=1e-6`` against both torch autograd of the
  dense product and ``jax.grad`` of the reference.  Not the reference's
  own ``rtol=1e-6`` (``tests/test_dpu_ste.py``): the STE backward sums
  the 2-D product ``g2 @ w.T`` in another order than autodiff of the 3-D
  ``x @ w``, and that bar fails on the reference itself (34 of 1,024
  elements off, max abs 9.4e-7, on the installed JAX).  With a gelu
  epilogue the absolute part is ``1e-6`` of the gradient's max abs
  instead: torch's and XLA's tanh-gelu derivatives differ in the last ulp
  at most elements (whatever the spelling), and ``dw = x.T @ g`` carries
  that into small, cancelling sums (one element of 960 off by 1.07e-6 at
  a max abs of 2.5, against ``atol=1e-6``);
* the STE gradient under a noisy channel equals the ideal channel's
  bitwise (the backward never sees the forward's perturbation).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import dpu as jdpu  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.noise import channel as jch  # noqa: E402
from repro.noise import stages as jst  # noqa: E402
from repro.photonic.engine import PhotonicEngine as JEngine  # noqa: E402
from repro.photonic.packing import pack_dense as jpack  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import dpu as tdpu  # noqa: E402
from repro_torch.models import common as tcm  # noqa: E402
from repro_torch.noise import channel as tch  # noqa: E402
from repro_torch.noise import stages as tst  # noqa: E402
from repro_torch.photonic.engine import PhotonicEngine as TEngine  # noqa: E402
from repro_torch.photonic.packing import pack_dense as tpack  # noqa: E402

GRAD_TOL = dict(rtol=1e-5, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _data(seed=0, b=4, s=8, k=32, c=16):
    rng = np.random.default_rng(seed)
    return (
        rng.normal(size=(b, s, k)).astype(np.float32),
        rng.normal(size=(k, c)).astype(np.float32),
        rng.normal(size=(b, s, c)).astype(np.float32),
    )


def _grads(fn, *arrays):
    """Gradients of ``fn(*tensors)`` (a scalar) with respect to each input."""
    ts = [_t(a).requires_grad_(True) for a in arrays]
    fn(*ts).backward()
    return [t.grad.numpy() for t in ts]


# ---------------------------------------------------------------------------
# Stages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("adc_bits", [None, 8])
def test_round_ste_and_differentiable_adc_match_reference(adc_bits):
    rng = np.random.default_rng(0)
    a = np.concatenate([rng.normal(size=60) * 200, [0.5, 1.5, -2.5, 1e6, -1e6]]).astype(np.float32)
    np.testing.assert_array_equal(tst.round_ste(_t(a)).numpy(), np.asarray(jst.round_ste(jnp.asarray(a))))
    want = np.asarray(jst.adc_quantize(jnp.asarray(a), adc_bits, differentiable=True))
    got = tst.adc_quantize(_t(a), adc_bits, differentiable=True)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tst.adc_quantize(_t(a), adc_bits).numpy(), np.asarray(jst.adc_quantize(jnp.asarray(a), adc_bits))
    )
    jg = np.asarray(jax.grad(lambda v: jst.adc_quantize(v, adc_bits, differentiable=True).sum())(jnp.asarray(a)))
    (tg,) = _grads(lambda v: tst.adc_quantize(v, adc_bits, differentiable=True).sum(), a)
    np.testing.assert_array_equal(tg, jg)
    (rg,) = _grads(lambda v: (tst.round_ste(v) * 3.0).sum(), a)
    np.testing.assert_array_equal(rg, np.full_like(a, 3.0))


def test_filter_and_detector_stages_match_reference():
    rng = np.random.default_rng(1)
    a = (rng.normal(size=(6, 5, 7)) * 50).astype(np.float32)
    np.testing.assert_array_equal(
        tst.filter_truncation(_t(a), 0.13).numpy(), np.asarray(jst.filter_truncation(jnp.asarray(a), 0.13))
    )
    seed = int(jst.fold_seed(jnp.uint32(9), 2))
    want = np.asarray(jst.detector_noise(jnp.asarray(a), 3.5, jnp.uint32(seed)))
    got = tst.detector_noise(_t(a), 3.5, seed).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * np.spacing(np.abs(want).max()))
    assert tst.detector_noise(_t(a), 0.0, seed) is not None
    np.testing.assert_array_equal(tst.detector_noise(_t(a), 0.0, seed).numpy(), a)
    (g,) = _grads(lambda v: tst.detector_noise(tst.filter_truncation(v, 0.13), 3.5, seed).sum(), a)
    np.testing.assert_array_equal(g, np.full_like(a, np.float32(1.0 - 0.13)))


def test_apply_channel_psum_gradient_matches_reference():
    """Reference: ``tests/test_noise_channel.py::test_apply_channel_psum_differentiable``
    (STE through the ADC's rounding, zero where it saturates)."""
    a = np.asarray([0.4, 10.0, 1e6, -1e6, 37.2, -5.5], np.float32)
    jc = jch.build_channel_model("SMWA", n=16, adc_bits=8)
    tc = tch.build_channel_model("SMWA", n=16, adc_bits=8)
    seed = int(jst.fold_seed(jnp.uint32(0), 0))
    want = np.asarray(jch.apply_channel_psum(jnp.asarray(a), jc, jnp.uint32(seed)))
    got = tch.apply_channel_psum(_t(a), tc, seed).numpy()
    assert np.abs(got - want).max() <= 1.0  # a draw one ulp apart may round one LSB apart
    jg = np.asarray(jax.grad(lambda v: jch.apply_channel_psum(v, jc, jnp.uint32(seed)).sum())(jnp.asarray(a)))
    (tg,) = _grads(lambda v: tch.apply_channel_psum(v, tc, seed).sum(), a)
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_allclose(tg[:2], 1.0 - tc.filter_alpha, rtol=1e-6)
    np.testing.assert_array_equal(tg[2:4], 0.0)
    ints = tch.apply_channel_psum(_t(a), tc, seed, differentiable=False)
    assert ints.dtype == torch.int32 and np.abs(ints.numpy() - want).max() <= 1.0


# ---------------------------------------------------------------------------
# core.dpu
# ---------------------------------------------------------------------------
def _dpu_pair(channel):
    if channel == "ideal":
        return jdpu.DPUConfig(dpe_size=16), tdpu.DPUConfig(dpe_size=16)
    if channel == "adc":
        return jdpu.DPUConfig(dpe_size=16, adc_bits=9), tdpu.DPUConfig(dpe_size=16, adc_bits=9)
    return (
        jdpu.DPUConfig(dpe_size=16, channel=jch.build_channel_model("SMWA", n=16), noise_seed=5),
        tdpu.DPUConfig(dpe_size=16, channel=tch.build_channel_model("SMWA", n=16), noise_seed=5),
    )


@pytest.mark.parametrize("channel", ["ideal", "adc", "smwa"])
def test_dpu_int_gemm_and_photonic_matmul_match_reference(channel):
    jc, tc = _dpu_pair(channel)
    rng = np.random.default_rng(2)
    xq = rng.integers(-127, 128, (12, 40)).astype(np.int8)
    wq = rng.integers(-127, 128, (40, 24)).astype(np.int8)
    want = np.asarray(jdpu.dpu_int_gemm(jnp.asarray(xq), jnp.asarray(wq), jc)).astype(np.int64)
    got = tdpu.dpu_int_gemm(_t(xq), _t(wq), tc)
    assert got.dtype == torch.int32
    d = np.abs(got.numpy().astype(np.int64) - want)
    x, w, _ = _data(3)
    yw = np.asarray(jdpu.photonic_matmul(jnp.asarray(x), jnp.asarray(w), jc))
    yg = tdpu.photonic_matmul(_t(x), _t(w), tc).numpy()
    if channel == "smwa":
        assert (d > 0).mean() <= 0.01 and d.max() <= 512
        assert np.abs(yg - yw).max() <= 1e-2 * np.abs(yw).max()
    else:
        assert d.max() == 0
        np.testing.assert_array_equal(yg, yw)


def test_photonic_matmul_ste_grads_match_dense_autograd_and_reference():
    x, w, g = _data()
    jc, tc = _dpu_pair("ideal")
    gx_t, gw_t = _grads(lambda a, b: (tdpu.photonic_matmul_ste(a, b, tc) * _t(g)).sum(), x, w)
    ex, ew = _grads(lambda a, b: ((a @ b) * _t(g)).sum(), x, w)
    jx, jw = jax.grad(
        lambda a, b: (jdpu.photonic_matmul_ste(a, b, jc) * jnp.asarray(g)).sum(), argnums=(0, 1)
    )(jnp.asarray(x), jnp.asarray(w))
    for got, dense, ref in ((gx_t, ex, jx), (gw_t, ew, jw)):
        np.testing.assert_allclose(got, dense, **GRAD_TOL)
        np.testing.assert_allclose(got, np.asarray(ref), **GRAD_TOL)
    np.testing.assert_array_equal(
        tdpu.photonic_matmul_ste(_t(x), _t(w), tc).detach().numpy(),
        np.asarray(jdpu.photonic_matmul_ste(jnp.asarray(x), jnp.asarray(w), jc)),
    )


def test_ste_grads_under_noise_equal_ideal_bitwise():
    x, w, g = _data(1)
    _, ideal = _dpu_pair("ideal")
    _, noisy = _dpu_pair("smwa")
    y_i = tdpu.photonic_matmul_ste(_t(x), _t(w), ideal)
    y_n = tdpu.photonic_matmul_ste(_t(x), _t(w), noisy)
    assert (y_i != y_n).any()
    gi = _grads(lambda a, b: (tdpu.photonic_matmul_ste(a, b, ideal) * _t(g)).sum(), x, w)
    gn = _grads(lambda a, b: (tdpu.photonic_matmul_ste(a, b, noisy) * _t(g)).sum(), x, w)
    for a, b in zip(gi, gn):
        np.testing.assert_array_equal(a, b)
        assert np.isfinite(a).all()
    # A key wins over noise_seed and draws the reference's stream (the
    # psum tier of the noisy forward: one-LSB roundings at <= 1%).
    jnoisy, _ = _dpu_pair("smwa")
    yk = tdpu.photonic_matmul_ste(_t(x), _t(w), noisy, prng_key=prng.PRNGKey(9))
    want = np.asarray(jdpu.photonic_matmul_ste(
        jnp.asarray(x), jnp.asarray(w), jnoisy, prng_key=jax.random.PRNGKey(9)))
    assert (yk != y_n).any()
    assert (yk.detach().numpy() != want).mean() <= 0.01
    assert np.abs(yk.detach().numpy() - want).max() <= 1e-2 * np.abs(want).max()
    gk = _grads(lambda a, b: (tdpu.photonic_matmul_ste(a, b, noisy, prng_key=prng.PRNGKey(9))
                              * _t(g)).sum(), x, w)
    for a, b in zip(gi, gk):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# The engine through models.common.dense
# ---------------------------------------------------------------------------
JBACKEND = {"kernel": "pallas", "ref": "ref"}


def _model_cfgs(backend):
    jc = jcm.ModelConfig(photonic=jdpu.DPUConfig(organization="SMWA", bits=4, dpe_size=16),
                         photonic_backend=JBACKEND[backend])
    tc = tcm.ModelConfig(photonic=tdpu.DPUConfig(organization="SMWA", bits=4, dpe_size=16),
                         photonic_backend=backend)
    return jc, tc


def _dense_inputs(seed=4, b=2, s=5, k=40, c=24):
    rng = np.random.default_rng(seed)
    return (
        rng.normal(size=(b, s, k)).astype(np.float32),
        (rng.normal(size=(k, c)) / np.sqrt(k)).astype(np.float32),
        rng.normal(size=c).astype(np.float32),
        rng.normal(size=(b, s, c)).astype(np.float32),
    )


@pytest.mark.parametrize("activation", [None, "gelu"])
@pytest.mark.parametrize("backend", ["kernel", "ref"])
def test_dense_float_weights_grads_match_reference(backend, activation):
    """``dense`` on float weights (``photonic_scope="weights"``): the
    engine's ``_float_matmul`` STE with bias and activation."""
    x, w, b, g = _dense_inputs()
    jc, tc = _model_cfgs(backend)
    spec = dict(epilogue=None) if activation is None else dict(activation=activation)

    def jloss(x, w, b):
        return (jcm.dense({"w": w, "b": b}, x, jc, site="ffn.wi", layer=1, **spec) * jnp.asarray(g)).sum()

    def tloss(x, w, b):
        return (tcm.dense({"w": w, "b": b}, x, tc, site="ffn.wi", layer=1, **spec) * _t(g)).sum()

    want_y = np.asarray(jcm.dense({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x), jc,
                                  site="ffn.wi", layer=1, **spec))
    got_y = tcm.dense({"w": _t(w), "b": _t(b)}, _t(x), tc, site="ffn.wi", layer=1, **spec).detach().numpy()
    np.testing.assert_allclose(got_y, want_y, rtol=1e-5, atol=1e-5)
    ref = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = _grads(tloss, x, w, b)

    act = (lambda y: y) if activation is None else (lambda y: torch.nn.functional.gelu(y, approximate="tanh"))
    dense = _grads(lambda x, w, b: (act(x @ w + b) * _t(g)).sum(), x, w, b)
    for name, a, r, d in zip("xwb", got, ref, dense):
        r = np.asarray(r)
        tol = GRAD_TOL if activation is None else dict(rtol=1e-5, atol=1e-6 * np.abs(r).max())
        np.testing.assert_allclose(a, r, **tol, err_msg=f"d{name} vs jax.grad")
        np.testing.assert_allclose(a, d, **tol, err_msg=f"d{name} vs dense autograd")


@pytest.mark.parametrize("backend", ["kernel", "ref"])
def test_dense_packed_weights_grads(backend):
    """``dense`` on a prepacked weight (the reference's ``_packed_matmul``):
    ``dx = g @ dequant(w).T`` and ``db = g.sum(0)``; the int8 bank gets no
    gradient and its scale zeros."""
    x, w, b, g = _dense_inputs(5)
    jc, tc = _model_cfgs(backend)
    je, te = JEngine(dpu=jc.photonic, backend=jc.photonic_backend), TEngine(dpu=tc.photonic, backend=backend)
    jp = {**jpack({"w": jnp.asarray(w)}, je), "b": jnp.asarray(b)}
    tp = {**tpack({"w": _t(w)}, te), "b": _t(b).requires_grad_(True)}
    xt = _t(x).requires_grad_(True)
    w_scale = tp["w"].w_scale.requires_grad_(True)
    (tcm.dense(tp, xt, tc, site="attn.wq", layer=0) * _t(g)).sum().backward()
    deq = tp["w"].dequant().to(torch.float32).detach()
    g2 = _t(g).reshape(-1, g.shape[-1])
    np.testing.assert_allclose(xt.grad.numpy(), (g2 @ deq.T).reshape(x.shape).numpy(), **GRAD_TOL)
    np.testing.assert_allclose(tp["b"].grad.numpy(), g2.sum(0).numpy(), **GRAD_TOL)
    np.testing.assert_array_equal(w_scale.grad.numpy(), 0.0)
    assert tp["w"].wq.grad is None
    jx, jb = jax.grad(
        lambda x, b: (jcm.dense({**jp, "b": b}, x, jc, site="attn.wq", layer=0) * jnp.asarray(g)).sum(),
        argnums=(0, 1),
    )(jnp.asarray(x), jnp.asarray(b))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jx), **GRAD_TOL)
    np.testing.assert_allclose(tp["b"].grad.numpy(), np.asarray(jb), **GRAD_TOL)


def test_serving_forward_unchanged_under_no_grad():
    """The autograd functions leave the forward as it was: the same bytes
    with and without grad mode, and a routed output carries a grad_fn only
    when an input needs one."""
    x, w, b, _ = _dense_inputs(6)
    _, tc = _model_cfgs("kernel")
    p = {"w": _t(w), "b": _t(b)}
    with torch.no_grad():
        y0 = tcm.dense(p, _t(x), tc, site="attn.wo", layer=2)
    y1 = tcm.dense({"w": _t(w).requires_grad_(True), "b": _t(b)}, _t(x), tc, site="attn.wo", layer=2)
    assert y0.grad_fn is None and y1.grad_fn is not None
    np.testing.assert_array_equal(y0.numpy(), y1.detach().numpy())


def test_flash_attention_raises_under_autograd_and_dots_remat_is_not_ported():
    from repro_torch.photonic.flash import flash_attention

    q = torch.randn(1, 8, 2, 64, requires_grad=True)
    k = torch.randn(1, 8, 1, 64)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, k, k)
    with torch.no_grad():
        assert flash_attention(q, k, k).shape == (1, 8, 2, 64)
    # The "dots" policy runs (test_torch_train.py holds it bitwise to
    # "full"); remat off returns the function itself.
    cfg = dataclasses.replace(tcm.ModelConfig(), remat_policy="dots")
    v = torch.randn(3, 4, requires_grad=True)
    (gr,) = torch.autograd.grad(tcm.apply_remat(lambda t: (t @ t.T).sum(), cfg)(v), v)
    (gp,) = torch.autograd.grad((v @ v.T).sum(), v)
    assert torch.equal(gr, gp)
    assert tcm.apply_remat(abs, dataclasses.replace(cfg, remat=False)) is abs
