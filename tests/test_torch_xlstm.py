"""The port's ssm family (xLSTM: mLSTM and sLSTM layers) against the
reference, at xlstm-350m's smoke config (4 layers: 2 groups of 1 mLSTM +
1 sLSTM, d 64, 2 heads, inner 128, chunk 16) with the reference's weights
carried over (``params_from_jax``).

The mLSTM gates ``wi`` and ``wf`` start at zero in the reference (every
input gate 0, every forget gate log-sigmoid(0)): a broken gate GEMM would
then pass unseen, so the tests give them seeded fan-in normals in both
packages.  Tolerances, each stated where it is used:

* functions, digitally and on the ideal channel (the port's kernel twin
  against the reference's ``ref``, both exact): ``atol=1e-5, rtol=1e-5``
  (f32 ``cumsum`` and three-operand ``einsum`` sum in other orders), the
  sLSTM layer's at ``1e-4`` (its recurrence carries the ulp differences of
  ``exp`` / ``tanh`` / ``sigmoid`` through 21 steps);
  ``log_sigmoid`` within 2 f32 ulps of JAX's over ``|x| <= 100``, or the
  least normal f32 where XLA flushes a subnormal result to zero;
* functions on the SMWA channel seeded (``noise_seed``): both packages on
  their ``ref`` backend, whose Box-Muller draws are ulp-close: the noisy
  tier, a psum one LSB apart at <= 1% of elements, each within 1e-2 of the
  output's max (the sLSTM's: every element within 1e-2 of the max, since
  its recurrence carries one LSB to every later step of the head).  A
  whole noisy model is not compared: a GEMM's noise
  stream hashes its int8 operands, so after one flip the two sides draw
  unrelated noise.  The twin draws the Pallas kernel's stream; it is held
  against the reference's interpret-mode kernel at the gates' full-width
  shape, K = 2048, C = 4 (the narrowest GEMM the kernel runs), ideal
  (bitwise) and SMWA (the noisy tier in psum LSBs);
* whole models: digitally ``atol=rtol=1e-3``: the float differences
  above, carried through 4 layers, the sLSTM recurrence and the mLSTM's
  normalizer, which divides by ``|q n|``; the reference itself lies 1.9e-4
  from an f64 run of the same forward (max |logit| 3.9), and the port is
  held to at most twice the reference's distance from that f64 run.  On
  the ideal channel the same, or, after a quantization flip (an f32
  activation within an ulp of an int8 rounding boundary takes the next
  code on one side), the chip's bf16 floor: max |d| <= 2e-2 of the max
  magnitude and argmax agreement >= 0.9 on logits; a recurrent state
  carries a flip through every later step (at the smoke seed one flip
  moves a group's sLSTM ``h`` / ``c`` / ``n`` / ``m`` by up to 3.4e-2 of
  their max), so after a flip a cache leaf is held within 5e-2 of its
  max.

Held here:

* ``FULL`` and ``SMOKE`` equal the reference's field for field, and
  ``param_defs(FULL)`` equals the reference's leaf for leaf in shape, init
  and dtype, its ``mlstm`` ``(3, 7, ...)`` and ``slstm`` ``(3, ...)``
  stacks unrolled (no tensor allocated);
* ``log_sigmoid``; ``_mlstm_chunked`` (T a multiple of the chunk, off it,
  and from a state); ``mlstm_block`` / ``_prefill`` / ``_decode`` and
  ``_slstm_scan``, ``slstm_block`` / ``_prefill`` / ``_decode``, digital,
  ideal and SMWA;
* ``xlstm_logits`` and the ``xlstm_loss`` forward value at T = 21 (the
  padded chunk path); ``Arch.prefill`` of 21 tokens and 4 decode steps,
  logits and every cache leaf; prefill + decode equal the teacher-forced
  forward within 1e-3 (``tests/test_archs_smoke.py``);
* routed GEMMs: 7 an mLSTM layer (``up``, ``wq``, ``wk``, ``wv``, ``wi``,
  ``wf``, ``down``), 2 an sLSTM layer (``wx``, ``down``) + the head, per
  forward and per decode step (154 at FULL), no layer fold (the reference
  passes no ``layer=``), and prepack's site names equal the call-time
  ones;
* a reference checkpoint (the doubly stacked ``mlstm``, the stacked
  ``slstm``) restores into the port bit for bit; ``cache_def`` describes
  the prefill cache and gives ``LegacyEngine`` each leaf's batch axis;
  ``serve.Engine`` → ``LegacyEngine`` tokens, greedy and at temperature
  0.8, equal the reference's ``serve.Engine``'s.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.core.dpu import DPUConfig as JDPU  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import xlstm as jxl  # noqa: E402
from repro.models.common import P as JP  # noqa: E402
from repro.models.common import init_tree  # noqa: E402
from repro.noise.channel import build_channel_model as jbuild  # noqa: E402
from repro.photonic.engine import PhotonicEngine as JEngine  # noqa: E402
from repro.runtime import serve as jserve  # noqa: E402
from repro_torch._tree import tree_items, tree_map  # noqa: E402
from repro_torch.checkpoint import ckpt as tckpt  # noqa: E402
from repro_torch.core.dpu import DPUConfig as TDPU  # noqa: E402
from repro_torch.core.dpu import quant_scale  # noqa: E402
from repro_torch.models import common as tcm  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models import xlstm as txl  # noqa: E402
from repro_torch.models.common import P as TP  # noqa: E402
from repro_torch.noise.channel import build_channel_model as tbuild  # noqa: E402
from repro_torch.photonic.engine import PhotonicEngine as TEngine  # noqa: E402
from repro_torch.photonic.packing import _is_dense_def, site_name  # noqa: E402
from repro_torch.runtime import serve as tserve  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

NAME = "xlstm-350m"
JA, TA = jreg.get(NAME), treg.get(NAME)
DTYPE = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
MODES = pytest.mark.parametrize("photonic", [False, True], ids=["digital", "ideal-photonic"])
CHANNELS = pytest.mark.parametrize("photonic", [False, True, "smwa"], ids=["digital", "ideal-photonic", "smwa-seeded"])
B, T, T_PRE = 2, 25, 21  # T_PRE: a prompt off the smoke chunk (16), so prefill pads


def _cfgs(photonic, **kw):
    jc = dataclasses.replace(JA.smoke_config, remat=False, **kw)
    tc = dataclasses.replace(TA.smoke_config, **kw)
    if photonic == "smwa":
        # Under noise each backend draws its own stream: the port's ref against the reference's ref.
        jc = dataclasses.replace(jc, photonic=JDPU(organization="SMWA", bits=4, dpe_size=16, noise_seed=5,
                                                   channel=jbuild("SMWA", n=16, bits=4)), photonic_backend="ref")
        tc = dataclasses.replace(tc, photonic=TDPU(organization="SMWA", bits=4, dpe_size=16, noise_seed=5,
                                                   channel=tbuild("SMWA", n=16, bits=4)), photonic_backend="ref")
    elif photonic:
        jc = dataclasses.replace(jc, photonic=JDPU(organization="SMWA", bits=4, dpe_size=16), photonic_backend="ref")
        tc = dataclasses.replace(tc, photonic=TDPU(organization="SMWA", bits=4, dpe_size=16),
                                 photonic_backend="kernel")
    return jc, tc


@pytest.fixture(scope="module")
def params():
    """The reference's smoke weights, jitted, with the mLSTM gates ``wi``
    / ``wf`` given seeded fan-in normals (module docstring): ``(jax tree,
    numpy tree)``."""
    jp = jax.jit(lambda k: init_tree(JA.param_defs(JA.smoke_config), k, jnp.float32))(jax.random.PRNGKey(0))
    npt = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(11)
    mlstm = dict(npt["mlstm"])
    for gate in ("wi", "wf"):
        w = mlstm[gate]["w"]
        mlstm[gate] = {"w": (rng.normal(size=w.shape) / np.sqrt(w.shape[-2])).astype(np.float32)}
    npt = dict(npt, mlstm=mlstm)
    return jax.tree.map(jnp.asarray, npt), npt


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), atol=tol, rtol=tol)


def _noisy_tier(got, want):
    """Noisy outputs: within 1e-5 except at <= 1% of elements (a psum one
    LSB apart), those within 1e-2 of the output's max."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    off = np.abs(got - want) > 1e-5 + 1e-5 * np.abs(want)
    assert off.mean() <= 0.01, off.mean()
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


def _recurrent_noisy_tier(got, want):
    """The sLSTM under noise: a psum one LSB apart enters the recurrence
    and reaches every later step of its head, so the element count of the
    noisy tier does not apply; every element within 1e-2 of the output's
    max."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


def _check(photonic):
    return _noisy_tier if photonic == "smwa" else _close


def _model_tier(got, want, quantized, logits=True):
    """1e-3 without quantization; on the ideal channel 1e-3, or, after a
    quantization flip (module docstring), on logits max |d| <= 2e-2 of max
    |want| and argmax agreement >= 0.9, on a cache leaf max |d| <= 5e-2 of
    max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if not quantized or np.allclose(got, want, atol=1e-3, rtol=1e-3):
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)
        return
    assert np.abs(got - want).max() <= (2e-2 if logits else 5e-2) * np.abs(want).max()
    if logits:
        assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.9


def _tokens(seed, n=T):
    rng = np.random.default_rng(seed)
    return rng.integers(0, TA.smoke_config.vocab_size, (B, n)).astype(np.int32)


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a).long() if a.dtype == np.int32 else torch.from_numpy(np.array(a))


def test_configs_match_reference_field_for_field():
    for jc, tc in ((JA.config, TA.config), (JA.smoke_config, TA.smoke_config)):
        for f in dataclasses.fields(tc):
            if f.name == "photonic_backend":
                continue
            jv, tv = getattr(jc, f.name), getattr(tc, f.name)
            assert (DTYPE[jv] == tv) if jv in DTYPE else jv == tv, f.name
    assert TA.skip_shapes == JA.skip_shapes and TA.notes == JA.notes and TA.family == JA.family == "ssm"


def _def_leaves(tree, stacks, path=()):
    """{path: (shape, init, dtype)} of a def tree; under a key in
    ``stacks`` the reference's leading stack axes become path indices."""
    out = {}
    if isinstance(tree, (JP, TP)):
        depth = stacks.get(path[0], 0) if path else 0
        lead, shape = tree.shape[:depth], tree.shape[depth:]
        for idx in np.ndindex(*lead):
            out[(path[0], *idx, *path[1:])] = (shape, tree.init, tree.dtype)
        return out
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(tree, list):  # the port's list: its index follows the stack key
            out.update({(p[0], k, *p[1:]): s for p, s in _def_leaves(v, stacks, path).items()})
        else:
            out.update(_def_leaves(v, stacks, path + (k,)))
    return out


def test_param_defs_of_full_match_reference_leaf_for_leaf():
    """``param_defs(FULL)`` (3 groups of 7 mLSTM + 1 sLSTM layers) against
    the reference's defs, whose ``mlstm`` stacks ``(3, 7, ...)`` and
    ``slstm`` ``(3, ...)``: the same leaves, shapes, inits and dtype
    overrides, without allocating a tensor."""
    want = _def_leaves(JA.param_defs(JA.config), {"mlstm": 2, "slstm": 1})
    got = _def_leaves(TA.param_defs(TA.config), {})
    assert got == want
    assert len([k for k in got if k[0] == "mlstm" and k[-2:] == ("wq", "w")]) == 21
    assert got[("mlstm", 2, 6, "wi", "w")] == ((2048, 4), "zeros", None)
    assert got[("slstm", 2, "wx", "w")][0] == (1024, 4096)


def test_log_sigmoid_matches_jax():
    """Within 2 f32 ulps of ``jax.nn.log_sigmoid`` over |x| <= 100, or
    within the least normal f32 where XLA flushes a subnormal result to
    zero; NaN and inf passed through as there."""
    x = np.concatenate([np.linspace(-100, 100, 4001), [-30.5, -20.0, 20.0, 30.5, 0.0, np.inf, -np.inf, np.nan]])
    x = x.astype(np.float32)
    want = np.asarray(jax.nn.log_sigmoid(jnp.asarray(x)))
    got = tcm.log_sigmoid(torch.from_numpy(x)).numpy()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~fin & ~np.isnan(want)], want[~fin & ~np.isnan(want)])
    ulp = np.spacing(np.abs(want[fin])) + np.finfo(np.float32).tiny
    assert (np.abs(got[fin] - want[fin]) <= 2 * ulp).all()


def _mlstm_inputs(t, seed):
    cfg = TA.smoke_config
    h, dh = cfg.num_heads, txl._dh(cfg)
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, t, h, dh)).astype(np.float32) for _ in range(3))
    li = rng.normal(size=(B, t, h)).astype(np.float32)
    lf = np.asarray(jax.nn.log_sigmoid(rng.normal(size=(B, t, h)).astype(np.float32) + 2.0))
    state = (rng.normal(size=(B, h, dh, dh)).astype(np.float32), rng.normal(size=(B, h, dh)).astype(np.float32),
             rng.normal(size=(B, h)).astype(np.float32))
    return (q, k, v, li, lf), state


@pytest.mark.parametrize("t,from_state", [(16, False), (21, False), (40, True)], ids=["T16", "T21-padded", "T40-state"])
def test_mlstm_chunked_matches_reference(t, from_state):
    """``_mlstm_chunked`` at chunk 16 (one chunk; two with ``li`` padded
    by -1e30; three from a state): h and the final (C, n, m) within
    1e-5."""
    args, state = _mlstm_inputs(t, t)
    chunk = TA.smoke_config.ssm_chunk
    js = tuple(map(jnp.asarray, state)) if from_state else None
    jh, (jc_, jn, jm) = jax.jit(lambda *a: jxl._mlstm_chunked(*a, chunk, state=js))(*args)
    th, tst = txl._mlstm_chunked(*(torch.from_numpy(np.array(a)) for a in args), chunk,
                                 state=tuple(map(torch.from_numpy, state)) if from_state else None)
    assert tuple(th.shape) == (B, t, *args[0].shape[2:]) and th.dtype == torch.float32
    _close(th.numpy(), jh)
    for got, want in zip(tst, (jc_, jn, jm)):
        _close(got.numpy(), want)


def _mlayer(params, g=1, i=0):
    return tuple(jax.tree.map(lambda a: a[g, i], p["mlstm"]) for p in params)


def _slayer(params, g=1):
    return tuple(jax.tree.map(lambda a: a[g], p["slstm"]) for p in params)


@CHANNELS
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_prefill_and_decode_match_reference(params, photonic, kind):
    """One mLSTM (or sLSTM) layer: ``*_block`` and ``*_prefill`` over 21
    tokens (the padded chunk path for the mLSTM), then 3 ``*_decode`` steps
    from the prefill state: outputs and every state leaf."""
    jc, tc = _cfgs(photonic)
    jp, npl = _mlayer(params) if kind == "mlstm" else _slayer(params)
    tp = params_from_jax(npl, tc, "cpu")
    jmod = {"block": getattr(jxl, f"{kind}_block"), "prefill": getattr(jxl, f"{kind}_prefill"),
            "decode": getattr(jxl, f"{kind}_decode")}
    tmod = {k: getattr(txl, f"{kind}_{k}") for k in jmod}
    check = _check(photonic)
    if kind == "slstm":  # the recurrence (module docstring)
        check = _recurrent_noisy_tier if photonic == "smwa" else lambda got, want: _close(got, want, 1e-4)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, T_PRE + 3, tc.d_model)).astype(np.float32)
    want_blk = jax.jit(lambda p, x: jmod["block"](p, x, jc))(jp, x[:, :T_PRE])
    want, jst = jax.jit(lambda p, x: jmod["prefill"](p, x, jc))(jp, x[:, :T_PRE])
    jdec = jax.jit(lambda p, x, s: jmod["decode"](p, x, s, jc))
    with torch.no_grad():
        got_blk = tmod["block"](tp, torch.from_numpy(x[:, :T_PRE]), tc)
        got, tst = tmod["prefill"](tp, torch.from_numpy(x[:, :T_PRE]), tc)
    check(got_blk.numpy(), want_blk)
    check(got.numpy(), want)
    assert {k: tuple(v.shape) for k, v in tst.items()} == {k: v.shape for k, v in jst.items()}
    for k in tst:
        check(tst[k].numpy(), jst[k])
    for i in range(T_PRE, T_PRE + 3):
        want, jst = jdec(jp, x[:, i: i + 1], jst)
        with torch.no_grad():
            got, tst = tmod["decode"](tp, torch.from_numpy(x[:, i: i + 1]), tst, tc)
        check(got.numpy(), want)
        for k in tst:
            check(tst[k].numpy(), jst[k])


def test_slstm_scan_matches_reference(params):
    """``_slstm_scan`` from the zero state and from a random one, 21
    steps, gates split ``i, f, z, o``: h and (c, n, m, h) within 1e-5."""
    jp, npl = _slayer(params)
    tc = TA.smoke_config
    d = tc.d_model
    tp = params_from_jax(npl, tc, "cpu")
    rng = np.random.default_rng(4)
    gx = rng.normal(size=(B, T_PRE, 4 * d)).astype(np.float32)
    rand = (rng.normal(size=(B, d)), np.abs(rng.normal(size=(B, d))) + 0.1, rng.normal(size=(B, d)),
            rng.normal(size=(B, d)))
    for state in (None, tuple(a.astype(np.float32) for a in rand)):
        if state is None:
            jst = jxl._slstm_init_state(B, d)
            tst = txl._slstm_init_state(B, d, "cpu")
        else:
            jst, tst = tuple(map(jnp.asarray, state)), tuple(map(torch.from_numpy, state))
        jh, jout = jax.jit(lambda p, g, s: jxl._slstm_scan(p, g, tc, s))(jp, gx, jst)
        th, tout = txl._slstm_scan(tp, torch.from_numpy(gx), tc, tst)
        _close(th.numpy(), jh)
        for got, want in zip(tout, jout):
            _close(got.numpy(), want)


@pytest.mark.parametrize("channel", ["ideal", "smwa"])
def test_gate_gemm_at_four_columns_twin_matches_pallas(channel):
    """The mLSTM gates' full-width GEMM, K = 2048 x C = 4 (``wi`` / ``wf``
    at xlstm-350m: nearly the whole column tile is padding), R = 4: the
    port's kernel twin against the reference's Pallas kernel in interpret
    mode.  Ideal: bitwise.  SMWA (``noise_seed``, N = 64): psums (output
    over ``x_scale * w_scale``) one LSB apart at <= 1% of elements, each
    by at most 512."""
    rng = np.random.default_rng(12)
    x = rng.normal(size=(4, 2048)).astype(np.float32)
    w = (rng.normal(size=(2048, 4)) / np.sqrt(2048)).astype(np.float32)
    if channel == "ideal":
        jd, td = JDPU(organization="SMWA", bits=4, dpe_size=64), TDPU(organization="SMWA", bits=4, dpe_size=64)
    else:
        jd = JDPU(organization="SMWA", bits=4, dpe_size=64, channel=jbuild("SMWA", n=64, bits=4), noise_seed=3)
        td = TDPU(organization="SMWA", bits=4, dpe_size=64, channel=tbuild("SMWA", n=64, bits=4), noise_seed=3)
    want = np.asarray(JEngine(dpu=jd, backend="pallas").matmul_float(jnp.asarray(x), jnp.asarray(w), site="wi"))
    got = TEngine(dpu=td, backend="kernel").matmul_float(torch.from_numpy(x), torch.from_numpy(w), site="wi").numpy()
    assert got.shape == want.shape == (4, 4)
    if channel == "ideal":
        np.testing.assert_array_equal(got, want)
    else:
        sx = quant_scale(torch.from_numpy(x), 8).numpy().astype(np.float64)
        sw = quant_scale(torch.from_numpy(w), 8, axis=-2).numpy().astype(np.float64)
        d = np.abs(np.rint((got.astype(np.float64) - want) / (sx * sw)))
        assert (d > 0).mean() <= 0.01 and d.max() <= 512


@MODES
def test_xlstm_logits_and_loss_match_reference(params, photonic):
    jc, tc = _cfgs(photonic)
    tp = params_from_jax(params[1], tc, "cpu")
    toks = _tokens(3, T_PRE)
    labels = np.roll(toks, -1, axis=1)
    want, _ = jax.jit(lambda p, t: jxl.xlstm_logits(p, t, jc))(params[0], toks)
    want_loss = jax.jit(lambda p, b: JA.loss(p, b, jc))(params[0], {"tokens": toks, "labels": labels})
    with torch.no_grad():
        got, aux = txl.xlstm_logits(tp, _t(toks), tc)
        loss = TA.loss(tp, {"tokens": _t(toks), "labels": _t(labels)}, tc)
    assert tuple(got.shape) == (B, T_PRE, tc.n_vocab) and float(aux) == 0.0
    _model_tier(got.numpy(), want, photonic)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-3 if photonic else 1e-5)
    if not photonic:  # the port no further from an f64 run of the forward than twice the reference
        c64 = dataclasses.replace(tc, param_dtype=torch.float64, compute_dtype=torch.float64)
        with torch.no_grad():
            f64 = txl.xlstm_logits(params_from_jax(params[1], c64, "cpu"), _t(toks), c64)[0].numpy()
        assert np.abs(got.numpy() - f64).max() <= 2 * np.abs(np.asarray(want, np.float64) - f64).max()


@MODES
def test_prefill_and_decode_match_reference(params, photonic):
    """``Arch.prefill`` of 21 tokens, then 4 decode steps: logits and every
    cache leaf (``mlstm`` ``(groups, per, B, ...)``, ``slstm`` ``(groups,
    B, D)``, ``pos``) against the reference's."""
    jc, tc = _cfgs(photonic)
    tp = params_from_jax(params[1], tc, "cpu")
    toks = _tokens(4)
    jl, jcache = jax.jit(lambda p, b: JA.prefill(p, b, jc, T))(params[0], {"tokens": toks[:, :T_PRE]})
    jdec = jax.jit(lambda p, x, c: JA.decode(p, x, c, jc))
    with torch.no_grad():
        tl, tcache = TA.prefill(tp, {"tokens": _t(toks[:, :T_PRE])}, tc, T)
    _model_tier(tl.numpy(), jl, photonic)
    assert set(tcache) == set(jcache) == {"mlstm", "slstm", "pos"}
    for i in range(T_PRE, T):
        jl, jcache = jdec(params[0], toks[:, i: i + 1], jcache)
        with torch.no_grad():
            tl, tcache = TA.decode(tp, _t(toks[:, i: i + 1]), tcache, tc)
        _model_tier(tl.numpy(), jl, photonic)
    assert tcache["pos"] == int(jcache["pos"]) == T
    for part in ("mlstm", "slstm"):
        assert set(tcache[part]) == set(jcache[part])
        for k, v in tcache[part].items():
            assert tuple(v.shape) == jcache[part][k].shape, (part, k)
            _model_tier(v.numpy(), jcache[part][k], photonic, logits=False)


def test_prefill_decode_matches_full_forward(params):
    """Port of the reference's contract (``tests/test_archs_smoke.py``):
    prefill of T - 4 tokens and 4 decode steps equal the teacher-forced
    forward within 1e-3."""
    _, tc = _cfgs(False)
    tp = params_from_jax(params[1], tc, "cpu")
    toks = _t(_tokens(5))
    with torch.no_grad():
        full, _ = txl.xlstm_logits(tp, toks, tc)
        logits, cache = TA.prefill(tp, {"tokens": toks[:, : T - 4]}, tc, T)
        assert tuple(logits.shape) == (B, 1, tc.n_vocab)
        errs = [float((logits[:, 0] - full[:, T - 5]).abs().max())]
        for i in range(T - 4, T):
            logits, cache = TA.decode(tp, toks[:, i: i + 1], cache, tc)
            errs.append(float((logits[:, 0] - full[:, i]).abs().max()))
    assert max(errs) < 1e-3, errs


class _Recorder:
    """Records each engine float GEMM's (site, fold); on the CPU each runs
    the fused kernel's twin."""

    def __init__(self, monkeypatch):
        import repro_torch.photonic.engine as E

        self.calls = []
        inner = E.PhotonicEngine.matmul_float

        def record(eng, x, w, *, site=None, fold=None, **kw):
            self.calls.append((site, fold))
            return inner(eng, x, w, site=site, fold=fold, **kw)

        monkeypatch.setattr(E.PhotonicEngine, "matmul_float", record)


def _launches(cfg):
    """Routed GEMMs a forward or decode step: 7 an mLSTM layer, 2 an
    sLSTM layer, the head."""
    n_groups = cfg.num_layers // cfg.slstm_every
    return 7 * n_groups * (cfg.slstm_every - 1) + 2 * n_groups + 1


def test_routed_gemms_per_forward_and_decode_step(params, monkeypatch):
    _, tc = _cfgs(True)
    tp = params_from_jax(params[1], tc, "cpu")
    rec = _Recorder(monkeypatch)
    toks = _t(_tokens(9))
    with torch.no_grad():
        txl.xlstm_logits(tp, toks[:, :8], tc)
        n_forward = len(rec.calls)
        _, cache = TA.prefill(tp, {"tokens": toks[:, :8]}, tc, T)
        n_prefill = len(rec.calls) - n_forward
        TA.decode(tp, toks[:, 8:9], cache, tc)
    assert n_forward == n_prefill == len(rec.calls) - n_forward - n_prefill == _launches(tc) == 19
    assert _launches(TA.config) == 154
    assert {f for _, f in rec.calls} == {None}
    assert [s for s, _ in rec.calls[:n_forward]].count("wi") == 2


def test_prepack_site_names_agree_with_call_time_sites(params, monkeypatch):
    """Port of the reference's contract (``tests/test_photonic_engine.py``):
    the site names prepack derives from the def tree (the bare leaves, both
    layers' ``down`` alike) equal the ones the forward passes."""
    _, tc = _cfgs(True)

    def derived(d, path=()):
        if _is_dense_def(d):
            return {site_name(path)}
        items = d.items() if isinstance(d, dict) else enumerate(d) if isinstance(d, list) else ()
        return set().union(*[derived(v, path + (k,)) for k, v in items])

    rec = _Recorder(monkeypatch)
    with torch.no_grad():
        txl.xlstm_logits(params_from_jax(params[1], tc, "cpu"), _t(_tokens(10, 8)), tc)
    assert derived(TA.param_defs(tc)) == {s for s, _ in rec.calls} == {
        "up", "wq", "wk", "wv", "wi", "wf", "down", "wx", "lm_head"}


def test_reference_checkpoint_of_the_xlstm_restores_bitwise(params, tmp_path):
    """The reference's ``ckpt.save`` of the smoke params (``mlstm``
    stacked ``(groups, per, ...)``, ``slstm`` ``(groups, ...)``) restores
    into the port's lists bit for bit, and the port's own save
    round-trips."""
    _, tc = _cfgs(False)
    jckpt.save(tmp_path / "ref", 3, {"params": params[0]})
    want = params_from_jax(params[1], tc, "cpu")
    assert len(want["mlstm"]) == 2 and len(want["mlstm"][0]) == 1 and len(want["slstm"]) == 2
    like = tree_map(torch.zeros_like, want)
    back = tckpt.restore(tmp_path / "ref", 3, {"params": like})["params"]
    tckpt.save(tmp_path / "port", 4, {"params": want})
    again = tckpt.restore(tmp_path / "port", 4, {"params": like})["params"]
    assert tree_items(back).keys() == tree_items(want).keys()
    for k, a in tree_items(want).items():
        assert torch.equal(tree_items(back)[k], a) and torch.equal(tree_items(again)[k], a), k
    names = tree_items({"params": back})
    assert "params/mlstm/1/0/wq/w" in names and "params/slstm/1/r" in names
    np.testing.assert_array_equal(names["params/mlstm/1/0/wi/w"].numpy(), params[1]["mlstm"]["wi"]["w"][1, 0])


def test_cache_def_describes_the_prefill_cache_and_its_batch_axes(params):
    _, tc = _cfgs(False)
    tp = params_from_jax(params[1], tc, "cpu")
    with torch.no_grad():
        _, cache = TA.prefill(tp, {"tokens": _t(_tokens(11, 8))}, tc, T)
    cdef = TA.cache_def(tc, B, T, {}, torch.float32)
    for part in ("mlstm", "slstm"):
        assert {k: tuple(v.shape) for k, v in cache[part].items()} == {k: v[0] for k, v in cdef[part].items()}
        assert {k: v.dtype for k, v in cache[part].items()} == {k: v[2] for k, v in cdef[part].items()}
    assert cdef["pos"][0] == () and cache["pos"] == 8
    assert tserve._batch_axes(cdef) == {
        "mlstm": {"C": 2, "n": 2, "m": 2}, "slstm": {"c": 1, "n": 1, "m": 1, "h": 1}, "pos": None}


# The reference's prefill jitted (its decode already is): one program a
# prompt length, shared by both cases, instead of op-by-op compiles.
_JIT_ARCH = dataclasses.replace(JA, prefill=jax.jit(JA.prefill, static_argnums=(2, 3)))


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "t0.8"])
def test_legacy_engine_tokens_match_reference(params, greedy):
    """``serve.Engine`` routes the family to ``LegacyEngine``; its tokens
    on the ideal channel, greedy and sampled at temperature 0.8 under the
    reference's keys, equal the reference's ``serve.Engine``'s, with
    prompts of 5, 8 and 6 tokens over 2 slots (the third admitted into a
    live batch)."""
    jc, tc = _cfgs(True)
    tp = params_from_jax(params[1], tc, "cpu")
    rng = np.random.default_rng(42)
    prompts = [rng.integers(0, tc.vocab_size, n).astype(np.int32) for n in (5, 8, 6)]
    kw = dict(batch_size=2, max_seq=20, greedy=greedy, temperature=0.8, seed=0)
    je = jserve.Engine(_JIT_ARCH, jc, params[0], jserve.ServeConfig(**kw))
    jr = [jserve.Request(uid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
    je.run(jr)
    te = tserve.Engine(TA, tc, tp, tserve.ServeConfig(**kw), device="cpu")
    assert isinstance(te.impl, tserve.LegacyEngine)
    tr = [tserve.Request(uid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
    te.run(tr)
    for a, b in zip(jr, tr):
        assert b.done and len(b.output) == 4 and a.output == b.output, (a.output, b.output)
