"""The port's hybrid family (Zamba2: a Mamba2 backbone with one
weight-shared attention block) against the reference, at zamba2-2.7b's
smoke config (4 Mamba2 layers in 2 groups, d 64, 8 SSD heads of 16, state
8, chunk 16; the shared block 4/4 heads of 16) with the reference's
weights carried over (``params_from_jax``).

Tolerances, each stated where it is used:

* functions, digitally and on the ideal channel (the port's kernel twin
  against the reference's ``ref``, both exact): ``atol=1e-5, rtol=1e-5``
  (f32 ``cumsum`` and three-operand ``einsum`` sum in other orders);
  ``_causal_conv`` at ``1e-6`` (the same products and sums, which XLA may
  contract into FMAs); ``softplus`` within 2 f32 ulps of JAX's over
  ``|x| <= 100`` (``exp`` / ``log1p`` of two libraries; XLA flushes
  subnormal results to zero), NaN and inf passed through;
* functions on the SMWA channel seeded (``noise_seed``): both packages on
  their ``ref`` backend, whose Box-Muller draws are ulp-close (the twin
  draws the Pallas kernel's stream, held against it GEMM by GEMM in
  ``tests/test_torch_photonic_gemm.py``; the reference's interpret-mode
  kernel compiles for seconds a call): the noisy tier, a psum one LSB
  apart at <= 1% of elements, each within 1e-2 of the output's max.  A
  whole noisy model is not compared: a GEMM's noise stream hashes its int8
  operands, so after one flip the two sides draw unrelated noise;
* whole models: digitally ``atol=rtol=1e-4`` (the float differences above,
  carried through 4 Mamba2 layers and 2 shared blocks); on the ideal
  channel the same, or, after a quantization flip (an f32 activation
  within an ulp of an int8 rounding boundary takes the next code on one
  side), the chip's bf16 floor: max |d| <= 2e-2 of the max magnitude and
  argmax agreement >= 0.9 on logits.

Held here:

* ``FULL`` and ``SMOKE`` equal the reference's field for field, and
  ``param_defs(FULL)`` equals the reference's leaf for leaf in shape, init
  and dtype, its ``(n_groups, attn_every, ...)`` stack unrolled (no
  tensor allocated);
* ``softplus``; ``_causal_conv``; ``_ssd_chunked`` against the reference's
  ``_ssd_chunked`` and against both packages' ``ssd_reference`` (T a
  multiple of the chunk, off it, and from an initial state);
  ``mamba_block`` / ``mamba_prefill`` / ``mamba_decode`` digital, ideal
  and SMWA;
* ``zamba2_logits`` and the ``zamba2_loss`` forward value at T = 21 (the
  padded chunk path); ``Arch.prefill`` of 21 tokens and 4 decode steps,
  logits and every cache leaf; prefill + decode equal the teacher-forced
  forward within 1e-3 (``tests/test_archs_smoke.py``); the int8 KV cache
  close to f32 (``tests/test_quantized_serving.py``) and equal to the
  reference's int8 run; ``attn_impl="flash"`` at the smoke head dim 16
  (the twin against the reference's Pallas kernel in interpret mode), and
  the CUDA wrapper's zero-padding of a head dim between its templates;
* routed GEMMs: 2 a Mamba2 layer and 6 a shared-block invocation + the
  head, per forward and per decode step (163 at FULL), no layer fold (the
  reference passes no ``layer=``), and prepack's site names equal the
  call-time ones (``in_proj``, ``out_proj``, ``attn.*``, ``ffn.*``);
* a reference checkpoint (the doubly stacked ``mamba``, the unstacked
  ``shared``) restores into the port bit for bit; ``cache_def`` describes
  the prefill cache and gives ``LegacyEngine`` each leaf's batch axis;
  ``serve.Engine`` → ``LegacyEngine`` tokens, greedy and at temperature
  0.8, equal the reference's ``serve.Engine``'s (prompts of different
  lengths: the later ones' shared attention decodes at the first prompt's
  ``pos``, a known limitation of the reference that the port keeps).
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
from repro.models import ssm as jssm  # noqa: E402
from repro.models import zamba2 as jzb  # noqa: E402
from repro.models.common import P as JP  # noqa: E402
from repro.models.common import init_tree  # noqa: E402
from repro.noise.channel import build_channel_model as jbuild  # noqa: E402
from repro.runtime import serve as jserve  # noqa: E402
from repro_torch._tree import tree_items, tree_map  # noqa: E402
from repro_torch.checkpoint import ckpt as tckpt  # noqa: E402
from repro_torch.core.dpu import DPUConfig as TDPU  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as tflash  # noqa: E402
from repro_torch.models import common as tcm  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import zamba2 as tzb  # noqa: E402
from repro_torch.models.common import P as TP  # noqa: E402
from repro_torch.noise.channel import build_channel_model as tbuild  # noqa: E402
from repro_torch.photonic.packing import _is_dense_def, site_name  # noqa: E402
from repro_torch.runtime import serve as tserve  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

NAME = "zamba2-2.7b"
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
    """The reference's smoke weights, jitted, with seeded normals for
    ``conv_b``, ``a_log`` and ``dt_bias`` (zeros at init; the SSD's
    per-head decay and step are then all alike): ``(jax tree, numpy
    tree)``."""
    jp = jax.jit(lambda k: init_tree(JA.param_defs(JA.smoke_config), k, jnp.float32))(jax.random.PRNGKey(0))
    npt = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(11)
    mamba = dict(npt["mamba"])
    for leaf in ("conv_b", "a_log", "dt_bias"):
        mamba[leaf] = (0.5 * rng.normal(size=mamba[leaf].shape)).astype(np.float32)
    npt = dict(npt, mamba=mamba)
    return jax.tree.map(jnp.asarray, npt), npt


def _layer(params, g=1, i=0):
    """Mamba2 layer (g, i) of the doubly stacked tree: (jax, numpy)."""
    return tuple(jax.tree.map(lambda a: a[g, i], p["mamba"]) for p in params)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), atol=tol, rtol=tol)


def _noisy_tier(got, want):
    """Noisy outputs: within 1e-5 except at <= 1% of elements (a psum one
    LSB apart), those within 1e-2 of the output's max."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    off = np.abs(got - want) > 1e-5 + 1e-5 * np.abs(want)
    assert off.mean() <= 0.01, off.mean()
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


def _check(photonic):
    return _noisy_tier if photonic == "smwa" else _close


def _model_tier(got, want, quantized, logits=True):
    """1e-4 without quantization; with it (the ideal channel, the int8 KV
    cache) 1e-4, or, after a quantization flip (module docstring), max |d|
    <= 2e-2 of max |want| and, on logits, argmax agreement >= 0.9."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if not quantized or np.allclose(got, want, atol=1e-4, rtol=1e-4):
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
        return
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
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
    assert TA.skip_shapes == JA.skip_shapes and TA.notes == JA.notes and TA.family == JA.family == "hybrid"


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
    """``param_defs(FULL)`` (54 Mamba2 layers in 9 groups, the shared
    block) against the reference's defs, whose ``mamba`` stacks
    ``(9, 6, ...)``: the same leaves, shapes, inits and dtype overrides,
    without allocating a tensor."""
    want = _def_leaves(JA.param_defs(JA.config), {"mamba": 2})
    got = _def_leaves(TA.param_defs(TA.config), {})
    assert got == want
    assert len([k for k in got if k[0] == "mamba" and k[-1] == "w" and k[-2] == "in_proj"]) == 54
    assert got[("mamba", 8, 5, "in_proj", "w")][0] == (2560, 10448)
    assert got[("shared", "attn", "wq", "w")][0] == (2560, 2560)


def test_softplus_matches_jax():
    """Within 2 f32 ulps of ``jax.nn.softplus`` over |x| <= 100 (where
    ``F.softplus`` returns x itself above 20, and JAX does not), or within
    the least normal f32 where XLA flushes a subnormal result to zero; NaN
    and inf passed through as there."""
    x = np.concatenate([np.linspace(-100, 100, 4001), [-30.5, -20.0, 20.0, 30.5, 0.0, np.inf, -np.inf, np.nan]])
    x = x.astype(np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = tcm.softplus(torch.from_numpy(x)).numpy()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~fin & ~np.isnan(want)], want[~fin & ~np.isnan(want)])
    # XLA flushes subnormal results to zero (x < -87 here); torch keeps them.
    ulp = np.spacing(np.abs(want[fin])) + np.finfo(np.float32).tiny
    assert (np.abs(got[fin] - want[fin]) <= 2 * ulp).all()


def test_causal_conv_matches_reference(params):
    """``_causal_conv`` (the prefill spelling), within 1e-6."""
    jp, npl = _layer(params)
    tc = TA.smoke_config
    rng = np.random.default_rng(1)
    xbc = rng.normal(size=(B, 9, npl["conv_w"].shape[1])).astype(np.float32)
    want = jax.jit(jssm._causal_conv)(jp, jnp.asarray(xbc))
    got = tssm._causal_conv(params_from_jax(npl, tc, "cpu"), torch.from_numpy(xbc))
    _close(got.numpy(), want, 1e-6)


def _ssd_inputs(t, seed):
    cfg = TA.smoke_config
    h, dh, st = tssm._nheads(cfg), cfg.ssm_head_dim, cfg.ssm_state_size
    rng = np.random.default_rng(seed)
    xh = rng.normal(size=(B, t, h, dh)).astype(np.float32)
    bm = rng.normal(size=(B, t, st)).astype(np.float32)
    cm_ = rng.normal(size=(B, t, st)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, t, h)))).astype(np.float32)
    a_log = (0.5 * rng.normal(size=(h,))).astype(np.float32)
    s0 = rng.normal(size=(B, h, dh, st)).astype(np.float32)
    return xh, bm, cm_, dt, a_log, s0


@pytest.mark.parametrize("t,from_state", [(16, False), (21, False), (40, True)], ids=["T16", "T21-padded", "T40-s0"])
def test_ssd_chunked_matches_reference_and_the_oracle(t, from_state):
    """``_ssd_chunked`` at chunk 16 against the reference's (y and the
    final state, within 1e-5) and against both packages' step-by-step
    ``ssd_reference`` (within 1e-4: the chunked and the stepwise sums
    differ in order and in the exp of differences), and the two oracles
    against each other (1e-5)."""
    xh, bm, cm_, dt, a_log, s0 = _ssd_inputs(t, t)
    s0 = s0 if from_state else None
    chunk = TA.smoke_config.ssm_chunk
    jy, js = jax.jit(lambda *a: jssm._ssd_chunked(*a, chunk, s0=None if s0 is None else jnp.asarray(s0)))(
        xh, bm, cm_, dt, a_log)
    ty, ts = tssm._ssd_chunked(*map(torch.from_numpy, (xh, bm, cm_, dt, a_log)), chunk,
                               s0=None if s0 is None else torch.from_numpy(s0))
    assert tuple(ty.shape) == (B, t, *xh.shape[2:]) and ty.dtype == torch.float32
    _close(ty.numpy(), jy)
    _close(ts.numpy(), js)
    if s0 is None:
        oy, os_ = jax.jit(jssm.ssd_reference)(xh, bm, cm_, dt, a_log)
        py, ps = tssm.ssd_reference(*map(torch.from_numpy, (xh, bm, cm_, dt, a_log)))
        _close(py.numpy(), oy)
        _close(ps.numpy(), os_)
        _close(ty.numpy(), oy, 1e-4)
        _close(ts.numpy(), os_, 1e-4)


@CHANNELS
def test_mamba_block_prefill_and_decode_match_reference(params, photonic):
    """One Mamba2 layer: ``mamba_block`` and ``mamba_prefill`` over 21
    tokens (the padded chunk path), then 3 ``mamba_decode`` steps from the
    prefill state: outputs and every state leaf."""
    jc, tc = _cfgs(photonic)
    jp, npl = _layer(params)
    tp = params_from_jax(npl, tc, "cpu")
    check = _check(photonic)
    steps = 3
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, T_PRE + steps, tc.d_model)).astype(np.float32)
    want_blk = jax.jit(lambda p, x: jssm.mamba_block(p, x, jc))(jp, x[:, :T_PRE])
    want, jst = jax.jit(lambda p, x: jssm.mamba_prefill(p, x, jc))(jp, x[:, :T_PRE])
    jdec = jax.jit(lambda p, x, s: jssm.mamba_decode(p, x, s, jc))
    with torch.no_grad():
        got_blk = tssm.mamba_block(tp, torch.from_numpy(x[:, :T_PRE]), tc)
        got, tst = tssm.mamba_prefill(tp, torch.from_numpy(x[:, :T_PRE]), tc)
    check(got_blk.numpy(), want_blk)
    check(got.numpy(), want)
    assert {k: tuple(v.shape) for k, v in tst.items()} == {k: v.shape for k, v in jst.items()}
    for k in ("ssm", "conv"):
        check(tst[k].numpy(), jst[k])
    for i in range(T_PRE, T_PRE + steps):
        want, jst = jdec(jp, x[:, i: i + 1], jst)
        with torch.no_grad():
            got, tst = tssm.mamba_decode(tp, torch.from_numpy(x[:, i: i + 1]), tst, tc)
        check(got.numpy(), want)
        for k in ("ssm", "conv"):
            check(tst[k].numpy(), jst[k])


@MODES
def test_zamba2_logits_and_loss_match_reference(params, photonic):
    jc, tc = _cfgs(photonic)
    tp = params_from_jax(params[1], tc, "cpu")
    toks = _tokens(3, T_PRE)
    labels = np.roll(toks, -1, axis=1)
    want, _ = jax.jit(lambda p, t: jzb.zamba2_logits(p, t, jc))(params[0], toks)
    want_loss = jax.jit(lambda p, b: JA.loss(p, b, jc))(params[0], {"tokens": toks, "labels": labels})
    with torch.no_grad():
        got, aux = tzb.zamba2_logits(tp, _t(toks), tc)
        loss = TA.loss(tp, {"tokens": _t(toks), "labels": _t(labels)}, tc)
    assert tuple(got.shape) == (B, T_PRE, tc.n_vocab) and float(aux) == 0.0
    _model_tier(got.numpy(), want, photonic)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-3 if photonic else 1e-5)


@MODES
def test_prefill_and_decode_match_reference(params, photonic):
    """``Arch.prefill`` of 21 tokens, then 4 decode steps: logits and every
    cache leaf (``mamba`` ``(groups, per, B, ...)``, the shared block's
    ``attn`` K/V ``(groups, B, max_seq, kv, hd)``, ``pos``) against the
    reference's."""
    jc, tc = _cfgs(photonic)
    tp = params_from_jax(params[1], tc, "cpu")
    toks = _tokens(4)
    jl, jcache = jax.jit(lambda p, b: JA.prefill(p, b, jc, T))(params[0], {"tokens": toks[:, :T_PRE]})
    jdec = jax.jit(lambda p, x, c: JA.decode(p, x, c, jc))
    with torch.no_grad():
        tl, tcache = TA.prefill(tp, {"tokens": _t(toks[:, :T_PRE])}, tc, T)
    _model_tier(tl.numpy(), jl, photonic)
    assert set(tcache) == set(jcache) == {"mamba", "attn", "pos"}
    for i in range(T_PRE, T):
        jl, jcache = jdec(params[0], toks[:, i: i + 1], jcache)
        with torch.no_grad():
            tl, tcache = TA.decode(tp, _t(toks[:, i: i + 1]), tcache, tc)
        _model_tier(tl.numpy(), jl, photonic)
    assert tcache["pos"] == int(jcache["pos"]) == T
    for part in ("mamba", "attn"):
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
        full, _ = tzb.zamba2_logits(tp, toks, tc)
        logits, cache = TA.prefill(tp, {"tokens": toks[:, : T - 4]}, tc, T)
        assert tuple(logits.shape) == (B, 1, tc.n_vocab)
        errs = [float((logits[:, 0] - full[:, T - 5]).abs().max())]
        for i in range(T - 4, T):
            logits, cache = TA.decode(tp, toks[:, i: i + 1], cache, tc)
            errs.append(float((logits[:, 0] - full[:, i]).abs().max()))
    assert max(errs) < 1e-3, errs


def _roundtrip(arch, params, cfg, toks, jit=lambda f: f):
    prefill = jit(lambda p, t: arch.prefill(p, {"tokens": t}, cfg, T))
    decode = jit(lambda p, x, c: arch.decode(p, x, c, cfg))
    logits, cache = prefill(params, toks[:, : T - 4])
    outs = [logits]
    for i in range(T - 4, T):
        logits, cache = decode(params, toks[:, i: i + 1], cache)
        outs.append(logits)
    return outs


def test_int8_kv_cache_close_to_f32_and_to_the_reference(params):
    """Port of the reference's contract (``tests/test_quantized_serving.py``,
    the zamba2 case): the shared block's int8 KV cache keeps the logits
    within 0.05 relative norm of the float cache's and the argmax on >= 90%
    of positions; and the port's int8 run equals the reference's at the
    model tier with its flip clause: the cache quantizes K/V to int8 codes
    as the ideal channel quantizes a GEMM's input, so one f32 value within
    an ulp of a rounding boundary may take the next code on one side."""
    _, tc = _cfgs(False)
    jc8, tc8 = _cfgs(False, kv_cache_int8=True)
    tp = params_from_jax(params[1], tc, "cpu")
    toks = _tokens(6)
    with torch.no_grad():
        f32 = torch.cat(_roundtrip(TA, tp, tc, _t(toks)), dim=1)
        i8 = torch.cat(_roundtrip(TA, tp, tc8, _t(toks)), dim=1)
        _, cache = TA.prefill(tp, {"tokens": _t(toks[:, :8])}, tc8, T)
    assert cache["attn"]["k"].dtype == torch.int8 and cache["mamba"]["ssm"].dtype == torch.float32
    rel = float(torch.linalg.norm(i8 - f32) / torch.linalg.norm(f32))
    agree = float((i8.argmax(-1) == f32.argmax(-1)).float().mean())
    assert rel < 0.05 and agree >= 0.9, (rel, agree)
    want = jnp.concatenate(_roundtrip(JA, params[0], jc8, toks, jit=jax.jit), axis=1)
    _model_tier(i8.numpy(), want, True)


def test_flash_at_a_head_dim_between_the_templates(params):
    """``attn_impl="flash"`` in the shared block at the smoke head dim 16
    (neither 64 nor 128): the port's twin against the reference's Pallas
    kernel in interpret mode, ``zamba2_logits`` within 1e-4.  The CUDA
    wrapper pads such a head dim with zeros to the next template (80 ->
    128 at FULL) and keeps the caller's scale: on the twin, the padded
    call sliced back equals the unpadded one within 1e-6 (zero columns add
    exact zeros to every score)."""
    jc, tc = _cfgs(False, attn_impl="flash")
    tp = params_from_jax(params[1], tc, "cpu")
    toks = _tokens(7, T_PRE)
    want, _ = jax.jit(lambda p, t: jzb.zamba2_logits(p, t, jc))(params[0], toks)
    with torch.no_grad():
        got, _ = tzb.zamba2_logits(tp, _t(toks), tc)
    _model_tier(got.numpy(), want, False)
    assert [tflash.template_head_dim(h) for h in (16, 64, 80, 128)] == [64, 64, 128, 128]
    with pytest.raises(ValueError, match="up to 128"):
        tflash.template_head_dim(129)
    assert tflash.template_head_dim(TA.config.hd) == 128
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 37, 4, 80)).astype(np.float32)) for _ in range(3))
    args = dict(scale=80**-0.5, causal=True, q_offset=0, kv_valid=37, n_rep=1, bq=40, bk=40)
    plain = tflash.flash_attention_fwd_twin(q, k, v, **args)
    padded = tflash.flash_attention_fwd_twin(*(torch.nn.functional.pad(a, (0, 48)) for a in (q, k, v)), **args)
    assert padded[..., 80:].abs().max() == 0
    torch.testing.assert_close(padded[..., :80], plain, atol=1e-6, rtol=1e-6)


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
    """Routed GEMMs a forward or decode step: 2 a Mamba2 layer, 6 a
    shared-block invocation (q, k, v, o, ffn wi, wo), the head."""
    return 2 * cfg.num_layers + 6 * (cfg.num_layers // cfg.attn_every) + 1


def test_routed_gemms_per_forward_and_decode_step(params, monkeypatch):
    _, tc = _cfgs(True)
    tp = params_from_jax(params[1], tc, "cpu")
    rec = _Recorder(monkeypatch)
    toks = _t(_tokens(9))
    with torch.no_grad():
        tzb.zamba2_logits(tp, toks[:, :8], tc)
        n_forward = len(rec.calls)
        _, cache = TA.prefill(tp, {"tokens": toks[:, :8]}, tc, T)
        n_prefill = len(rec.calls) - n_forward
        TA.decode(tp, toks[:, 8:9], cache, tc)
    assert n_forward == n_prefill == len(rec.calls) - n_forward - n_prefill == _launches(tc) == 21
    assert _launches(TA.config) == 163
    assert {f for _, f in rec.calls} == {None}
    assert [s for s, _ in rec.calls[:n_forward]].count("attn.wq") == 2


def test_prepack_site_names_agree_with_call_time_sites(params, monkeypatch):
    """Port of the reference's contract (``tests/test_photonic_engine.py``):
    the site names prepack derives from the def tree (the shared block's
    under ``attn.`` / ``ffn.``, the Mamba2 layers' bare leaves) equal the
    ones the forward passes."""
    _, tc = _cfgs(True)

    def derived(d, path=()):
        if _is_dense_def(d):
            return {site_name(path)}
        items = d.items() if isinstance(d, dict) else enumerate(d) if isinstance(d, list) else ()
        return set().union(*[derived(v, path + (k,)) for k, v in items])

    rec = _Recorder(monkeypatch)
    with torch.no_grad():
        tzb.zamba2_logits(params_from_jax(params[1], tc, "cpu"), _t(_tokens(10, 8)), tc)
    assert derived(TA.param_defs(tc)) == {s for s, _ in rec.calls} == {
        "in_proj", "out_proj", "attn.wq", "attn.wk", "attn.wv", "attn.wo", "ffn.wi", "ffn.wo", "lm_head"}


def test_reference_checkpoint_of_the_hybrid_restores_bitwise(params, tmp_path):
    """The reference's ``ckpt.save`` of the smoke params (``mamba``
    stacked ``(groups, per, ...)``, ``shared`` unstacked) restores into the
    port's lists of lists bit for bit, and the port's own save
    round-trips."""
    _, tc = _cfgs(False)
    jckpt.save(tmp_path / "ref", 3, {"params": params[0]})
    want = params_from_jax(params[1], tc, "cpu")
    assert len(want["mamba"]) == 2 and len(want["mamba"][0]) == 2 and "attn" in want["shared"]
    like = tree_map(torch.zeros_like, want)
    back = tckpt.restore(tmp_path / "ref", 3, {"params": like})["params"]
    tckpt.save(tmp_path / "port", 4, {"params": want})
    again = tckpt.restore(tmp_path / "port", 4, {"params": like})["params"]
    assert tree_items(back).keys() == tree_items(want).keys()
    for k, a in tree_items(want).items():
        assert torch.equal(tree_items(back)[k], a) and torch.equal(tree_items(again)[k], a), k
    names = tree_items({"params": back})
    assert "params/mamba/1/0/in_proj/w" in names and "params/shared/attn/wq/w" in names
    np.testing.assert_array_equal(names["params/mamba/1/0/a_log"].numpy(), params[1]["mamba"]["a_log"][1, 0])


def test_cache_def_describes_the_prefill_cache_and_its_batch_axes(params):
    _, tc = _cfgs(False)
    tp = params_from_jax(params[1], tc, "cpu")
    with torch.no_grad():
        _, cache = TA.prefill(tp, {"tokens": _t(_tokens(11, 8))}, tc, T)
    cdef = TA.cache_def(tc, B, T, {}, torch.float32)
    for part in ("mamba", "attn"):
        assert {k: tuple(v.shape) for k, v in cache[part].items()} == {k: v[0] for k, v in cdef[part].items()}
        assert {k: v.dtype for k, v in cache[part].items()} == {k: v[2] for k, v in cdef[part].items()}
    assert cdef["pos"][0] == () and cache["pos"] == 8
    assert tserve._batch_axes(cdef) == {"mamba": {"ssm": 2, "conv": 2}, "attn": {"k": 1, "v": 1}, "pos": None}


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
