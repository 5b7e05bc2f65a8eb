"""The photonic GEMM kernels' plain twin against the reference Pallas
kernels (interpret mode), and the port's ``ref``/``exact`` oracles against
the reference's, on the same numpy inputs.

The twin mirrors the reference's logical tiling and noise-stream ids, so:

* int32 outputs are bitwise under the ideal, ADC-only and filter-only
  channels;
* with inter-modulation / cross-weight crosstalk the reference's compiled
  CPU body contracts ``a + eps * dot`` into an FMA (an f64 emulation of
  the FMA reproduces it exactly), while the port keeps the two IEEE ops the
  kernel spec asks for: a psum may round one LSB apart at <= 0.1% of
  elements;
* with detector noise the Box-Muller draws are ulp-close, so a psum may
  round one LSB apart: at most 1% of elements may differ, by at most two
  LSBs of the top slice pass (``2 * 2^(2B)``);
* the f32 epilogue's rescale is bitwise, its bias/activation tail within
  ``1e-5`` relative (FMA contraction in the reference's compiled body).

The CUDA kernels themselves are held to this twin on the card
(``-m cuda`` tests below, and ``chip_smoke.py``).  JAX is imported by the
tests that compare with it (the ``jx`` fixture), and the stages come from
the port's own channel builder, so the ``cuda``-marked tests also run where
JAX is not installed, as on the machine with the card:
``python -m pytest -q -m cuda tests/test_torch_photonic_gemm.py``.

The launch plan (how a call is cut into CTAs and its contraction split
across them) is host code and is checked here on the CPU.
"""

import types

import numpy as np
import pytest
from _hypothesis_compat import given, settings, strategies as hst

torch = pytest.importorskip("torch")

from repro_torch.kernels.photonic_gemm import kernel as tk  # noqa: E402
from repro_torch.kernels.photonic_gemm import ref as tref  # noqa: E402
from repro_torch.noise import channel as tch  # noqa: E402

N = 16  # DPE size of the tests (chunk); tile_k = 2 chunks


@pytest.fixture(scope="module")
def jx():
    """The reference's photonic kernels, oracle and channel builder (JAX on
    the CPU)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels.photonic_gemm import kernel as jk
    from repro.kernels.photonic_gemm import ref as jref
    from repro.noise import channel as jch

    return types.SimpleNamespace(jnp=jnp, jk=jk, jref=jref, jch=jch)


def _stages(name, n=N):
    """Kernel stage kwargs for a named channel at fan-in ``n``."""
    if name == "ideal":
        return dict(n_chunk=128, tile_k=128)
    if name == "adc":
        return dict(n_chunk=n, tile_k=2 * n, adc_bits=7)
    ch = tch.build_channel_model(name.split("_")[0], n=n, bits=4)
    if name.endswith("_det"):  # deterministic: crosstalk + filter only
        ch = ch.disable("detector")
    return dict(
        n_chunk=n, tile_k=2 * n, adc_bits=ch.adc_bits, noise_sigma=ch.detector_sigma_lsb,
        filter_alpha=ch.filter_alpha, intermod_eps=ch.intermod_eps,
        crossweight_eps=ch.crossweight_eps,
    )


CHANNELS = ["ideal", "adc", "SMWA_det", "ASMW_det", "SMWA", "ASMW", "MASW"]


def _operands(seed, r, k, c, kp):
    rng = np.random.default_rng(seed)
    x = np.zeros((r, kp), np.int8)
    x[:, :k] = rng.integers(-127, 128, (r, k))
    w = np.zeros((kp, c), np.int8)
    w[:k] = rng.integers(-127, 128, (k, c))
    return x, w


def _kind(name):
    if name in ("SMWA", "ASMW", "MASW"):
        return "noisy"
    return "fma" if name in ("ASMW_det", "MASW_det") else "bitwise"


def _assert_psums(got, want, kind, bits=4):
    got = np.asarray(got, np.int64)
    want = np.asarray(want, np.int64)
    if kind == "bitwise":
        np.testing.assert_array_equal(got, want)
        return
    d = np.abs(got - want)
    frac = 0.01 if kind == "noisy" else 0.001
    assert (d > 0).mean() <= frac and d.max() <= 2 * 2 ** (2 * bits), (d.max(), (d > 0).mean())


@pytest.mark.parametrize("name", CHANNELS)
def test_int_twin_matches_pallas(jx, name):
    jk, jnp = jx.jk, jx.jnp
    st = _stages(name)
    k = 88  # not a multiple of tile_k: trailing chunks are pure padding
    kp = -(-k // st["tile_k"]) * st["tile_k"]
    x, w = _operands(0, 16, k, 256, kp)
    if st.get("noise_sigma", 0.0) > 0:
        st["valid_chunks"] = -(-k // st["n_chunk"])
    seed = 0x9E3779B9
    want = jk.photonic_gemm_pallas(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray([seed], jnp.uint32).astype(jnp.int32),
        tile_r=8, tile_c=128, interpret=True, **st,
    )
    got = tk.photonic_gemm(torch.from_numpy(x), torch.from_numpy(w), seed, tile_r=8, tile_c=128, **st)
    assert got.dtype == torch.int32
    _assert_psums(got.numpy(), want, _kind(name))


@pytest.mark.parametrize("x_f32", [True, False], ids=["f32-prologue", "int8"])
@pytest.mark.parametrize("tail", [(False, None), (True, None), (True, "gelu"), (False, "silu")],
                         ids=["rescale", "bias", "bias-gelu", "silu"])
@pytest.mark.parametrize("name", ["ideal", "SMWA"])
def test_fused_twin_matches_pallas(jx, name, tail, x_f32):
    jk, jnp = jx.jk, jx.jnp
    with_bias, act = tail
    st = _stages(name)
    k = 72
    kp = -(-k // st["tile_k"]) * st["tile_k"]
    rng = np.random.default_rng(1)
    noisy = st.get("noise_sigma", 0.0) > 0
    if noisy:
        st["valid_chunks"] = -(-k // st["n_chunk"])
    if x_f32:
        x = np.zeros((16, kp), np.float32)
        x[:, :k] = rng.normal(size=(16, k))
        xs = np.float32(np.abs(x).max()) * np.float32(1.0 / 127.0)
    else:
        x, _ = _operands(2, 16, k, 128, kp)
        xs = np.float32(0.0071)
    _, w = _operands(3, 16, k, 128, kp)
    ws = rng.uniform(1e-3, 1e-2, 128).astype(np.float32)
    b = rng.normal(size=128).astype(np.float32) if with_bias else None
    seed = 77
    want = np.asarray(jk.photonic_gemm_fused_pallas(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(xs), jnp.asarray(ws),
        None if b is None else jnp.asarray(b), jnp.asarray([seed], jnp.int32),
        activation=act, tile_r=8, tile_c=128, interpret=True, **st,
    ))
    got = tk.photonic_gemm_fused(
        torch.from_numpy(x), torch.from_numpy(w), torch.tensor([xs]), torch.from_numpy(ws),
        None if b is None else torch.from_numpy(b), seed,
        activation=act, tile_r=8, tile_c=128, **st,
    ).numpy()
    unit = np.float64(xs) * ws.astype(np.float64)[None, :]
    if not with_bias and act is None:
        _assert_psums(np.rint(got / unit), np.rint(want / unit), _kind(name))
        if not noisy:
            np.testing.assert_array_equal(got, want)
    else:
        close = np.isclose(got, want, rtol=1e-5, atol=1e-5)
        assert close.mean() >= (0.99 if noisy else 1.0)


@pytest.mark.parametrize("name", ["ideal", "adc", "SMWA_det", "ASMW", "SMWA"])
def test_ref_oracle_matches_reference(jx, name):
    jnp, jref, jch = jx.jnp, jx.jref, jx.jch
    ch_name = name.split("_")[0]
    rng = np.random.default_rng(5)
    x = rng.integers(-127, 128, (12, 50)).astype(np.int8)
    w = rng.integers(-127, 128, (50, 20)).astype(np.int8)
    jkw, tkw = dict(n_chunk=N), dict(n_chunk=N)
    if name == "adc":
        jkw["adc_bits"] = tkw["adc_bits"] = 7
    elif name != "ideal":
        jc = jch.build_channel_model(ch_name, n=N, bits=4)
        tc = tch.build_channel_model(ch_name, n=N, bits=4)
        if name.endswith("_det"):
            jc, tc = jc.disable("detector"), tc.disable("detector")
        jkw.update(channel=jc, seed=jnp.uint32(31337))
        tkw.update(channel=tc, seed=31337)
    want = np.asarray(jref.photonic_gemm_ref(jnp.asarray(x), jnp.asarray(w), **jkw))
    got = tref.photonic_gemm_ref(torch.from_numpy(x), torch.from_numpy(w), **tkw).numpy()
    _assert_psums(got, want, _kind(name))
    np.testing.assert_array_equal(
        tref.exact_int_gemm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jref.exact_int_gemm(jnp.asarray(x), jnp.asarray(w))),
    )


def test_twin_ideal_equals_exact_and_sliced_passes():
    """Ideal channel: the kernel's one-pass shortcut equals the slice passes
    run through the chunked path (ADC wide enough never to clip)."""
    x, w = _operands(6, 8, 256, 128, 256)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    exact = tref.exact_int_gemm(tx, tw)
    ideal = tk.photonic_gemm_twin(tx, tw, tile_r=8, tile_k=256, n_chunk=128)
    wide_adc = tk.photonic_gemm_twin(tx, tw, tile_r=8, tile_k=256, n_chunk=32, adc_bits=31)
    assert torch.equal(ideal, exact) and torch.equal(wide_adc, exact)


def test_noise_depends_on_seed_and_tile_ids():
    st = _stages("SMWA")
    x, w = _operands(7, 16, 64, 256, 64)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    a = tk.photonic_gemm_twin(tx, tw, 1, tile_r=8, tile_c=128, **st)
    assert torch.equal(a, tk.photonic_gemm_twin(tx, tw, 1, tile_r=8, tile_c=128, **st))
    assert not torch.equal(a, tk.photonic_gemm_twin(tx, tw, 2, tile_r=8, tile_c=128, **st))
    # Another logical tiling draws other stream ids.
    assert not torch.equal(a, tk.photonic_gemm_twin(tx, tw, 1, tile_r=16, tile_c=128, **st))


# ---------------------------------------------------------------------------
# The launch plan (host side)
# ---------------------------------------------------------------------------
@given(
    r=hst.integers(1, 2048),
    kt=hst.integers(1, 12),
    ct=hst.integers(1, 80),
    n_chunk=hst.sampled_from([16, 17, 42, 64, 128]),
    chunks=hst.integers(1, 8),
    ideal=hst.sampled_from([True, False]),
    sms=hst.sampled_from([132, 114]),
)
@settings(max_examples=60, deadline=None)
def test_split_planner_assigns_every_chunk_once(r, kt, ct, n_chunk, chunks, ideal, sms):
    """Every logical (kk, g) chunk (or ideal K step) of every output tile
    goes to exactly one CTA, and the grid covers the SMs wherever there are
    that many chunk-tiles."""
    tile_k = n_chunk * chunks
    kp, cp = tile_k * kt, 128 * ct
    tile_r = min(128, -(-r // 8) * 8)
    rp = -(-r // tile_r) * tile_r
    ideal = ideal and kp % tk.K_STEP == 0
    plan = tk.plan_launch(r, rp, kp, cp, tile_r=tile_r, n_chunk=n_chunk, num_slices=2, ideal=ideal, sms=sms)
    assert plan.units == (kp // tk.K_STEP if ideal else kp // n_chunk)
    owners = [s for s in range(plan.n_split) for _ in plan.unit_range(s)]
    units = [u for s in range(plan.n_split) for u in plan.unit_range(s)]
    assert units == list(range(plan.units)) and len(owners) == plan.units
    assert all(len(plan.unit_range(s)) >= 1 for s in range(plan.n_split))
    if not ideal:  # the slice path's units are the logical chunks, kk-major
        assert sorted(divmod(u, chunks) for u in units) == [(kk, g) for kk in range(kt) for g in range(chunks)]
        assert tile_r % plan.bn == 0  # a CTA's rows lie in one logical row tile (one noise id i)
    assert plan.bn in tk.CTA_ROWS and rp % plan.bn == 0
    assert (plan.row_tiles - 1) * plan.bn < r <= plan.row_tiles * plan.bn
    assert plan.col_tiles == ct
    tiles = plan.row_tiles * plan.col_tiles
    if tiles * plan.units >= sms:
        assert plan.ctas >= sms
    if tiles >= tk.SPLIT_WAVES[ideal] * sms:
        assert plan.n_split == 1
    assert plan.ctas < tiles + tk.SPLIT_WAVES[ideal] * sms  # no split past its target


def _plane_stages(name, n=N):
    """Stage kwargs of one plane pass of the bit-sliced mode at 8-bit planes:
    the channel rebuilt at ``bits=8`` and one slice of the whole operand."""
    ch = tch.build_channel_model(name.split("_")[0], n=n, bits=8)
    if name.endswith("_det"):
        ch = ch.disable("detector")
    return dict(
        slice_bits=8, num_slices=1, n_chunk=n, tile_k=2 * n, adc_bits=ch.adc_bits,
        noise_sigma=ch.detector_sigma_lsb, filter_alpha=ch.filter_alpha,
        intermod_eps=ch.intermod_eps, crossweight_eps=ch.crossweight_eps,
    )


@pytest.mark.parametrize("name", ["ASMW_det", "ASMW", "MASW"])
def test_int_twin_matches_pallas_at_8_bit_planes(jx, name):
    """An 8-bit plane pass under crosstalk (neighbour sums up to +-254, past
    int8): the twin against the reference's kernel."""
    jk, jnp = jx.jk, jx.jnp
    st = _plane_stages(name)
    k = 88
    kp = -(-k // st["tile_k"]) * st["tile_k"]
    x, w = _operands(4, 16, k, 256, kp)
    if st["noise_sigma"] > 0:
        st["valid_chunks"] = -(-k // st["n_chunk"])
    want = jk.photonic_gemm_pallas(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray([12345], jnp.int32), tile_r=8, tile_c=128,
        interpret=True, **st,
    )
    got = tk.photonic_gemm(torch.from_numpy(x), torch.from_numpy(w), 12345, tile_r=8, tile_c=128, **st)
    _assert_psums(got.numpy(), want, _kind(name))


def test_neighbour_tiles_of_the_slice_path():
    """Slices of at most 6 bits keep one int8 tile of neighbour sums; wider
    ones keep the two neighbours apart, one more tile of shared memory."""
    assert [tk.neighbour_tiles(x, b) for x, b in ((False, 8), (True, 4), (True, 6), (True, 7), (True, 8))] == [
        0, 1, 1, 2, 2]
    for bn in tk.CTA_ROWS:
        one, two = (tk.slice_smem_bytes(bn, 42, 1, nb) for nb in (1, 2))
        assert one < two <= tk.SMEM_LIMIT
    assert tk.slice_smem_bytes(8, 42, 1, 2) - tk.slice_smem_bytes(8, 42, 1, 1) == 128 * (64 + 4)


def test_split_planner_at_the_served_shapes():
    """qwen2-0.5b: every site's grid covers the 132 SMs where its
    chunk-tiles allow, and the wide ones are not split."""
    wq = tk.plan_launch(4, 8, 1024, 896, tile_r=8, n_chunk=128, num_slices=2, ideal=True)
    assert (wq.bn, wq.units, wq.n_split, wq.ctas) == (8, 16, 16, 112)
    wo = tk.plan_launch(4, 8, 5040, 896, tile_r=8, n_chunk=42, num_slices=2, ideal=False)
    assert (wo.units, wo.n_split) == (120, 120) and wo.ctas >= 132  # as many CTAs as chunks
    wi = tk.plan_launch(64, 64, 1024, 9728, tile_r=64, n_chunk=128, num_slices=2, ideal=True)
    assert (wi.bn, wi.n_split, wi.ctas) == (64, 2, 152)
    logits = tk.plan_launch(2000, 2048, 1008, 896, tile_r=128, n_chunk=42, num_slices=2, ideal=False)
    assert (logits.bn, logits.row_tiles, logits.n_split) == (64, 32, 5)  # 224 tiles, 8 x 132 aimed for


# ---------------------------------------------------------------------------
# The CUDA kernel on the card
# ---------------------------------------------------------------------------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ideal", "adc", "ASMW_det", "SMWA"])
def test_cuda_kernel_matches_twin(name):
    dev = _card()
    st = _stages(name)
    k = 88
    kp = -(-k // st["tile_k"]) * st["tile_k"]
    noisy = st.get("noise_sigma", 0.0) > 0
    if noisy:
        st["valid_chunks"] = -(-k // st["n_chunk"])
    x, w = _operands(8, 16, k, 256, kp)
    tx, tw = torch.from_numpy(x).to(dev), torch.from_numpy(w).to(dev)
    got = tk.photonic_gemm(tx, tw, 5, tile_r=8, tile_c=128, **st)
    want = tk.photonic_gemm_twin(tx, tw, 5, tile_r=8, tile_c=128, **st)
    _assert_psums(got.cpu().numpy(), want.cpu().numpy(), "noisy" if noisy else "bitwise")
    xs = torch.tensor([0.01], device=dev)
    ws = torch.full((256,), 0.02, device=dev)
    b = torch.linspace(-1, 1, 256, device=dev)
    xf = tx.float() * 0.01
    fk = tk.photonic_gemm_fused(xf, tw, xs, ws, b, 5, activation="gelu", tile_r=8, tile_c=128, **st)
    ft = tk.photonic_gemm_fused_twin(xf, tw, xs, ws, b, 5, activation="gelu", tile_r=8, tile_c=128, **st)
    close = torch.isclose(fk, ft, rtol=1e-5, atol=1e-5).float().mean().item()
    assert close >= (0.99 if noisy else 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ASMW", "ASMW_det"])
@pytest.mark.parametrize("r", [4, 64])
def test_cuda_kernel_8_bit_plane_pass_under_crosstalk(name, r):
    """The unfused kernel at ``slice_bits=8``, ``num_slices=1`` (one pass of
    8-bit planes) under ASMW's crosstalk, where the neighbour sums overflow
    int8 and the kernel takes the two neighbours apart: against its twin,
    bitwise (noise: one-LSB roundings) on 8- and 64-row CTAs."""
    dev = _card()
    st = _plane_stages(name, 42)
    st["tile_k"] = 504
    k, c = 896, 256
    kp = -(-k // st["tile_k"]) * st["tile_k"]
    noisy = st["noise_sigma"] > 0
    if noisy:
        st["valid_chunks"] = -(-k // st["n_chunk"])
    rp = 8 if r <= 8 else 64
    x, w = _operands(6, rp, k, c, kp)
    x[r:] = 0
    tx, tw = torch.from_numpy(x).to(dev), torch.from_numpy(w).to(dev)
    kw = dict(tile_r=rp, tile_c=128, **st)
    got = tk.photonic_gemm(tx, tw, 7, rows=r, **kw)[:r]
    want = tk.photonic_gemm_twin(tx, tw, 7, **kw)[:r]
    _assert_psums(got.cpu().numpy(), want.cpu().numpy(), "noisy" if noisy else "bitwise", bits=8)


# (label, live rows R, padded Rp, K, C, channel, n_chunk, tile_k, tile_r)
CARD_CASES = [
    ("one-chunk K", 16, 16, 42, 128, "SMWA", 42, 42, 16),
    ("uneven split", 4, 8, 42 * 150, 1024, "SMWA", 42, 504, 8),
    ("uneven split ASMW", 8, 8, 17 * 149, 1024, "ASMW", 17, 510, 8),
    ("ideal R=4", 4, 8, 896, 896, "ideal", 128, 512, 8),
    ("ideal R=8, uneven split", 8, 8, 4864, 384, "ideal", 128, 512, 8),
    ("ideal R=64", 64, 64, 896, 1024, "ideal", 128, 512, 64),
    ("SMWA R=64", 64, 64, 300, 256, "SMWA", 42, 504, 64),
    ("ASMW_det R=64", 64, 64, 200, 128, "ASMW_det", 17, 510, 64),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=[c[0] for c in CARD_CASES])
@pytest.mark.parametrize("masked", [True, False], ids=["valid_chunks", "no-mask"])
def test_cuda_kernel_cases(case, masked):
    """The kernel against its twin on the live rows, through the split-K
    workspace: one-chunk K, a K split unevenly over CTAs, ``valid_chunks``
    masking of the K padding's noise (the chunks past the real K draw none),
    R in {4, 8, 64}."""
    dev = _card()
    label, r, rp, k, c, name, n, tile_k, tile_r = case
    st = dict(_stages(name, n), tile_k=tile_k) if name != "ideal" else dict(n_chunk=n, tile_k=tile_k)
    kp = -(-k // tile_k) * tile_k
    noisy = st.get("noise_sigma", 0.0) > 0
    if noisy and masked:
        st["valid_chunks"] = -(-k // n)
    rng = np.random.default_rng(len(label))
    x = np.zeros((rp, kp), np.int8)
    x[:r, :k] = rng.integers(-127, 128, (r, k))
    w = np.zeros((kp, c), np.int8)
    w[:k] = rng.integers(-127, 128, (k, c))
    tx, tw = torch.from_numpy(x).to(dev), torch.from_numpy(w).to(dev)
    kw = dict(tile_r=tile_r, tile_c=128, **st)
    plan = tk.plan_launch(r, rp, kp, c, tile_r=tile_r, n_chunk=n, num_slices=2,
                          ideal=name == "ideal" and kp % tk.K_STEP == 0,
                          nb=tk.neighbour_tiles(st.get("intermod_eps", 0.0) > 0, 4), sms=tk._sm_count(dev.index or 0))
    if "split" in label:  # CTAs of one output tile take unequal numbers of chunks
        assert plan.n_split > 1 and plan.units % plan.n_split != 0
    if label == "one-chunk K":
        assert plan.units == 1
    got = tk.photonic_gemm(tx, tw, 11, rows=r, **kw)[:r]
    want = tk.photonic_gemm_twin(tx, tw, 11, **kw)[:r]
    _assert_psums(got.cpu().numpy(), want.cpu().numpy(), "noisy" if noisy else "bitwise")
    xs = torch.tensor([0.01], device=dev)
    ws = torch.linspace(0.01, 0.03, c, device=dev)
    xf = tx.float() * 0.013
    fk = tk.photonic_gemm_fused(xf, tw, xs, ws, None, 11, rows=r, **kw)[:r]
    ft = tk.photonic_gemm_fused_twin(xf, tw, xs, ws, None, 11, **kw)[:r]
    unit = (xs * ws[None, :]).double()
    _assert_psums(torch.round(fk.double() / unit).cpu().numpy(), torch.round(ft.double() / unit).cpu().numpy(),
                  "noisy" if noisy else "bitwise")
    if not noisy:
        assert torch.equal(fk, ft)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ideal", "SMWA"])
def test_cuda_graph_replays_are_equal(name):
    """Two replays of one captured CUDA graph give the same outputs as the
    eager call: the split-K workspace and tickets are left zeroed."""
    dev = _card()
    st = _stages(name, 42) if name != "ideal" else dict(n_chunk=128, tile_k=512)
    if name != "ideal":
        st["tile_k"] = 504
    k, c = 896, 896
    kp = -(-k // st["tile_k"]) * st["tile_k"]
    rng = np.random.default_rng(3)
    x = np.zeros((8, kp), np.int8)
    x[:4, :k] = rng.integers(-127, 128, (4, k))
    w = np.zeros((kp, c), np.int8)
    w[:k] = rng.integers(-127, 128, (k, c))
    tx, tw = torch.from_numpy(x).to(dev), torch.from_numpy(w).to(dev)
    seed = torch.tensor(99, device=dev)
    kw = dict(tile_r=8, tile_c=128, rows=4, **st)
    eager = tk.photonic_gemm(tx, tw, seed, **kw)[:4].clone()
    out = torch.empty((8, c), dtype=torch.int32, device=dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out.copy_(tk.photonic_gemm(tx, tw, seed, **kw))
    replays = []
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        replays.append(out[:4].clone())
    assert torch.equal(replays[0], replays[1]) and torch.equal(replays[0], eager)
