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
(``-m cuda`` tests below, and ``chip_smoke.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.photonic_gemm import kernel as jk  # noqa: E402
from repro.kernels.photonic_gemm import ref as jref  # noqa: E402
from repro.noise import channel as jch  # noqa: E402
from repro_torch.kernels.photonic_gemm import kernel as tk  # noqa: E402
from repro_torch.kernels.photonic_gemm import ref as tref  # noqa: E402
from repro_torch.noise import channel as tch  # noqa: E402

N = 16  # DPE size of the tests (chunk); tile_k = 2 chunks


def _stages(name):
    """Kernel stage kwargs for a named channel at fan-in N."""
    if name == "ideal":
        return dict(n_chunk=128, tile_k=128)
    if name == "adc":
        return dict(n_chunk=N, tile_k=2 * N, adc_bits=7)
    ch = jch.build_channel_model(name.split("_")[0], n=N, bits=4)
    if name.endswith("_det"):  # deterministic: crosstalk + filter only
        ch = ch.disable("detector")
    return dict(
        n_chunk=N, tile_k=2 * N, adc_bits=ch.adc_bits, noise_sigma=ch.detector_sigma_lsb,
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
def test_int_twin_matches_pallas(name):
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
def test_fused_twin_matches_pallas(name, tail, x_f32):
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
def test_ref_oracle_matches_reference(name):
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


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ideal", "adc", "ASMW_det", "SMWA"])
def test_cuda_kernel_matches_twin(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the CUDA kernel has no CPU mode")
    st = _stages(name)
    k = 88
    kp = -(-k // st["tile_k"]) * st["tile_k"]
    noisy = st.get("noise_sigma", 0.0) > 0
    if noisy:
        st["valid_chunks"] = -(-k // st["n_chunk"])
    x, w = _operands(8, 16, k, 256, kp)
    dev = torch.device("cuda")
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
