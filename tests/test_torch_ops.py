"""The port's ``kernels/photonic_gemm/ops.py`` against the reference's.

``photonic_gemm_int`` and ``photonic_gemm`` on the port's ``kernel``
backend (its twin, for CPU tensors) against the reference's ``pallas``
backend in interpret mode, as the reference's own tests run it, and the
``ref`` / ``exact`` backends against theirs, on the same seeded inputs.
Tolerances: bitwise on the ideal channel and on every ``exact`` call;
under SMWA (detector noise) and ASMW (inter-modulation crosstalk plus
detector noise) bitwise apart from one-LSB psum roundings at <= 0.1% of
elements (the reference's interpret mode contracts ``a + eps * dot`` into
an FMA, ROADMAP Queue 3 item 3; f32 ``log`` / ``cos`` round apart in
XLA's and torch's Box-Muller draws), each at most one LSB of the top
slice pass (``2^(2B)`` accumulator units).  The legacy ``tile_c=256``
tiling changes the noise stream ids, and both packages change them alike.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core.dpu import DPUConfig as JDPU  # noqa: E402
from repro.kernels.photonic_gemm import ops as jops  # noqa: E402
from repro.noise.channel import build_channel_model as jbuild  # noqa: E402
from repro_torch.core.dpu import DPUConfig as TDPU  # noqa: E402
from repro_torch.core.dpu import quant_scale  # noqa: E402
from repro_torch.kernels.photonic_gemm import kernel as tk  # noqa: E402
from repro_torch.kernels.photonic_gemm import ops as tops  # noqa: E402
from repro_torch.noise.channel import build_channel_model as tbuild  # noqa: E402

BACKEND = {"kernel": "pallas", "ref": "ref", "exact": "exact"}


def _dpus(channel):
    if channel == "ideal":
        return JDPU(organization="SMWA", bits=4, dpe_size=16), TDPU(organization="SMWA", bits=4, dpe_size=16)
    # N = 64 keeps the interpret-mode kernel small while K = 160 spans three
    # chunks, the last one ragged; C = 260 spans three 128-column tiles and
    # two 256-column ones.
    return (
        JDPU(organization=channel, bits=4, dpe_size=64, channel=jbuild(channel, n=64, bits=4), noise_seed=5),
        TDPU(organization=channel, bits=4, dpe_size=64, channel=tbuild(channel, n=64, bits=4), noise_seed=5),
    )


def _int_operands(seed, r=16, k=160, c=260):
    rng = np.random.default_rng(seed)
    return (rng.integers(-127, 128, (r, k)).astype(np.int8), rng.integers(-127, 128, (k, c)).astype(np.int8))


def _float_operands(seed, r=16, k=160, c=260):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(r, k)).astype(np.float32), (rng.normal(size=(k, c)) / np.sqrt(k)).astype(np.float32))


def _agree(got, want, channel, bits=4):
    """Bitwise on the ideal channel; else one-LSB psum roundings at <= 0.1%
    of elements, each at most one top-pass LSB."""
    got, want = np.asarray(got, np.int64), np.asarray(want, np.int64)
    assert got.shape == want.shape
    if channel == "ideal":
        np.testing.assert_array_equal(got, want)
        return
    d = np.abs(got - want)
    assert (d > 0).mean() <= 1e-3, (d > 0).mean()
    assert d.max() <= 2 ** (2 * bits), d.max()


@pytest.mark.parametrize("tile_c", [128, 256])
@pytest.mark.parametrize("channel", ["ideal", "SMWA", "ASMW"])
def test_photonic_gemm_int_matches_reference_ops(channel, tile_c):
    xq, wq = _int_operands(0)
    jd, td = _dpus(channel)
    want = np.asarray(jops.photonic_gemm_int(jnp.asarray(xq), jnp.asarray(wq), jd, backend="pallas", tile_c=tile_c))
    tk.reset_launches()
    got = tops.photonic_gemm_int(torch.from_numpy(xq), torch.from_numpy(wq), td, tile_c=tile_c)
    assert got.dtype == torch.int32
    assert tk.LAUNCHES == {"photonic_gemm_fused": 0, "photonic_gemm": 0}  # the CPU twin is no launch
    _agree(got.numpy(), want, channel)


def test_tile_c_256_moves_the_noise_streams_in_both_packages():
    xq, wq = _int_operands(1)
    jd, td = _dpus("SMWA")
    j = [np.asarray(jops.photonic_gemm_int(jnp.asarray(xq), jnp.asarray(wq), jd, backend="pallas", tile_c=tc))
         for tc in (128, 256)]
    t = [tops.photonic_gemm_int(torch.from_numpy(xq), torch.from_numpy(wq), td, tile_c=tc).numpy()
         for tc in (128, 256)]
    assert not np.array_equal(j[0], j[1]) and not np.array_equal(t[0], t[1])
    for a, b in zip(t, j):
        _agree(a, b, "SMWA")


@pytest.mark.parametrize("backend,channel", [("ref", "ideal"), ("ref", "SMWA"), ("exact", "ideal"), ("exact", "ASMW")])
def test_photonic_gemm_int_ref_and_exact_backends(backend, channel):
    xq, wq = _int_operands(2)
    jd, td = _dpus(channel)
    want = np.asarray(jops.photonic_gemm_int(jnp.asarray(xq), jnp.asarray(wq), jd, backend=BACKEND[backend]))
    got = tops.photonic_gemm_int(torch.from_numpy(xq), torch.from_numpy(wq), td, backend=backend).numpy()
    if backend == "exact":
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, xq.astype(np.int64) @ wq.astype(np.int64))
    else:
        _agree(got, want, channel)


def _psums(y, x, w):
    """The float output in accumulator units: ``y / (x_scale * w_scale)``."""
    sx = quant_scale(torch.from_numpy(x), 8).numpy().astype(np.float64)
    sw = quant_scale(torch.from_numpy(w), 8, axis=0).numpy().astype(np.float64)
    return np.rint(np.asarray(y, np.float64) / (sx * sw.reshape(1, -1)))


@pytest.mark.parametrize("backend,channel", [
    ("kernel", "ideal"), ("kernel", "SMWA"), ("kernel", "ASMW"), ("ref", "ideal"), ("ref", "SMWA"), ("exact", "ideal"),
])
def test_photonic_gemm_matches_reference_ops(backend, channel):
    x, w = _float_operands(3)
    jd, td = _dpus(channel)
    want = np.asarray(jops.photonic_gemm(jnp.asarray(x), jnp.asarray(w), jd, BACKEND[backend]))
    got = tops.photonic_gemm(torch.from_numpy(x), torch.from_numpy(w), td, backend).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    if channel == "ideal":
        np.testing.assert_array_equal(got, want)
    else:
        _agree(_psums(got, x, w), _psums(want, x, w), channel)


def test_photonic_gemm_prng_key_and_default_config():
    from repro_torch import prng

    x, w = _float_operands(4, r=6, k=40, c=50)
    jd, td = _dpus("SMWA")
    np.testing.assert_array_equal(np.asarray(prng.PRNGKey(11)), np.asarray(jax.random.PRNGKey(11)))
    want = np.asarray(jops.photonic_gemm(jnp.asarray(x), jnp.asarray(w), jd, "pallas", prng_key=jax.random.PRNGKey(11)))
    got = tops.photonic_gemm(torch.from_numpy(x), torch.from_numpy(w), td, "kernel", prng_key=prng.PRNGKey(11)).numpy()
    _agree(_psums(got, x, w), _psums(want, x, w), "SMWA")
    unkeyed = tops.photonic_gemm(torch.from_numpy(x), torch.from_numpy(w), td, "kernel").numpy()
    assert not np.array_equal(unkeyed, got)
    np.testing.assert_array_equal(
        tops.photonic_gemm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jops.photonic_gemm(jnp.asarray(x), jnp.asarray(w))),
    )


def test_ops_take_the_twin_only_for_cpu_tensors():
    xq, wq = _int_operands(5, r=4, k=32, c=16)
    _, td = _dpus("ideal")
    with pytest.raises(ValueError, match="CPU \\(twin\\) or CUDA"):
        tops.photonic_gemm_int(torch.from_numpy(xq).to("meta"), torch.from_numpy(wq).to("meta"), td)
    with pytest.raises(ValueError, match="unknown photonic backend"):
        tops.photonic_gemm_int(torch.from_numpy(xq), torch.from_numpy(wq), td, backend="pallas")


def test_photonic_gemm_is_differentiable_by_ste():
    x, w = _float_operands(6, r=5, k=48, c=20)
    _, td = _dpus("ideal")
    tx, tw = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(w).requires_grad_(True)
    y = tops.photonic_gemm(tx, tw, td)
    g = torch.from_numpy(np.random.default_rng(7).normal(size=y.shape).astype(np.float32))
    y.backward(g)
    jx, jw = jax.grad(lambda a, b: jnp.sum(jops.photonic_gemm(a, b, _dpus("ideal")[0], "pallas") * jnp.asarray(g)),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jw), rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_ops_on_the_card_equal_the_cpu_twin():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, w = _float_operands(8, r=64, k=896, c=896)
    for channel in ("ideal", "SMWA"):
        _, td = _dpus(channel)
        tk.reset_launches()
        got = tops.photonic_gemm(torch.from_numpy(x).cuda(), torch.from_numpy(w).cuda(), td).cpu().numpy()
        assert tk.LAUNCHES["photonic_gemm_fused"] == 1
        want = tops.photonic_gemm(torch.from_numpy(x), torch.from_numpy(w), td).numpy()
        _agree(_psums(got, x, w), _psums(want, x, w), channel)
        xq, wq = _int_operands(9, r=64, k=896, c=896)
        for tile_c in (128, 256):
            got = tops.photonic_gemm_int(torch.from_numpy(xq).cuda(), torch.from_numpy(wq).cuda(), td, tile_c=tile_c)
            want = tops.photonic_gemm_int(torch.from_numpy(xq), torch.from_numpy(wq), td, tile_c=tile_c)
            _agree(got.cpu().numpy(), want.numpy(), channel)
