"""The port's PhotonicEngine against the JAX engine, on the same inputs.

``PhotonicEngine.matmul`` over a prepacked weight (the serving hot path)
and ``int_gemm`` (the integer entry point) are held to the reference's:
the port's ``kernel`` backend (its twin on CPU) against the reference's
``pallas`` backend (interpret mode on CPU), and ``ref``/``exact`` against
theirs.  Tolerances: bitwise under the ideal channel without a bias; the
bias tail within ``1e-5`` relative (FMA contraction in the reference's
compiled epilogue); under the noisy SMWA channel the psums (output over
``x_scale * w_scale``) may round one LSB apart at <= 1% of elements
(ulp-close Box-Muller draws).  Seeds, site hashes and content words are
bitwise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core.dpu import DPUConfig as JDPU  # noqa: E402
from repro.noise.channel import build_channel_model as jbuild  # noqa: E402
from repro.photonic import Epilogue as JEpilogue  # noqa: E402
from repro.photonic import EpilogueSpec as JSpec  # noqa: E402
from repro.photonic.engine import PhotonicEngine as JEngine  # noqa: E402
from repro.photonic.packing import pack_dense as jpack  # noqa: E402
from repro_torch.core.dpu import DPUConfig as TDPU  # noqa: E402
from repro_torch.core.dpu import quant_scale  # noqa: E402
from repro_torch.kernels.photonic_gemm import kernel as tk  # noqa: E402
from repro_torch.noise.channel import build_channel_model as tbuild  # noqa: E402
from repro_torch.noise.stages import tweak_word  # noqa: E402
from repro_torch.photonic import Epilogue as TEpilogue  # noqa: E402
from repro_torch.photonic import EpilogueSpec as TSpec  # noqa: E402
from repro_torch.photonic.engine import PhotonicEngine as TEngine  # noqa: E402
from repro_torch.photonic.engine import site_hash  # noqa: E402
from repro_torch.photonic.packing import pack_dense as tpack  # noqa: E402

BACKEND = {"kernel": "pallas", "ref": "ref", "exact": "exact"}


def _dpus(channel):
    if channel == "ideal":
        return JDPU(organization="SMWA", bits=4, dpe_size=16), TDPU(organization="SMWA", bits=4, dpe_size=16)
    # N=64 keeps the reference's interpret-mode kernel small (8 chunks a
    # K-tile) while K=72 still spans two chunks, one of them ragged.
    return (
        JDPU(organization="SMWA", bits=4, dpe_size=64, channel=jbuild("SMWA", n=64, bits=4), noise_seed=3),
        TDPU(organization="SMWA", bits=4, dpe_size=64, channel=tbuild("SMWA", n=64, bits=4), noise_seed=3),
    )


def _inputs(seed=0, r=5, k=72, c=40):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(r, k)).astype(np.float32)
    w = (rng.normal(size=(k, c)) / np.sqrt(k)).astype(np.float32)
    b = rng.normal(size=c).astype(np.float32)
    return x, w, b


def _lsb(y, x, packed_scale):
    sx = quant_scale(torch.from_numpy(x), 8).numpy().astype(np.float64)
    return np.rint(np.asarray(y, np.float64) / (sx * packed_scale.astype(np.float64)[None, :]))


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize(
    "backend,channel",
    [("kernel", "ideal"), ("kernel", "smwa"), ("ref", "ideal"), ("ref", "smwa"), ("exact", "ideal")],
)
def test_matmul_prepacked_matches_jax_engine(backend, channel, bias):
    x, w, b = _inputs()
    jd, td = _dpus(channel)
    je = JEngine(dpu=jd, backend=BACKEND[backend])
    te = TEngine(dpu=td, backend=backend)
    jp = jpack({"w": jnp.asarray(w)}, je)["w"]
    tp = tpack({"w": torch.from_numpy(w)}, te)["w"]
    np.testing.assert_array_equal(tp.w_scale.numpy(), np.asarray(jp.w_scale))
    np.testing.assert_array_equal(tp.wq.numpy(), np.asarray(jp.wq))  # same padded layout
    jb, tb = (jnp.asarray(b), torch.from_numpy(b)) if bias else (None, None)
    want = np.asarray(je.matmul(
        jnp.asarray(x), jp, site="attn.wq", fold=jnp.int32(3), epilogue=JEpilogue(JSpec(bias=bias), jb),
    ))
    got = te.matmul(
        torch.from_numpy(x), tp, site="attn.wq", fold=3, epilogue=TEpilogue(TSpec(bias=bias), tb),
    ).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    if bias:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    elif channel == "ideal":
        np.testing.assert_array_equal(got, want)
    else:
        d = np.abs(_lsb(got, x, tp.w_scale.numpy()) - _lsb(want, x, tp.w_scale.numpy()))
        assert (d > 0).mean() <= 0.01 and d.max() <= 512


@pytest.mark.parametrize("channel", ["ideal", "smwa"])
def test_int_gemm_matches_jax_engine(channel):
    rng = np.random.default_rng(1)
    xq = rng.integers(-127, 128, (9, 72)).astype(np.int8)
    wq = rng.integers(-127, 128, (72, 40)).astype(np.int8)
    jd, td = _dpus(channel)
    want = np.asarray(JEngine(dpu=jd, backend="pallas").int_gemm(
        jnp.asarray(xq), jnp.asarray(wq), site="ffn.wo", fold=jnp.int32(1)
    ))
    got = TEngine(dpu=td, backend="kernel").int_gemm(
        torch.from_numpy(xq), torch.from_numpy(wq), site="ffn.wo", fold=1
    ).numpy()
    if channel == "ideal":
        np.testing.assert_array_equal(got, want)
    else:
        d = np.abs(got.astype(np.int64) - want)
        assert (d > 0).mean() <= 0.01 and d.max() <= 512


@pytest.mark.parametrize("site,fold", [(None, None), ("attn.wq", None), ("ffn.wi", 7)])
def test_stream_seed_bitwise(site, fold):
    rng = np.random.default_rng(2)
    xq = rng.integers(-127, 128, (6, 30)).astype(np.int8)
    wq = rng.integers(-127, 128, (30, 20)).astype(np.int8)
    jd, td = _dpus("smwa")
    want = int(JEngine(dpu=jd).stream_seed(
        site, None if fold is None else jnp.int32(fold), None, jnp.asarray(xq), jnp.asarray(wq)
    ))
    got = TEngine(dpu=td).stream_seed(site, fold, torch.from_numpy(xq), torch.from_numpy(wq))
    assert int(got) == want
    w_word = tweak_word(torch.from_numpy(np.pad(wq, ((0, 2), (0, 108)))))
    assert int(TEngine(dpu=td).stream_seed(site, fold, torch.from_numpy(xq), None, w_word=w_word)) == want
    if site is not None:
        from repro.photonic.engine import site_hash as jsite_hash

        assert site_hash(site) == jsite_hash(site)


def test_prepacked_equals_per_call_and_ideal_equals_exact():
    x, w, _ = _inputs(3, r=7, k=96, c=130)
    _, td = _dpus("ideal")
    eng = TEngine(dpu=td, backend="kernel")
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    packed = eng.matmul(tx, tpack({"w": tw}, eng)["w"], site="attn.wo")
    per_call = eng.matmul_float(tx, tw, site="attn.wo")
    exact = TEngine(dpu=td, backend="exact").matmul_float(tx, tw, site="attn.wo")
    assert torch.equal(packed, per_call) and torch.equal(packed, exact)


def test_noisy_prepack_carries_the_weight_word():
    _, td = _dpus("smwa")
    eng = TEngine(dpu=td, backend="kernel")
    pk = tpack({"w": torch.from_numpy(_inputs()[1])}, eng)["w"]
    assert pk.tiling == (64, 512, 128) and tuple(pk.wq.shape) == (512, 128)
    assert int(pk.w_word) == int(tweak_word(pk.wq[: pk.k, : pk.c]))
    _, ideal = _dpus("ideal")
    assert tpack({"w": torch.ones(4, 4)}, TEngine(dpu=ideal, backend="kernel"))["w"].w_word is None


def test_routing_policy_and_unported_modes():
    x, w, _ = _inputs(4)
    _, td = _dpus("ideal")
    eng = TEngine(dpu=td, backend="kernel")
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    assert eng.routes("attn.wq") and not eng.routes("ffn.router")
    torch.testing.assert_close(eng.matmul_float(tx, tw, site="ffn.router"), tx @ tw, rtol=0, atol=0)
    assert TEngine(dpu=td, slicing=4).slicing.plane_bits == 4  # bit-slicing is ported
    with pytest.raises(ValueError, match="plane_bits"):
        TEngine(dpu=td, slicing=3)
    # A key wins over noise_seed and folds as the reference's does.
    jd, tdn = _dpus("smwa")
    xq = np.clip(np.round(x * 40), -127, 127).astype(np.int8)
    wq = np.clip(np.round(w * 300), -127, 127).astype(np.int8)
    want = JEngine(dpu=jd, backend="pallas").stream_seed(
        "a", 3, jnp.asarray([0, 1], jnp.uint32), jnp.asarray(xq), jnp.asarray(wq)
    )
    got = TEngine(dpu=tdn).stream_seed(
        "a", 3, torch.from_numpy(xq), torch.from_numpy(wq), prng_key=[0, 1]
    )
    assert int(got) == int(np.asarray(want))
    with pytest.raises(ValueError, match="unknown photonic backend"):
        TEngine(dpu=td, backend="pallas")
    with pytest.raises(TypeError, match="float activations"):
        eng.int_gemm(tx, tw)


def test_describe_matches_reference_text():
    jd, td = _dpus("smwa")
    want = str(JEngine(dpu=jd, backend="pallas").describe())
    got = str(TEngine(dpu=td, backend="kernel").describe())
    assert got == want.replace("pallas backend", "kernel backend")
    assert TEngine(dpu=td).describe().to_dict()["channel"] == "analog"


def test_kernel_backend_counts_no_launch_on_cpu():
    x, w, _ = _inputs(5)
    _, td = _dpus("smwa")
    eng = TEngine(dpu=td, backend="kernel")
    tk.reset_launches()
    eng.matmul(torch.from_numpy(x), tpack({"w": torch.from_numpy(w)}, eng)["w"], site="s", fold=0)
    assert sum(tk.LAUNCHES.values()) == 0


def test_kernel_is_the_default_backend():
    from repro_torch.models.common import ModelConfig

    assert TEngine().backend == "kernel"
    assert ModelConfig().photonic_backend == "kernel"


@pytest.mark.parametrize("channel", ["ideal", "smwa"])
def test_kernel_stages_follow_the_packed_tiling(channel):
    """The stage arguments and padding int_gemm launches with come from one
    place, and a prepacked weight's tiling gives the same as none."""
    from repro_torch.photonic.engine import kernel_stages

    _, td = _dpus(channel)
    eng = TEngine(dpu=td)
    pk = tpack({"w": torch.from_numpy(_inputs()[1])}, eng)["w"]
    stages, padded = kernel_stages(td, 5, pk.k, pk.c)
    assert kernel_stages(td, 5, pk.k, pk.c, pk.tiling) == (stages, padded)
    assert padded == (8,) + tuple(pk.wq.shape)
    assert (stages["n_chunk"], stages["tile_k"], stages["tile_c"]) == pk.tiling
    assert stages["tile_r"] == 8
    if channel == "smwa":
        ch = td.effective_channel()
        assert stages["noise_sigma"] == ch.detector_sigma_lsb and stages["valid_chunks"] == 2
    else:
        assert stages["noise_sigma"] == 0.0 and stages["valid_chunks"] is None
