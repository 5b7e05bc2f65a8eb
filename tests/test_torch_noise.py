"""The port's channel model, noise stages, quantizers and epilogue against
the JAX reference, on the same numpy inputs.

Tolerances: hash / fold / tweak / seed words, neighbour sums, the ADC and
f32 quantization are bitwise; ``ChannelModel`` is field for field (the
same Python float arithmetic); the Box-Muller draws are ulp-close (XLA's
and torch's f32 ``log``/``cos`` may round apart in the last ulp); the
rescale-only epilogue is bitwise and the bias/activation tail within
``1e-6`` relative (the reference may contract it into FMAs).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import orgs as jorgs  # noqa: E402
from repro.core import dpu as jdpu  # noqa: E402
from repro.core import scalability as jscal  # noqa: E402
from repro.kernels.photonic_gemm import epilogue as jepi  # noqa: E402
from repro.noise import channel as jch  # noqa: E402
from repro.noise import stages as jst  # noqa: E402
from repro_torch.core import dpu as tdpu  # noqa: E402
from repro_torch.core import scalability as tscal  # noqa: E402
from repro_torch.kernels.photonic_gemm import epilogue as tepi  # noqa: E402
from repro_torch.noise import channel as tch  # noqa: E402
from repro_torch.noise import stages as tst  # noqa: E402

ORDERS = [s.name for s in jorgs.valid_orderings()]


def _u32(rng, shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)


def test_hash_mix32_bitwise_tensor_and_int():
    x = _u32(np.random.default_rng(0), (4096,))
    want = np.asarray(jst.hash_mix32(jnp.asarray(x)))
    got = tst.hash_mix32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    assert [tst.hash_mix32(int(v)) for v in x[:16]] == [int(v) for v in want[:16]]


@pytest.mark.parametrize("n_ids", [1, 2, 3])
def test_fold_seed_bitwise(n_ids):
    rng = np.random.default_rng(n_ids)
    seeds = _u32(rng, (64,))
    ids = [rng.integers(0, 5000, 64).astype(np.int32) for _ in range(n_ids)]
    want = np.asarray(jst.fold_seed(jnp.asarray(seeds), *[jnp.asarray(i) for i in ids]))
    got = tst.fold_seed(torch.from_numpy(seeds.astype(np.int64)), *[torch.from_numpy(i) for i in ids])
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # Python ints take the same path (host-side seed folding).
    assert tst.fold_seed(int(seeds[0]), *[int(i[0]) for i in ids]) == int(want[0])


def test_data_tweak_bitwise_and_padding_neutral():
    rng = np.random.default_rng(1)
    x = rng.integers(-127, 128, (16, 40)).astype(np.int8)
    w = rng.integers(-127, 128, (40, 24)).astype(np.int8)
    want = int(jst.data_tweak(jnp.uint32(123456789), jnp.asarray(x), jnp.asarray(w)))
    got = tst.data_tweak(123456789, torch.from_numpy(x), torch.from_numpy(w))
    assert int(got) == want
    wp = np.pad(w, ((0, 8), (0, 104)))
    assert int(tst.data_tweak(123456789, torch.from_numpy(x), torch.from_numpy(wp))) == want
    words = (tst.tweak_word(torch.from_numpy(x)), tst.tweak_word(torch.from_numpy(wp)))
    assert int(tst.fold_words(123456789, *words)) == want


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_seed_from_key_words_bitwise(seed):
    key = jax.random.PRNGKey(seed)
    want = int(jst.seed_from_key(key))
    assert tst.seed_from_key(np.asarray(key).astype(np.uint32).tolist()) == want
    assert tst.seed_from_key(None) is None


@pytest.mark.parametrize("shape", [(4096,), (24, 40), (3, 8, 128)])
def test_gaussian_from_counter_ulp_close(shape):
    base = 0x1234ABCD
    want = np.asarray(jst.gaussian_from_counter(jnp.uint32(base), shape))
    got = tst.gaussian_from_counter(base, shape).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)
    assert abs(float(got.mean())) < 0.2 and 0.8 < float(got.std()) < 1.2


def test_neighbor_sum_and_adc_bitwise():
    rng = np.random.default_rng(2)
    x = rng.integers(-15, 16, (5, 7, 9)).astype(np.int32)
    for axis in (0, 1, -1):
        want = np.asarray(jst.neighbor_sum(jnp.asarray(x), axis=axis))
        np.testing.assert_array_equal(tst.neighbor_sum(torch.from_numpy(x), axis=axis).numpy(), want)
    a = (rng.normal(size=(64, 64)) * 300).astype(np.float32)
    a[0, :4] = [0.5, 1.5, -0.5, -2.5]  # half-to-even ties
    for bits in (None, 6, 10):
        want = np.asarray(jst.adc_quantize(jnp.asarray(a), bits))
        np.testing.assert_array_equal(tst.adc_quantize(torch.from_numpy(a), bits).numpy(), want)


@pytest.mark.parametrize("platform", ["SOI", "SIN"])
@pytest.mark.parametrize("order", ORDERS)
def test_channel_model_field_for_field(order, platform):
    for n in (None, 8, 42):
        for bits in (4, 6):
            try:
                want = jch.build_channel_model(order, n=n, bits=bits, platform=platform)
            except ValueError as e:
                with pytest.raises(ValueError, match="infeasible"):
                    tch.build_channel_model(order, n=n, bits=bits, platform=platform)
                assert "infeasible" in str(e)
                continue
            got = tch.build_channel_model(order, n=n, bits=bits, platform=platform)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), (order, n, bits)
            assert got.analog == want.analog and got.is_ideal == want.is_ideal
            assert got.total_loss_db() == want.total_loss_db()
            assert dataclasses.asdict(got.disable("crosstalk")) == dataclasses.asdict(
                want.disable("crosstalk")
            )


@pytest.mark.parametrize("platform", ["SOI", "SIN"])
def test_calibrated_max_n_and_dpu_config(platform):
    for order in ORDERS:
        for bits in (2, 4, 6, 8):
            for dr in (1.0, 5.0, 10.0):
                assert tscal.calibrated_max_n(order, bits, dr, platform=platform) == (
                    jscal.calibrated_max_n(order, bits, dr, platform=platform)
                )
    j = jdpu.DPUConfig(organization="smwa", bits=4, datarate_gs=5.0, platform=platform)
    t = tdpu.DPUConfig(organization="smwa", bits=4, datarate_gs=5.0, platform=platform)
    assert (t.organization, t.platform, t.n, t.num_slices) == (
        j.organization, j.platform, j.n, j.num_slices
    )


def test_smwa_operating_point_of_the_server():
    ch = tch.build_channel_model("SMWA", n=42, bits=4, datarate_gs=5.0)
    assert tdpu.DPUConfig(organization="SMWA", bits=4, datarate_gs=5.0).n == 42
    assert ch.filter_alpha == pytest.approx(0.0559, abs=1e-4)
    assert ch.detector_sigma_lsb == pytest.approx(17.1, abs=0.05)
    assert ch.intermod_eps == 0.0 and ch.crossweight_eps == 0.0


@pytest.mark.parametrize("axis", [None, 0, -2])
def test_f32_quantization_bitwise(axis):
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(33, 47)) * rng.uniform(0.01, 10)).astype(np.float32)
    jq, js = jdpu.quantize_symmetric(jnp.asarray(x), 8, axis=axis)
    tq, ts = tdpu.quantize_symmetric(torch.from_numpy(x), 8, axis=axis)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jsc = jdpu.quant_scale(jnp.asarray(x), 8, axis=axis)
    tsc = tdpu.quant_scale(torch.from_numpy(x), 8, axis=axis)
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    if axis is None:
        jw = jdpu.quantize_with_scale(jnp.asarray(x), jsc, 8)
        tw = tdpu.quantize_with_scale(torch.from_numpy(x), tsc, 8)
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        jt = jepi.quantize_tile(jnp.asarray(x), jsc, 127.0)
        tt = tepi.quantize_tile(torch.from_numpy(x), tsc, 127.0)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("bias,activation", [(False, None), (True, None), (True, "gelu"), (False, "silu")])
def test_epilogue(bias, activation):
    rng = np.random.default_rng(4)
    acc = rng.integers(-(2**20), 2**20, (16, 24)).astype(np.int32)
    xs = np.float32(0.0123)
    ws = rng.uniform(1e-4, 1e-2, 24).astype(np.float32)
    b = rng.normal(size=24).astype(np.float32) if bias else None
    jspec = jepi.EpilogueSpec(bias=bias, activation=activation)
    tspec = tepi.EpilogueSpec(bias=bias, activation=activation)
    want = np.asarray(jax.jit(jepi.apply_epilogue, static_argnames="spec")(
        jnp.asarray(acc), jnp.asarray(xs), jnp.asarray(ws), None if b is None else jnp.asarray(b),
        spec=jspec,
    ))
    got = tepi.apply_epilogue(
        torch.from_numpy(acc), torch.tensor(xs), torch.from_numpy(ws),
        None if b is None else torch.from_numpy(b), tspec,
    ).numpy()
    if not bias and activation is None:
        np.testing.assert_array_equal(got, want)  # rescale chain: bitwise
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_as_epilogue_surface():
    spec, b = tepi.as_epilogue(bias=torch.ones(3), activation="silu")
    assert spec == tepi.EpilogueSpec(bias=True, activation="silu") and b is not None
    with pytest.raises(TypeError):
        tepi.as_epilogue(tepi.EpilogueSpec(bias=True))
    with pytest.raises(TypeError):
        tepi.as_epilogue(tepi.EpilogueSpec(), bias=torch.ones(3))
    with pytest.raises(ValueError):
        tepi.EpilogueSpec(activation="relu")
