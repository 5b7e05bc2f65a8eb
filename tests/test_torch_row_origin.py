"""A block of a GEMM's rows at its global row origin draws the noise the
whole-rows call draws on those rows.

An expanded MLA decode over a ``kv_seq``-placed cache sends a rank's block
of the latent rows through ``wuk`` / ``wuv``; where the replicated program
runs the rows whole, the block's noise ids are those of its rows in the
whole operand: logical row tile ``(origin + r) // tile_r`` with the whole
operand's ``tile_r``, counter ``((origin + r) % tile_r) * tile_c + ...``,
and the whole operand's content word.  Held here on the CPU, bitwise, for
the three organizations' analog channels:

* the kernel's plain twin (``photonic_gemm_twin`` / ``_fused_twin``,
  ``r_origin``), at origins on and off the row tile;
* the ``ref`` oracle (``photonic_gemm_ref(rows=)``);
* the engine (``PhotonicEngine.int_gemm(rows=, x_word=)``) on the
  ``kernel`` (twin) and ``ref`` backends, unfused and fused;
* ``engine._stream_gemm`` on a rank's block of two batch rows' positions
  (one launch a batch row, ``sharding.row_segments``);
* the content word: the blocks' words summed mod 2^32 are the whole
  operand's.

The CUDA kernel at an ``r_origin`` is held to its twin on the card
(``chip_smoke.py``, phase 10 (a'')).
"""

import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from repro_torch.core.dpu import DPUConfig, quant_scale, quantize_with_scale  # noqa: E402
from repro_torch.kernels.photonic_gemm.kernel import photonic_gemm_fused_twin, photonic_gemm_twin  # noqa: E402
from repro_torch.kernels.photonic_gemm.ref import photonic_gemm_ref  # noqa: E402
from repro_torch.noise.channel import build_channel_model  # noqa: E402
from repro_torch.noise.stages import U32, tweak_word  # noqa: E402
from repro_torch.photonic import EpilogueArgs, EpilogueSpec, PhotonicEngine  # noqa: E402

ORGS = ("SMWA", "ASMW", "MASW")
NOISY = dict(slice_bits=4, num_slices=2, n_chunk=64, adc_bits=8, noise_sigma=0.7, filter_alpha=0.1,
             intermod_eps=0.02, crossweight_eps=0.03, valid_chunks=4, tile_r=16, tile_c=128, tile_k=128)
ROWS = 64  # the whole operand's rows in the twin cases: four row tiles of 16
K_TWIN, C_TWIN = 128, 256  # the twin cases' fan-in and columns (two column tiles)
# (origin, rows): on a tile, off it (across two tiles), the last block
BLOCKS = ((16, 16), (5, 24), (37, 27))


def _engine(org, backend):
    dpu = DPUConfig(organization=org, bits=4, dpe_size=16, channel=build_channel_model(org, n=16), noise_seed=3)
    return PhotonicEngine(dpu=dpu, backend=backend)


def _operands(seed, r, k, c):
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(-127, 128, (r, k), generator=g).to(torch.int8)
    w = torch.randint(-127, 128, (k, c), generator=g).to(torch.int8)
    return g, x, w


@pytest.mark.parametrize("fused", [0, 1])
@pytest.mark.parametrize("origin,n", BLOCKS)
def test_the_twin_at_a_row_origin_is_those_rows_of_the_whole(origin, n, fused):
    g, x, w = _operands(origin + n, ROWS, K_TWIN, C_TWIN)
    pad = (-n) % NOISY["tile_r"]
    if fused:
        xf = torch.randn(ROWS, K_TWIN, generator=g)
        xs, ws, b = torch.tensor(0.03), torch.rand(C_TWIN, generator=g) + 0.5, torch.randn(C_TWIN, generator=g)
        whole = photonic_gemm_fused_twin(xf, w, xs, ws, b, 4321, activation="gelu", **NOISY)
        part = photonic_gemm_fused_twin(F.pad(xf[origin: origin + n], (0, 0, 0, pad)), w, xs, ws, b, 4321,
                                        activation="gelu", r_origin=origin, **NOISY)
    else:
        whole = photonic_gemm_twin(x, w, 4321, **NOISY)
        block = F.pad(x[origin: origin + n], (0, 0, 0, pad))
        part = photonic_gemm_twin(block, w, 4321, r_origin=origin, **NOISY)
        # without its origin the block draws the first tiles' noise
        assert not torch.equal(photonic_gemm_twin(block, w, 4321, **NOISY)[:n], whole[origin: origin + n])
    torch.testing.assert_close(part[:n], whole[origin: origin + n], rtol=0, atol=0)


def test_a_block_at_a_row_and_a_column_origin_is_that_block_of_the_whole():
    _, x, w = _operands(9, ROWS, K_TWIN, 384)
    whole = photonic_gemm_twin(x, w, 77, **NOISY)
    part = photonic_gemm_twin(F.pad(x[21:45], (0, 0, 0, 8)), w[:, 200:328].contiguous(), 77, r_origin=21,
                              c_origin=200, **NOISY)
    torch.testing.assert_close(part[:24], whole[21:45, 200:328], rtol=0, atol=0)


@pytest.mark.parametrize("org", ORGS)
def test_the_ref_oracle_at_a_row_origin_is_those_rows_of_the_whole(org):
    eng = _engine(org, "ref")
    ch = eng.dpu.effective_channel()
    _, x, w = _operands(3, 40, 96, 40)
    kw = dict(slice_bits=eng.dpu.bits, num_slices=eng.dpu.num_slices, n_chunk=eng.dpu.n, channel=ch, seed=99)
    whole = photonic_gemm_ref(x, w, **kw)
    for origin, n in ((8, 8), (11, 20)):
        part = photonic_gemm_ref(x[origin: origin + n], w, rows=(origin, 40), **kw)
        torch.testing.assert_close(part, whole[origin: origin + n], rtol=0, atol=0)
        both = photonic_gemm_ref(x[origin: origin + n], w[:, 5:25], rows=(origin, 40), columns=(5, 40), **kw)
        torch.testing.assert_close(both, whole[origin: origin + n, 5:25], rtol=0, atol=0)


@pytest.mark.parametrize("backend", ["kernel", "ref"])
@pytest.mark.parametrize("org", ORGS)
def test_int_gemm_with_rows_is_those_rows_of_the_whole(org, backend):
    """Rows of a 44-row operand (the kernel's row tile 16, from the whole's
    48 padded rows): on a tile, across two tiles from an origin off the
    tile, and the last block; unfused with the integer operand, fused with
    the float one."""
    eng = _engine(org, backend)
    g, x, w = _operands(5, 44, 48, 40)
    kw = dict(site="attn.wuk", fold=2, tile_r=16)
    whole = eng.int_gemm(x, w, **kw)
    word = tweak_word(x)
    xf = torch.randn(44, 48, generator=g)
    sx, sw = torch.tensor(0.02), torch.rand(40, generator=g) + 0.5
    ep = EpilogueArgs(EpilogueSpec(bias=False, activation=None), sx, sw, None)
    fused = eng.int_gemm(xf, w, epilogue=ep, **kw)
    fword = tweak_word(quantize_with_scale(xf, sx, eng.dpu.operand_bits))
    for origin, n in ((16, 16), (5, 22), (37, 7)):
        part = eng.int_gemm(x[origin: origin + n], w, rows=(origin, 44), x_word=word, **kw)
        torch.testing.assert_close(part, whole[origin: origin + n], rtol=0, atol=0)
        part = eng.int_gemm(xf[origin: origin + n], w, epilogue=ep, rows=(origin, 44), x_word=fword, **kw)
        torch.testing.assert_close(part, fused[origin: origin + n], rtol=0, atol=0)
    # the block's own word is another stream
    alone = eng.int_gemm(x[5:27], w, rows=(5, 44), **kw)
    assert not torch.equal(alone, whole[5:27])


def test_a_sliced_call_refuses_rows():
    eng = PhotonicEngine(dpu=_engine("SMWA", "kernel").dpu, backend="kernel", slicing=2)
    _, x, w = _operands(1, 8, 64, 16)
    with pytest.raises(ValueError, match="rows"):
        eng.int_gemm(x, w, rows=(8, 16))


@pytest.mark.parametrize("backend", ["kernel", "ref"])
def test_a_blocks_positions_of_two_batch_rows_are_those_rows_of_the_whole(backend, monkeypatch):
    """``_stream_gemm`` on this rank's block (positions 16-31 of 32) of two
    batch rows' latent rows under a ``kv_seq`` placement: one launch a
    batch row at its origin, the whole operand's word (the word's SUM
    all-reduce stood in for by the whole operand's word)."""
    from repro_torch.kernels.photonic_gemm import kernel as K
    from repro_torch.photonic.engine import _stream_gemm
    from repro_torch.runtime import sharding as shd

    eng = _engine("SMWA", backend)
    g = torch.Generator().manual_seed(11)
    c = torch.randn(2, 32, 96, generator=g)
    _, _, w = _operands(12, 8, 96, 64)
    sw = torch.rand(64, generator=g) + 0.5
    spec = EpilogueSpec(bias=False)
    whole = _stream_gemm(eng, "attn.wuv", spec, c, w, sw, None, 1)
    xs = quantize_with_scale(c.reshape(-1, 96), quant_scale(c.reshape(-1, 96), 8), 8)
    calls = []
    monkeypatch.setattr(shd, "rows_word", lambda word: tweak_word(xs))
    monkeypatch.setattr(shd, "activation_amax", lambda x, k_block=None: c.abs().max())
    monkeypatch.setattr(K, "photonic_gemm_fused_twin", lambda *a, **k: calls.append(k["r_origin"]) or
                        _twin(*a, **k))
    pl = shd.Placement(None, {"kv_seq": shd.Block("data", 1, 2, 32)})
    with shd.reenter(pl), shd.rows_over("kv_seq"):
        part = _stream_gemm(eng, "attn.wuv", spec, c[:, 16:].contiguous(), w, sw, None, 1)
    torch.testing.assert_close(part, whole[:, 16:], rtol=0, atol=0)
    assert calls == ([16, 48] if backend == "kernel" else [])


_twin = photonic_gemm_fused_twin


def test_the_blocks_words_sum_to_the_whole_operands_word():
    _, x, _ = _operands(4, 96, 64, 8)
    words = [tweak_word(b) for b in x.split([17, 40, 39])]
    assert int(sum(int(w) for w in words) & U32) == int(tweak_word(x))


# ---------------------------------------------------------------------------
# On the card: the CUDA kernel at a row origin
# ---------------------------------------------------------------------------
# (tile_r, whole rows, origin, rows): 8-row CTAs on 16-row tiles, and 64-row
# CTAs on 64-row tiles straddling two of them
CARD_BLOCKS = ((16, 64, 16, 16), (16, 64, 5, 24), (16, 64, 37, 27), (64, 256, 37, 120), (64, 256, 128, 128))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [0, 1])
@pytest.mark.parametrize("tile_r,total,origin,n", CARD_BLOCKS)
def test_the_cuda_kernel_at_a_row_origin_is_those_rows_of_its_whole_launch(tile_r, total, origin, n, fused):
    """The kernel's launch on a block of rows at its ``r_origin`` (live rows
    ``n``, padded to the row tile) is bitwise those rows of its launch on
    the whole operand, and within the noise draws' last-ulp roundings of its
    twin at the same origin."""
    from repro_torch.kernels.photonic_gemm import kernel as K

    dev = _card()
    st = dict(NOISY, tile_r=tile_r)
    g, x, w = _operands(origin + n + tile_r, total, 256, 256)
    x, w = x.to(dev), w.to(dev)
    pad = (-n) % tile_r
    if fused:
        xf = torch.randn(total, 256, generator=g).to(dev)
        xs, ws = torch.tensor([0.03], device=dev), (torch.rand(256, generator=g) + 0.5).to(dev)
        whole = K.photonic_gemm_fused(xf, w, xs, ws, None, 4321, **st)
        block = F.pad(xf[origin: origin + n], (0, 0, 0, pad))
        part = K.photonic_gemm_fused(block, w, xs, ws, None, 4321, rows=n, r_origin=origin, **st)[:n]
        twin = K.photonic_gemm_fused_twin(block, w, xs, ws, None, 4321, r_origin=origin, **st)[:n]
        close = float(torch.isclose(part, twin, rtol=1e-5, atol=1e-5).float().mean())
    else:
        whole = K.photonic_gemm(x, w, 4321, **st)
        block = F.pad(x[origin: origin + n], (0, 0, 0, pad))
        part = K.photonic_gemm(block, w, 4321, rows=n, r_origin=origin, **st)[:n]
        twin = K.photonic_gemm_twin(block, w, 4321, r_origin=origin, **st)[:n]
        close = float(((part - twin).abs() <= 2 ** (st["slice_bits"] * 2)).float().mean())
    assert torch.equal(part, whole[origin: origin + n])
    assert close >= 0.99
