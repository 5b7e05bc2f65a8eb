"""The port's tooling tier against the JAX reference: the registry's shape
surface, the ``with_logical`` sites' sharding fallbacks, the collective
pricing, the contract checker, ``Scheduler.decode_checker`` and the launch
profile.

Held here:

* ``SHAPES``, ``names()`` and ``Arch.ladder`` (published and smoke configs)
  equal the reference's; ``train_batch_spec`` / ``prefill_batch_spec`` /
  ``decode_specs`` give the reference's shapes, dtypes and logical axes
  for every arch at every shape it does not skip;
* a forward under ``use_rules`` on a (data, model) = (2, 4) mesh records
  the same multiset of ``fallback_log()`` entries as the reference's on
  eight forced host devices (a JAX subprocess), for qwen2, whisper, xlstm
  and zamba2.  The reference scans its layers and so resolves a scanned
  body's constraints once; the configs set every scan's trip count to one
  (one layer, group or encoder layer), where the port's loop runs each
  body once too;
* ``_wire_bytes`` equal to the reference's for every kind, g in {2, 4, 16};
  ``collective_summary`` over a four-rank ``gloo`` group's all-reduce,
  all-gather, reduce-scatter and ring hop equal to the formula's bytes;
* the reference's ``TestContractChecker`` cases that have a counterpart
  (not the HLO bridge): zero weight rounds on a packed matmul, the per-call
  path's rounds, one all-reduce per ``psum_int_gemm`` (the four-rank
  group), the seed-source error; the ``decode_checker`` cases of
  ``tests/test_serving.py``; the kernels' launch record; ``dispatch_summary``
  of a CPU profile;
* the launch profile: a user's allocator option and log level win, and
  ``child_env`` adds tcmalloc's preload only where it exists;
* ``dryrun.account`` of one smoke-size training step (qwen2, xlstm; SMWA
  on the ``ref`` backend) run for real and under fake tensors: the same
  FLOPs, argument, output and GEMM-traffic bytes and the same aten op
  stream (``chip_smoke.py`` makes this check at full width on the card);
* ``xlstm_prefill``, ``zamba2_prefill``, ``lm_prefill`` (dense, MLA with its
  first block, vision) and ``whisper_prefill`` at zero layers (the ladder's
  ``zero`` rung) return the reference's logits and its zero-length stacked
  caches; they raised ``IndexError`` before.
"""

import collections
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.launch import hlo_analysis as jhlo  # noqa: E402
from repro.models.common import init_tree  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch.analysis import ContractChecker, ContractViolation  # noqa: E402
from repro_torch.core.dpu import DPUConfig  # noqa: E402
from repro_torch.launch import hlo_analysis, profile  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models.common import init_params  # noqa: E402
from repro_torch.noise.channel import build_channel_model  # noqa: E402
from repro_torch.photonic import engine_for, pack_dense  # noqa: E402
from repro_torch.runtime import sharding as tshd  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = sorted(jreg.names())
RNG = np.random.default_rng(0)


# ---------------------------------------------------------------------------
# The registry's shape surface
# ---------------------------------------------------------------------------
def test_shapes_and_names_equal_the_reference():
    assert treg.names() == jreg.names()
    assert {k: dataclasses.astuple(v) for k, v in treg.SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in jreg.SHAPES.items()}


@pytest.mark.parametrize("name", ARCHS)
def test_ladder_equals_the_reference(name):
    ta, ja = treg.get(name), jreg.get(name)
    for tcfg, jcfg in ((ta.config, ja.config), (ta.smoke_config, ja.smoke_config)):
        assert ta.ladder(tcfg) == ja.ladder(jcfg)


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "") if isinstance(dt, torch.dtype) else jnp.dtype(dt).name


def _flat(tree, path=""):
    """``{path: leaf}``, an axes tuple (names and None) being a leaf."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}"))
        return out
    if isinstance(tree, (list, tuple)) and not all(a is None or isinstance(a, str) for a in tree):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{path}/{i}"))
        return out
    return {path: tree}


def _specs(tree):
    return {k: (tuple(v.shape), _dtype_name(v.dtype)) for k, v in _flat(tree).items()}


@pytest.mark.parametrize("name", ARCHS)
def test_input_specs_equal_the_reference(name):
    ta, ja = treg.get(name), jreg.get(name)
    for shape_name in treg.SHAPES:
        if shape_name in ja.skip_shapes:
            continue
        ts, js = treg.SHAPES[shape_name], jreg.SHAPES[shape_name]
        for fn in ("train_batch_spec", "prefill_batch_spec"):
            (tspec, taxes), (jspec, jaxes) = getattr(ta, fn)(ta.config, ts), getattr(ja, fn)(ja.config, js)
            assert _specs(tspec) == _specs(jspec), (name, shape_name, fn)
            assert _flat(taxes) == _flat(jaxes), (name, shape_name, fn)
        ((ttok, ttok_ax), (tcache, tcache_ax)) = ta.decode_specs(ta.config, ts)
        ((jtok, jtok_ax), (jcache, jcache_ax)) = ja.decode_specs(ja.config, js)
        assert _specs(ttok) == _specs(jtok) and ttok_ax == jtok_ax
        assert _specs(tcache) == _specs(jcache), (name, shape_name)
        assert _flat(tcache_ax) == _flat(jcache_ax), (name, shape_name)


def test_make_arch_goes_through_register():
    arch = treg.get("qwen2-0.5b")
    assert treg.register(arch) is arch and treg.get(arch.name) is arch
    assert treg.TensorSpec((2, 3), torch.bfloat16).nbytes == 12


# ---------------------------------------------------------------------------
# with_logical sites: fallbacks on a mesh that forces them
# ---------------------------------------------------------------------------
# One body per scan: the reference resolves a scanned body's constraints once.
FALLBACK_ARCHS = {
    "qwen2-0.5b": {"num_layers": 1},
    "whisper-medium": {"encoder_layers": 1, "num_layers": 1},
    "xlstm-350m": {"num_layers": 2, "slstm_every": 2},
    "zamba2-2.7b": {"num_layers": 1, "attn_every": 1},
}
FALLBACK_BATCH, FALLBACK_T, FALLBACK_T_ENC = 1, 6, 10

_REFERENCE_FALLBACKS = r"""
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.compat import Mesh
from repro.models import registry, whisper, xlstm, zamba2, lm
from repro.models.common import init_tree
from repro.runtime import sharding as shd

archs, b, t, t_enc = json.loads(sys.argv[1])
mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
out = {}
for name, ov in archs.items():
    arch = registry.get(name)
    cfg = dataclasses.replace(arch.smoke_config, **ov)
    params = jax.eval_shape(lambda k: init_tree(arch.param_defs(cfg), k, cfg.param_dtype),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    tokens = jax.ShapeDtypeStruct((b, t), jnp.int32)
    fwd = {"dense": lambda p, x: lm.lm_logits(p, x, cfg),
           "ssm": lambda p, x: xlstm.xlstm_logits(p, x, cfg),
           "hybrid": lambda p, x: zamba2.zamba2_logits(p, x, cfg),
           "audio": lambda p, x: whisper.whisper_logits(
               p, {"tokens": x, "audio_embed": jnp.zeros((b, t_enc, cfg.d_model), cfg.compute_dtype)}, cfg)}
    with shd.use_rules(mesh, cfg.logical_rules):
        jax.eval_shape(fwd[arch.family], params, tokens)
        out[name] = [[list(s), n, a if isinstance(a, str) else list(a), d, z] for s, n, a, d, z in shd.fallback_log()]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_fallbacks():
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8", JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    args = json.dumps([FALLBACK_ARCHS, FALLBACK_BATCH, FALLBACK_T, FALLBACK_T_ENC])
    run = subprocess.run([sys.executable, "-c", _REFERENCE_FALLBACKS, args], env=env, check=True, timeout=300,
                         capture_output=True, text=True)
    return json.loads(run.stdout.strip().splitlines()[-1])


def _entries(log):
    return collections.Counter(
        (tuple(s), n, a if isinstance(a, str) else tuple(a), d, z) for s, n, a, d, z in log)


@pytest.mark.parametrize("name", sorted(FALLBACK_ARCHS))
def test_fallbacks_equal_the_reference(name, reference_fallbacks):
    arch = treg.get(name)
    cfg = dataclasses.replace(arch.smoke_config, **FALLBACK_ARCHS[name])
    params = init_params(cfg, 0, device="cpu", defs=arch.param_defs(cfg))
    tokens = torch.zeros((FALLBACK_BATCH, FALLBACK_T), dtype=torch.int64)
    batch = {"tokens": tokens, "labels": tokens}
    if arch.family == "audio":
        batch["audio_embed"] = torch.zeros((FALLBACK_BATCH, FALLBACK_T_ENC, cfg.d_model), dtype=cfg.compute_dtype)
    with torch.no_grad(), tshd.use_rules(tshd.abstract_mesh((2, 4), ("data", "model")), cfg.logical_rules):
        arch.loss(params, batch, cfg)
        got = tshd.fallback_log()
    want = _entries(reference_fallbacks[name])
    assert want, "the mesh must force at least one fallback"
    assert _entries(got) == want


def test_with_logical_is_the_identity_outside_a_scope():
    x = torch.randn(2, 3, 4)
    from repro_torch.models.common import with_logical

    before = tshd.fallback_log()  # the last scope's log stays readable after it
    assert with_logical(x, ("batch", "seq_sp", None)) is x
    assert tshd.fallback_log() == before


# ---------------------------------------------------------------------------
# Collective pricing
# ---------------------------------------------------------------------------
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute", "all-gather-start",
         "all-reduce-start", "collective-permute-start", "other")


@pytest.mark.parametrize("g", [2, 4, 16, None])
def test_wire_bytes_equal_the_reference(g):
    for kind in KINDS:
        for out_bytes in (0.0, 12.0, 4096.0, 3.5e9):
            assert hlo_analysis._wire_bytes(kind, out_bytes, g) == jhlo._wire_bytes(kind, out_bytes, g)


@pytest.fixture(scope="module")
def quad():
    import _torch_tooling_ranks as ranks

    return spawn(ranks.collectives_suite, 4, backend="gloo", timeout=300)


def test_collective_summary_prices_known_collectives(quad):
    import _torch_tooling_ranks as ranks

    g = 4
    sizes = {k: n * dt.itemsize for k, (n, dt) in ranks.SIZES.items()}
    want_records = [("all-reduce", sizes["all_reduce"], g), ("all-gather", sizes["all_gather"] * g, g),
                    ("reduce-scatter", sizes["reduce_scatter"], g), ("collective-permute", sizes["send"], g),
                    ("recv", sizes["send"], g)]
    want = {
        "bytes_all-reduce": 2 * (g - 1) / g * sizes["all_reduce"],
        "bytes_all-gather": (g - 1) / g * sizes["all_gather"] * g,
        "bytes_reduce-scatter": sizes["reduce_scatter"] * (g - 1),
        "bytes_collective-permute": float(sizes["send"]),
    }
    for r in quad:
        assert r["values_ok"]
        assert sorted(r["records"]) == sorted(want_records)
        summary = r["summary"]
        for k, v in want.items():
            assert summary[k] == v
            assert summary["count_" + k[len("bytes_"):]] == 1.0
        assert summary["total_wire_bytes"] == sum(want.values())


def test_psum_per_routed_gemm_on_a_group(quad):
    for r in quad:
        assert r["psum_counts"] == [1, 2]
        assert r["mismatch_raises"]
        assert r["psum_wire_bytes"] == 2 * (2 * 3 / 4 * 4 * 16 * 4)  # two int32 (4, 16) partials


# ---------------------------------------------------------------------------
# ContractChecker (tests/test_analysis.py::TestContractChecker's counterparts)
# ---------------------------------------------------------------------------
def _engine():
    return engine_for(DPUConfig(organization="SMWA", bits=4, datarate_gs=5.0), "ref")


def _operands():
    w = torch.from_numpy(RNG.normal(size=(64, 48)).astype(np.float32))
    x = torch.from_numpy(RNG.normal(size=(4, 64)).astype(np.float32))
    return x, w


def test_decode_zero_quant_on_packed_path():
    eng = _engine()
    x, w = _operands()
    packed = pack_dense({"w": w}, eng)["w"]
    checker = ContractChecker.record(lambda a, p: eng.matmul(a, p, site="ffn.wi"), x, packed)
    assert checker.weight_round_ops(64 * 48) == 0
    checker.assert_zero_weight_rounds(64 * 48)  # must not raise
    assert checker.weight_round_ops(1) > 0  # the activation's rounds, below the weight size
    assert checker.count("round") == checker.primitive_counts()["round"]


def test_per_call_path_violates_and_raises():
    eng = _engine()
    x, w = _operands()
    checker = ContractChecker.record(lambda a, b: eng.matmul_float(a, b, site="ffn.wi"), x, w)
    assert checker.weight_round_ops(64 * 48) > 0
    with pytest.raises(ContractViolation, match="weight-stationary"):
        checker.assert_zero_weight_rounds(64 * 48)


def test_noisy_channel_unrunnable_without_source():
    ch = build_channel_model("SMWA", n=21, bits=4, datarate_gs=5.0)
    eng = engine_for(DPUConfig(dpe_size=21, channel=ch), "ref")  # no seed
    x, w = torch.zeros((2, 21)), torch.zeros((21, 8))
    ContractChecker.assert_untraceable_without_source(lambda a, b: eng.matmul_float(a, b, site="ffn.wi"), x, w)


def test_seeded_noisy_channel_runs_and_hatch_detects_it():
    ch = build_channel_model("SMWA", n=21, bits=4, datarate_gs=5.0)
    eng = engine_for(DPUConfig(dpe_size=21, channel=ch, noise_seed=7), "ref")
    x, w = torch.zeros((2, 21)), torch.zeros((21, 8))
    with pytest.raises(ContractViolation, match="without a key source"):
        ContractChecker.assert_untraceable_without_source(lambda a, b: eng.matmul_float(a, b, site="ffn.wi"), x, w)


def test_matmul_traffic_and_the_launch_record():
    from repro_torch.kernels.flash_attention import kernel as F
    from repro_torch.kernels.photonic_gemm import kernel as K

    a, b = torch.ones(8, 16), torch.ones(16, 32)
    checker = ContractChecker.record(torch.matmul, a, b)
    assert checker.matmul_traffic_bytes() == (8 * 16 + 16 * 32 + 8 * 32) * 4
    assert checker.launches == {"photonic_gemm_fused": 0, "photonic_gemm": 0, "flash_attention": 0}
    # The wrappers tell every recorder of a launch; the card's launches reach
    # them there (tests/test_torch_photonic_gemm.py and chip_smoke.py).
    xq, wq, out = torch.zeros(4, 64, dtype=torch.int8), torch.zeros(64, 128, dtype=torch.int8), torch.zeros(4, 128)
    with hlo_analysis.Recorder() as rec:
        assert len(K.LAUNCH_RECORDERS) == 1 and len(F.LAUNCH_RECORDERS) == 1
        K.LAUNCH_RECORDERS[0]("photonic_gemm_fused", xq, wq, out, 3)
        q = torch.zeros(1, 8, 2, 16)
        F.LAUNCH_RECORDERS[0]("flash_attention", q, q, q, q)
    assert not K.LAUNCH_RECORDERS and not F.LAUNCH_RECORDERS
    assert [r.name for r in rec.launches] == ["photonic_gemm_fused", "flash_attention"]
    assert rec.launches[0].rows == 3
    assert hlo_analysis.matmul_traffic_bytes([], rec.launches) == 4 * 64 + 64 * 128 + 4 * 128 * 4


def test_dispatch_summary_of_a_cpu_profile():
    from torch.profiler import ProfilerActivity, profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    got = hlo_analysis.dispatch_summary(prof, wall_ms=1.0)
    assert got["device_events"] == 0 and got["launch_calls"] == 0 and got["photonic_launches"] == 0
    assert got["busy_share"] is None and got["top_host_ops"]
    assert hlo_analysis.dispatch_summary(prof.key_averages(), wall_ms=1.0) == got  # the caller's key averages


# ---------------------------------------------------------------------------
# Scheduler.decode_checker (tests/test_serving.py::TestWeightStationaryDecode)
# ---------------------------------------------------------------------------
def test_paged_decode_has_zero_weight_rounds():
    from repro_torch.serving import Scheduler, ServingConfig

    arch = treg.get("qwen2-0.5b")
    cfg = dataclasses.replace(arch.smoke_config, photonic=DPUConfig(organization="SMWA", bits=4, datarate_gs=5.0),
                              photonic_backend="ref")
    params = init_params(cfg, 0, device="cpu")
    sch = Scheduler(arch, cfg, params, ServingConfig(batch_size=2, max_seq=32, block_size=8), device="cpu")
    min_w = cfg.d_model * cfg.d_ff // 2
    checker = sch.decode_checker()
    assert checker.label == "paged_decode" and checker.output[0].shape[:2] == (2, 1)
    checker.assert_zero_weight_rounds(min_w)
    assert sch.decode_weight_rounds() == 0
    # positive control: the same step over per-call (unpacked) params
    # quantizes weights every call
    sch.params = params
    assert sch.decode_checker().weight_round_ops(min_w) > 0
    assert sch.decode_weight_rounds() > 0


# ---------------------------------------------------------------------------
# Launch profile (tests/test_fused_hotpath.py::TestLaunchProfile's counterparts)
# ---------------------------------------------------------------------------
def test_merge_user_options_win(monkeypatch):
    monkeypatch.setenv("PYTORCH_CUDA_ALLOC_CONF", "max_split_size_mb:64,foo:1")
    merged = profile._merge_alloc_conf(["max_split_size_mb:128", "bar:0"])
    opts = dict(o.split(":", 1) for o in merged.split(","))
    assert opts == {"max_split_size_mb": "64", "foo": "1", "bar": "0"}
    assert os.environ["PYTORCH_CUDA_ALLOC_CONF"] == merged


def test_apply_returns_describe_and_defaults_never_override(monkeypatch):
    monkeypatch.delenv("TORCH_CPP_LOG_LEVEL", raising=False)
    monkeypatch.setenv("NCCL_DEBUG", "INFO")
    monkeypatch.delenv("PYTORCH_CUDA_ALLOC_CONF", raising=False)
    desc = profile.apply()
    assert desc["torch_cpp_log_level"] == "ERROR" and desc["nccl_debug"] == "INFO"
    assert desc["pytorch_cuda_alloc_conf"] is None  # the curated list is empty
    assert desc["tf32_matmul"] is False and desc["cudnn_benchmark"] is False
    assert desc["build_dir"].endswith(os.path.join("build", "repro_torch"))
    assert desc == dict(profile.describe(), card=desc["card"])


def test_child_env_adds_tcmalloc_only_where_it_exists(monkeypatch):
    monkeypatch.delenv("LD_PRELOAD", raising=False)
    env = profile.child_env({"PATH": "/usr/bin"})
    assert env["PATH"] == "/usr/bin" and env["TORCH_CPP_LOG_LEVEL"] == "ERROR"
    lib = profile.find_tcmalloc()
    if lib is not None:
        assert lib in env.get("LD_PRELOAD", "")
    else:
        assert "LD_PRELOAD" not in env
    monkeypatch.setattr(profile, "find_tcmalloc", lambda: "/usr/lib/libtcmalloc.so.4")
    assert profile.child_env({"LD_PRELOAD": "/a.so"})["LD_PRELOAD"] == "/a.so:/usr/lib/libtcmalloc.so.4"
    assert profile.child_env({"LD_PRELOAD": "/x/libtcmalloc.so"})["LD_PRELOAD"] == "/x/libtcmalloc.so"
    monkeypatch.setattr(profile, "find_tcmalloc", lambda: None)
    assert "LD_PRELOAD" not in profile.child_env({})


# ---------------------------------------------------------------------------
# Prefill at zero layers (the ladder's zero rung, where the dry run found it raising)
# ---------------------------------------------------------------------------
ZERO = {
    "qwen2-0.5b": {"num_layers": 0},
    "deepseek-v2-lite-16b": {"num_layers": 1},  # the first (dense) block only
    "llama-3.2-vision-90b": {"num_layers": 0},
    "whisper-medium": {"num_layers": 0},
    "xlstm-350m": {"num_layers": 0},
    "zamba2-2.7b": {"num_layers": 0},
}


def _np(t):
    return t.detach().to(torch.float32).numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _flat_cache(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_cache(v, f"{path}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat_cache(v, f"{path}/{i}"))
        return out
    return {path: tree}


@pytest.mark.parametrize("name", sorted(ZERO))
def test_prefill_at_zero_layers_equals_the_reference(name):
    ja, ta = jreg.get(name), treg.get(name)
    jcfg = dataclasses.replace(ja.smoke_config, **ZERO[name])
    tcfg = dataclasses.replace(ta.smoke_config, **ZERO[name])
    jparams = jax.tree.map(np.asarray, init_tree(ja.param_defs(jcfg), jax.random.PRNGKey(0), jcfg.param_dtype))
    tparams = params_from_jax(jparams, tcfg, "cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, tcfg.vocab_size, (2, 8)).astype(np.int32)
    jbatch, tbatch = {"tokens": jnp.asarray(tokens)}, {"tokens": torch.from_numpy(tokens).long()}
    if ta.family == "vlm":
        v = rng.normal(size=(2, tcfg.vision_seq, tcfg.d_model)).astype(np.float32)
        jbatch["vision"], tbatch["vision"] = jnp.asarray(v), torch.from_numpy(v)
    if ta.family == "audio":
        a = rng.normal(size=(2, 12, tcfg.d_model)).astype(np.float32)
        jbatch["audio_embed"], tbatch["audio_embed"] = jnp.asarray(a), torch.from_numpy(a)
    jlogits, jcache = jax.jit(lambda p, b: ja.prefill(p, b, jcfg, 16))(jparams, jbatch)
    with torch.no_grad():
        tlogits, tcache = ta.prefill(tparams, tbatch, tcfg, 16)
    np.testing.assert_allclose(_np(tlogits), np.asarray(jlogits, np.float32), rtol=1e-5, atol=1e-5)
    jflat, tflat = _flat_cache(jcache), _flat_cache(tcache)
    assert sorted(jflat) == sorted(tflat)
    for k, jv in jflat.items():
        tv = tflat[k]
        if k.endswith("/pos"):
            assert int(tv) == int(jv)
            continue
        assert tuple(tv.shape) == tuple(jv.shape), k
        assert str(tv.dtype).replace("torch.", "") == jnp.dtype(jv.dtype).name, k
        np.testing.assert_allclose(_np(tv), np.asarray(jv, np.float32), rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", ["qwen2-0.5b", "xlstm-350m"])
def test_account_of_a_fake_step_equals_the_real_one(name):
    # the check that chip_smoke.py makes on the card, at a smoke size on the CPU:
    # one training step run for real and under fake tensors dispatches the same
    # aten ops in the same order (a fake tensor's .device query is not recorded)
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.data.pipeline import DataConfig, SyntheticTokens, make_global_batch
    from repro_torch.launch import dryrun
    from repro_torch.optim import adamw
    from repro_torch.runtime.train_loop import build_train_step

    arch = treg.get(name)
    cfg = dataclasses.replace(arch.smoke_config, photonic=DPUConfig(organization="SMWA", bits=4, datarate_gs=5.0),
                              photonic_backend="ref")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2, seed=0)
    step = build_train_step(lambda p, b: arch.loss(p, b, cfg),
                            adamw.AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=2))
    params = init_params(cfg, 0, "cpu", defs=arch.param_defs(cfg))
    real = dryrun.account(step, (params, adamw.init(params), make_global_batch(SyntheticTokens(data), 0, "cpu")))
    with FakeTensorMode(allow_non_fake_inputs=True):
        fp = dryrun.fake_params(arch.param_defs(cfg), cfg, "cpu")
        batch = dryrun.materialize(arch.train_batch_spec(cfg, treg.ShapeSpec("t", 16, 2, "train"))[0], "cpu")
        fake = dryrun.account(step, (fp, adamw.init(fp), batch))
    for key in ("flops_per_device", "argument_size_in_bytes", "output_size_in_bytes", "matmul_traffic_bytes",
                "aten_ops", "aten_op_counts", "aten_op_stream_sha256"):
        assert fake[key] == real[key], key
    assert "device" not in real["aten_op_counts"] and real["flops_per_device"] > 0
