"""The port's examples (``repro_torch.examples``) against the reference's
(``examples/``), on the CPU at the reference scripts' sizes.

* ``map_workload`` and ``paper_repro`` print the reference scripts' bytes
  (the scripts run as subprocesses, started when the module starts);
* ``quickstart``'s numbers equal the reference library's on the same
  inputs at their printed precision (the kernel line needs a card, and the
  engine's ``describe()`` names the port's backends);
* ``serve_lm`` gives every request's tokens equal to the reference
  ``Scheduler``'s on the same weights (``init_tree`` under ``PRNGKey(0)``),
  on the float path and on the SMWA path;
* ``train_lm --steps 3`` gives losses within ``rtol=1e-4`` of the
  reference ``train()``'s (the ``exact`` tier of the training tests).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ("map_workload", "paper_repro")


@pytest.fixture(scope="module", autouse=True)
def reference_scripts():
    """The reference scripts' stdout, run beside the rest of the module."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    procs = {name: subprocess.Popen([sys.executable, str(ROOT / "examples" / f"{name}.py")], cwd=ROOT, env=env,
                                    stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
             for name in SCRIPTS}
    try:
        yield procs
    finally:
        for p in procs.values():
            p.kill()
            p.wait()


def test_quickstart_numbers_equal_the_reference(capsys):
    from repro.core import scalability as jsc
    from repro.core.dpu import DPUConfig, noise_sigma_from_snr, photonic_matmul
    from repro.noise import build_channel_model
    from repro.photonic import engine_for, pack_dense
    from repro_torch.examples import quickstart

    got = quickstart.main(["--device", "cpu"])
    printed = capsys.readouterr().out
    assert "cuda kernel == twin: needs a card" in printed and got["kernel_equals_twin"] is None

    assert got["table_v"] == {org: [jsc.calibrated_max_n(org, 4, dr) for dr in (1, 5, 10)]
                              for org in ("ASMW", "MASW", "SMWA")}
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(64, 256)), jnp.float32)
    w = jnp.asarray(rng.normal(size=(256, 128)), jnp.float32)
    exact = x @ w

    def rel(y):
        return float(jnp.linalg.norm(y - exact) / jnp.linalg.norm(exact))

    def pm(cfg, **kw):  # jitted: the reference's eager datapath is ten times slower on the CPU
        return jax.jit(lambda a, b, **k: photonic_matmul(a, b, cfg, **k))(x, w, **kw)

    cfg = DPUConfig(organization="SMWA", bits=4, datarate_gs=5.0)
    assert got["operating_point"] == (cfg.n, cfg.m, cfg.num_slices, cfg.passes, cfg.num_chunks(256))
    assert f"{got['ideal_rel']:.4f}" == f"{rel(pm(cfg)):.4f}"
    for (mult, sigma, r), m in zip(got["noise"], (1.0, 4.0)):
        s = m * noise_sigma_from_snr(cfg)
        ncfg = DPUConfig(organization="SMWA", bits=4, datarate_gs=5.0, noise_sigma_lsb=s)
        want = rel(pm(ncfg, prng_key=jax.random.PRNGKey(0)))
        assert (mult, f"{sigma:.1f}", f"{r:.4f}") == (m, f"{s:.1f}", f"{want:.4f}")
    for org, vals in got["channels"].items():
        ch = build_channel_model(org, n=17, bits=4, datarate_gs=5.0)
        ocfg = DPUConfig(organization=org, bits=4, dpe_size=17, channel=ch, noise_seed=0)
        want = (ch.through_loss_db, ch.detector_sigma_lsb, ch.intermod_eps, ch.crossweight_eps, ch.filter_alpha,
                rel(pm(ocfg)))
        fmt = (".2f", ".1f", ".3f", ".3f", ".3f", ".4f")
        assert [format(v, f) for v, f in zip(vals, fmt)] == [format(v, f) for v, f in zip(want, fmt)], org
    eng = engine_for(cfg, "ref")
    packed = pack_dense({"w": w}, eng)["w"]
    want_equal = bool(jnp.array_equal(eng.matmul(x, packed, site="demo"), eng.matmul_float(x, w, site="demo")))
    assert got["prepacked_equal"] == want_equal
    assert got["routes"] == (eng.routes("ffn.wi"), eng.routes("ffn.router"))
    assert printed.count("\n") == 23


@pytest.fixture(scope="module")
def serve_runs():
    """The port example's tokens, and the reference ``Scheduler``'s on the
    example's inputs."""
    from repro.core.dpu import DPUConfig
    from repro.models import registry
    from repro.models.common import init_tree
    from repro.serving import Request, Scheduler, ServingConfig
    from repro_torch.examples import serve_lm

    port = serve_lm.main(["--device", "cpu"])
    arch = registry.get("qwen2-0.5b")
    cfg = dataclasses.replace(arch.smoke_config, remat=False)
    params = init_tree(arch.param_defs(cfg), jax.random.PRNGKey(0), cfg.param_dtype)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in serve_lm.PROMPT_LENGTHS]
    ref = {}
    for path, mcfg in (("float", cfg), ("photonic", dataclasses.replace(
            cfg, photonic=DPUConfig(organization="SMWA", bits=4, datarate_gs=5.0), photonic_backend="ref"))):
        s = serve_lm.SERVING
        sch = Scheduler(arch, mcfg, params, ServingConfig(batch_size=s.batch_size, max_seq=s.max_seq,
                                                          block_size=s.block_size, chunk_tokens=s.chunk_tokens))
        reqs = [Request(uid=i, prompt=p, max_new_tokens=8) for i, p in enumerate(prompts)]
        sch.run(reqs)
        ref[path] = [list(r.output) for r in reqs]
    return port, ref


@pytest.mark.parametrize("path", ["float", "photonic"])
def test_serve_lm_tokens_equal_the_reference(serve_runs, path):
    port, ref = serve_runs
    assert port[f"{path}_tokens"] == ref[path]
    assert all(len(t) == 8 for t in ref[path])


def test_train_lm_losses_match_the_reference(tmp_path):
    from repro.data.pipeline import DataConfig
    from repro.models import registry
    from repro.optim import adamw
    from repro.runtime.train_loop import TrainConfig, train
    from repro_torch.examples import train_lm

    port = train_lm.main(["--steps", "3", "--device", "cpu", "--ckpt-dir", str(tmp_path / "port")])
    arch = registry.get("qwen2-0.5b")
    cfg = dataclasses.replace(arch.smoke_config, num_layers=4, d_model=128, d_ff=256, num_heads=4,
                              num_kv_heads=2, vocab_size=512, remat=False)
    ref = train(arch=arch, model_cfg=cfg, data_cfg=DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8),
                train_cfg=TrainConfig(steps=3, ckpt_every=50, ckpt_dir=str(tmp_path / "ref")),
                opt_cfg=adamw.AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=3), log=lambda m: None)
    assert len(port["losses"]) == 3
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=1e-4)


@pytest.mark.parametrize("name", SCRIPTS)
def test_analytic_examples_print_the_reference_bytes(name, reference_scripts, capsys):
    import importlib

    importlib.import_module(f"repro_torch.examples.{name}").main(["--device", "cpu"])
    got = capsys.readouterr().out
    procs = reference_scripts
    stdout, _ = procs[name].communicate(timeout=300)
    assert procs[name].returncode == 0
    assert got == stdout.decode()
