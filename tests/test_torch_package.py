"""The PyTorch port's package boundary and device rules.

* ``import repro_torch`` (every module of it) loads no ``jax`` and no
  module of ``repro`` — checked in a fresh interpreter, since this test
  session has both loaded — and no file under ``src/repro_torch`` imports
  either (AST scan);
* entry points, the examples among them, run on CUDA unless asked for
  the CPU and raise without a CUDA device: they never fall back;
* the kernel wrappers take the plain twin only for CPU tensors.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import resolve_device  # noqa: E402
from repro_torch.kernels.photonic_gemm import kernel as K  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    for f in sorted(PKG.rglob("*.py")):
        rel = f.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def test_import_loads_no_jax_and_no_repro():
    code = (
        "import importlib, sys\n"
        f"for m in {list(_modules())!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro') "
        "or m.startswith(('jax.', 'jaxlib', 'repro.')))\n"
        "print('BAD', bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        timeout=120, check=True,
    )
    assert "BAD []" in out.stdout, out.stdout + out.stderr


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")), ids=lambda p: str(p.relative_to(PKG)))
def test_no_file_imports_jax_or_repro(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for n in names:
            root = n.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), f"{path}: imports {n}"


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA behaviour; this machine has a CUDA device")
    from repro_torch.models import registry
    from repro_torch.models.common import init_params
    from repro_torch.serving import Scheduler, ServingConfig

    arch = registry.get("qwen2-0.5b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(arch.smoke_config, 0)
    params = init_params(arch.smoke_config, 0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Scheduler(arch, arch.smoke_config, params, ServingConfig())
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("name", ["quickstart", "serve_lm", "train_lm", "map_workload", "paper_repro"])
def test_examples_default_to_cuda_and_raise_without_it(name, capsys):
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA behaviour; a CUDA device is present")
    import importlib

    example = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        example.main([])
    assert capsys.readouterr().out == ""  # nothing printed before the device is resolved


def test_wrappers_take_the_twin_only_for_cpu_tensors():
    x = torch.randint(-127, 128, (8, 128), dtype=torch.int8)
    w = torch.randint(-127, 128, (128, 128), dtype=torch.int8)
    K.reset_launches()
    y = K.photonic_gemm(x, w, tile_r=8, tile_k=128)
    assert y.dtype == torch.int32 and torch.equal(y, K.photonic_gemm_twin(x, w, tile_r=8, tile_k=128))
    assert K.LAUNCHES == {"photonic_gemm_fused": 0, "photonic_gemm": 0}  # the twin is no launch
    with pytest.raises(ValueError, match="CPU \\(twin\\) or CUDA"):
        K.photonic_gemm(x.to("meta"), w.to("meta"), tile_r=8, tile_k=128)
    xs = torch.ones((1,))
    with pytest.raises(ValueError, match="CPU \\(twin\\) or CUDA"):
        K.photonic_gemm_fused(
            x.float().to("meta"), w.to("meta"), xs.to("meta"), torch.ones(128, device="meta"),
            tile_r=8, tile_k=128,
        )


def test_wrappers_reject_shapes_off_the_tiling():
    x = torch.zeros((8, 100), dtype=torch.int8)
    w = torch.zeros((100, 128), dtype=torch.int8)
    with pytest.raises(ValueError, match="multiples of the tiles"):
        K.photonic_gemm(x, w, tile_r=8, tile_k=128)
    with pytest.raises(ValueError, match="requires a seed"):
        K.photonic_gemm(
            torch.zeros((8, 128), dtype=torch.int8), torch.zeros((128, 128), dtype=torch.int8),
            tile_r=8, tile_k=128, n_chunk=64, noise_sigma=1.0,
        )


def test_build_dir_is_git_ignored_and_keyed_by_source():
    from repro_torch.kernels._build import build_dir
    from repro_torch.kernels.flash_attention import kernel as F

    bd = build_dir()
    assert bd == ROOT / "build" / "repro_torch"
    assert "build/" in (ROOT / ".gitignore").read_text().split()
    paths = {lib.path() for lib in (K.LIBRARY, F.LIBRARY)}
    assert len(paths) == 2 and all(p.parent == bd and p.suffix == ".so" for p in paths)


def test_serving_entry_point_and_flash_surface_load_no_jax_alone():
    code = (
        "import sys\n"
        "import repro_torch.runtime.serve, repro_torch.photonic.flash\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro') "
        "or m.startswith(('jax.', 'jaxlib', 'repro.')))\n"
        "print('BAD', bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        timeout=120, check=True,
    )
    assert "BAD []" in out.stdout, out.stdout + out.stderr


def test_training_entry_point_loads_no_jax_alone():
    code = (
        "import sys\n"
        "import repro_torch.runtime.train_loop, repro_torch.weights\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro') "
        "or m.startswith(('jax.', 'jaxlib', 'repro.')))\n"
        "print('BAD', bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        timeout=120, check=True,
    )
    assert "BAD []" in out.stdout, out.stdout + out.stderr


def test_training_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA behaviour; this machine has a CUDA device")
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens, make_global_batch
    from repro_torch.models import registry
    from repro_torch.runtime.train_loop import TrainConfig, train

    arch = registry.get("qwen2-0.5b")
    data = DataConfig(vocab_size=arch.smoke_config.vocab_size, seq_len=8, global_batch=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_global_batch(SyntheticTokens(data), 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(arch=arch, model_cfg=arch.smoke_config, data_cfg=data,
              train_cfg=TrainConfig(steps=1, ckpt_dir=str(tmp_path)), log=lambda m: None)
    assert not any(tmp_path.iterdir())
