"""The port's dry run (``repro_torch.launch.dryrun``) on a fake 256-rank
mesh.

Held here:

* ``python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape
  decode_32k --mesh single --device cpu`` writes an ``ok`` cell on a fake
  group of 256 ranks: ``padded_heads == 16`` (as the reference's
  ``tests/test_dryrun_integration.py`` asserts), ``num_kv_heads_effective``
  and ``param_count`` those of the reference's
  ``param_defs(config.pad_for_mesh(16))``, ``argument_size_in_bytes`` the
  sum of the rank's leaves (parameters, token, cache, and the 4-byte
  position the decode reads on the host), the ladder identity exact;
* the ladder identity ``flops = sum(coeff x rung flops)`` exactly, in
  integers, for one arch of each family at its smoke config and a small
  shape, train / prefill / decode.  One exception is a finding (ROADMAP
  Queue 3 item 17): training the audio family, the ``enc1`` rung has no
  decoder to read the encoder, so the encoder's backward (and its remat
  recompute) never runs there; the gap is exactly ``encoder_layers x`` that
  layer's backward, measured from two cells with a decoder;
* without ``--device cpu`` and without a card, the dry run raises;
* ``--no-zero1`` is refused: the port keeps optimizer moments replicated,
  so there is no ZeRO-1 to turn off.

The zero-layer prefills the dry run's ``zero`` rung found broken are held
in ``tests/test_torch_tooling.py``.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.models import registry as jreg  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models.common import P, _DTYPES  # noqa: E402
from repro_torch.models.registry import ShapeSpec  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _leaves(defs):
    if isinstance(defs, P):
        yield defs
    elif isinstance(defs, dict):
        for v in defs.values():
            yield from _leaves(v)
    else:
        for v in defs:
            yield from _leaves(v)


def _ref_param_count(defs):
    from repro.models.common import P as JP

    return sum(math.prod(leaf.shape) for leaf in jax.tree.leaves(defs, is_leaf=lambda x: isinstance(x, JP)))


def test_decode_cell_on_a_fake_256_rank_mesh(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen2-0.5b", "--shape", "decode_32k",
         "--mesh", "single", "--device", "cpu", "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    cell = json.loads((tmp_path / "qwen2-0_5b__decode_32k__single__base.json").read_text())
    assert cell["ok"] and cell["world"] == 256 and cell["mesh_shape"] == {"data": 16, "model": 16}
    assert cell["padded_heads"] == 16
    jarch = jreg.get("qwen2-0.5b")
    jcfg = jarch.config.pad_for_mesh(16)
    assert cell["num_kv_heads_effective"] == jcfg.num_kv_heads
    assert cell["param_count"] == _ref_param_count(jarch.param_defs(jcfg))
    # the rank's leaves: every parameter, the token and the cache, replicated
    arch = treg.get("qwen2-0.5b")
    cfg = arch.config.pad_for_mesh(16)
    want = sum(math.prod(p.shape) * (_DTYPES[p.dtype] if p.dtype else cfg.param_dtype).itemsize
               for p in _leaves(arch.param_defs(cfg)))
    (tok, _), (cache, _) = arch.decode_specs(cfg, treg.SHAPES["decode_32k"])
    want += tok.nbytes + sum(leaf.nbytes for leaf in cache["layers"].values()) + 4  # pos, an int32 on the host
    assert cell["argument_size_in_bytes"] == want
    assert cell["ladder_identity_holds"] and cell["flops_per_device_exact"] == cell["flops_per_device"]
    assert cell["flops_per_device"] > 0 and cell["matmul_traffic_bytes"] > 0
    assert cell["fits_device"] is False  # a replicated 32k cache of 128 rows does not fit one 80 GB rank


# One arch of each family, at its smoke config and a small shape.
FAMILIES = ["qwen2-0.5b", "deepseek-v2-lite-16b", "llama-3.2-vision-90b", "xlstm-350m", "zamba2-2.7b",
            "whisper-medium"]
KINDS = ["train", "prefill", "decode"]


def _smoke_cell(name, kind, **overrides):
    arch = treg.get(name)
    cfg = dataclasses.replace(arch.smoke_config, **overrides)
    return dryrun.run_cell(name, None, "single", device="cpu", config=cfg, shape=ShapeSpec(f"smoke_{kind}", 16, 2, kind))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", FAMILIES)
def test_ladder_identity_is_exact(name, kind):
    cell = _smoke_cell(name, kind)
    exact = sum(r["coeff"] * r["flops"] for r in cell["ladder"].values())
    assert exact == cell["flops_per_device_exact"]
    if (name, kind) == ("whisper-medium", "train"):
        # the finding: enc1 has no decoder, so the encoder's backward never runs there
        le = treg.get(name).smoke_config.encoder_layers
        with_consumer = (_smoke_cell(name, kind, encoder_layers=2, num_layers=1)["flops_per_device"]
                         - _smoke_cell(name, kind, encoder_layers=1, num_layers=1)["flops_per_device"])
        forward_only = cell["ladder"]["enc1"]["flops"] - cell["ladder"]["zero"]["flops"]
        assert cell["flops_per_device"] - exact == le * (with_consumer - forward_only) > 0
        assert not cell["ok"]
        return
    assert cell["ladder_identity_holds"] and cell["ok"]
    assert cell["flops_per_device"] == exact


def test_the_dry_run_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: fake cuda tensors are allowed")
    with pytest.raises(RuntimeError, match="--device cpu"):
        dryrun.run_cell("qwen2-0.5b", "decode_32k", "single")
    assert dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k", "--out", str(tmp_path)]) == 1
    cell = json.loads((tmp_path / "qwen2-0_5b__decode_32k__single__base.json").read_text())
    assert not cell["ok"] and "pass --device cpu" in cell["error"]


def test_no_zero1_is_rejected(tmp_path):
    # the port keeps optimizer moments replicated: there is no ZeRO-1 to turn off
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--arch", "qwen2-0.5b", "--shape", "train_4k", "--device", "cpu", "--no-zero1",
                     "--out", str(tmp_path)])
    assert exc.value.code == 2
    assert not list(tmp_path.iterdir())

