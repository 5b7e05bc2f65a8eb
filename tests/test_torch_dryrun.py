"""The port's dry run (``repro_torch.launch.dryrun``) on a fake 256-rank
mesh.

Held here:

* ``python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape
  decode_32k --mesh single --device cpu`` writes an ``ok`` cell on a fake
  group of 256 ranks: ``padded_heads == 16`` (as the reference's
  ``tests/test_dryrun_integration.py`` asserts), ``num_kv_heads_effective``
  and ``param_count`` those of the reference's
  ``param_defs(config.pad_for_mesh(16))``, ``argument_size_in_bytes`` the
  sum of the rank's leaves (its block of every parameter by its
  ``param_axes``, its block of the token and cache, 8 of the 128 rows and
  1 of the 16 KV heads, and the 4-byte position the decode reads on the
  host), the reference's 1,677,959,972 B, the ladder identity exact, the
  peak within one 80 GB rank;
* the ladder identity ``flops = sum(coeff x rung flops)`` exactly, in
  integers, for one arch of each family at its smoke config and a small
  shape, train / prefill / decode.  One exception is a finding (ROADMAP
  Queue 3 item 17): training the audio family, the ``enc1`` rung has no
  decoder to read the encoder, so the encoder's backward (and its remat
  recompute) never runs there; the gap is exactly ``encoder_layers x`` that
  layer's backward, measured from two cells with a decoder;
* without ``--device cpu`` and without a card, the dry run raises;
* ``--no-zero1`` is accepted: the train step's moments are then the
  rank's parameter blocks whole along ``zero1``, as they are ZeRO-1 blocks
  without it.

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
from repro_torch._tree import tree_items  # noqa: E402
from repro_torch.models.common import P  # noqa: E402
from repro_torch.models.registry import ShapeSpec  # noqa: E402
from repro_torch.runtime import sharding as tshd  # noqa: E402

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
    # the rank's leaves: its block of every parameter (heads, KV heads, d_ff and vocab over "model"),
    # and its rows and KV heads of the token and the cache: the reference's arguments to the byte
    arch = treg.get("qwen2-0.5b")
    cfg = arch.config.pad_for_mesh(16)
    blocks, _ = arch.param_specs(cfg, treg.SHAPES["decode_32k"], mesh=tshd.abstract_mesh((16, 16), ("data", "model")))
    want = sum(s.nbytes for s in tree_items(blocks).values())
    (tok, _), (cache, _) = arch.decode_specs(cfg, treg.SHAPES["decode_32k"])
    want += tok.nbytes // 16 + sum(leaf.nbytes for leaf in cache["layers"].values()) // 256 + 4  # pos, on the host
    assert cell["argument_size_in_bytes"] == want == 1677959972
    assert cell["ladder_identity_holds"] and cell["flops_per_device_exact"] == cell["flops_per_device"]
    assert cell["flops_per_device"] > 0 and cell["matmul_traffic_bytes"] > 0
    assert cell["fits_device"] is True  # 8 rows and 1 KV head of the 32k cache fit one 80 GB rank


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
    # no longer rejected: --no-zero1 keeps the train step's moments replicated
    # (at no layers, to stay quick)
    assert dryrun.main(["--arch", "qwen2-0.5b", "--shape", "train_4k", "--device", "cpu", "--no-zero1",
                        "--override", "num_layers=0", "--out", str(tmp_path)]) == 0
    (path,) = tmp_path.iterdir()
    cell = json.loads(path.read_text())
    assert cell["ok"] and cell["zero1"] is False
    # f32 mu and nu of the rank's parameter blocks (the embedding's vocab over "model"), the int32 step
    arch = treg.get("qwen2-0.5b")
    cfg = dataclasses.replace(arch.config.pad_for_mesh(16), num_layers=0)
    blocks, _ = arch.param_specs(cfg, treg.SHAPES["train_4k"], mesh=tshd.abstract_mesh((16, 16), ("data", "model")))
    assert cell["optimizer_state_bytes"] == 2 * 4 * sum(math.prod(s.shape) for s in tree_items(blocks).values()) + 4

