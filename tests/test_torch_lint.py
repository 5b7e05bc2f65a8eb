"""The port's source linter, ``repro_torch.analysis`` (Level 1).

* each of the ten rules flags every torch spelling of its violation at
  the expected line and column, and passes its clean twins;
* path scopes: the same source in and out of a rule's scope;
* the noqa hatch, ``RPR999`` on a syntax error;
* the clean tree: ``run_all`` over the port's files is empty, and the
  port holds no ``# repro: noqa``;
* mutations of real files of the port (read from disk, changed in memory)
  are caught;
* the CLI on a temporary project: exit codes, formats, ``--report``,
  ``--select``, ``--list-rules``, the default paths.

No JAX here: ``tests/test_torch_lint_parity.py`` holds the port's rules
against the reference's.
"""

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.analysis import all_rules, check_source, run_all  # noqa: E402
from repro_torch.analysis.rules.engine import _BACKEND_NAMES  # noqa: E402
from repro_torch.analysis.rules.epilogue import _ARITH_METHODS  # noqa: E402
from repro_torch.analysis.rules.randomness import _INPLACE_SAMPLERS, _SAMPLERS  # noqa: E402
from repro_torch.analysis.rules.serving import _INPLACE_WRITERS  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

PKG = "src/repro_torch/x.py"
MODELS = "src/repro_torch/models/x.py"
RUNTIME = "src/repro_torch/runtime/x.py"
KERNELS = "src/repro_torch/kernels/x.py"


def hits(src, path):
    """(rule, line, col) of every finding of every rule."""
    return [(f.rule, f.line, f.col) for f in check_source(src, path)]


def case(rule, path, src, line, col, name):
    return pytest.param(rule, path, src, line, col, id=f"{rule}-{name}")


# ---------------------------------------------------------------------------
# Violating fixtures: (rule, path, source, line, col)
# ---------------------------------------------------------------------------
VIOLATIONS = [
    # RPR001: the import boundary
    case("RPR001", PKG, "import jax\n", 1, 1, "import-jax"),
    case("RPR001", PKG, "import jax.numpy as jnp\n", 1, 1, "import-jax-numpy"),
    case("RPR001", PKG, "import jaxlib\n", 1, 1, "import-jaxlib"),
    case("RPR001", PKG, "from jax import numpy as jnp\n", 1, 1, "from-jax"),
    case("RPR001", PKG, "from jax.experimental import pallas\n", 1, 1, "from-jax-sub"),
    case("RPR001", PKG, "import repro.analysis\n", 1, 1, "import-repro"),
    case("RPR001", PKG, "from repro.models import common\n", 1, 1, "from-repro"),
    case("RPR001", PKG, "from repro import compat\n", 1, 1, "from-repro-root"),
    case("RPR001", PKG, "def f():\n    import jax\n", 2, 5, "nested-import"),
    case("RPR001", "chip_smoke.py", "import os, jax\n", 1, 1, "chip-smoke"),
    # RPR002: org strings
    case("RPR002", PKG, "def f(org):\n    return org.upper()\n", 2, 12, "org-upper"),
    case("RPR002", PKG, "def f(self):\n    return self.organization.lower()\n", 2, 12,
         "organization-lower"),
    case("RPR002", PKG, "def f(order):\n    return order.strip().casefold()\n", 2, 12,
         "order-chained"),
    case("RPR002", "tests/test_torch_x.py", "k = cfg.org_name.title()\n", 1, 5, "in-tests"),
    # RPR003: kernel imports and backend calls
    case("RPR003", MODELS, "from repro_torch.kernels.photonic_gemm.epilogue import EpilogueSpec\n",
         1, 1, "from-kernels"),
    case("RPR003", MODELS, "from repro_torch.kernels import photonic_gemm\n", 1, 1,
         "from-kernels-root"),
    case("RPR003", RUNTIME, "import repro_torch.kernels.flash_attention.kernel as F\n", 1, 1,
         "import-kernels"),
    case("RPR003", MODELS, "from repro_torch.photonic.sharded import psum_int_gemm\n", 1, 1,
         "from-import-backend-name"),
] + [
    case("RPR003", MODELS, f"def f(x, w):\n    return K.{name}(x, w)\n", 2, 12, f"call-{name}")
    for name in sorted(_BACKEND_NAMES)
] + [
    case("RPR003", RUNTIME, "def f(x, w):\n    return int_gemm(x, w)\n", 2, 12, "bare-call"),
    # RPR004: torch sampling outside init
] + [
    case("RPR004", MODELS, f"def forward(x):\n    return torch.{name}(x)\n", 2, 12, f"torch-{name}")
    for name in sorted(_SAMPLERS)
] + [
    case("RPR004", KERNELS, "def forward(x):\n    return x + torch.randn(x.shape)\n", 2, 16,
         "in-kernels"),
    case("RPR004", MODELS, "def forward(x):\n    g = torch.Generator(device='cpu')\n", 2, 9,
         "generator"),
    case("RPR004", MODELS, "sampler = torch.randn\n", 1, 11, "module-level-reference"),
    case("RPR004", MODELS, "def forward(w):\n    torch.nn.init.normal_(w)\n", 2, 5,
         "nn-init-normal_"),
] + [
    case("RPR004", MODELS, f"def forward(w):\n    w.{name}()\n", 2, 5, f"inplace-{name}")
    for name in sorted(_INPLACE_SAMPLERS)
] + [
    # RPR005: constant-divisor division in *quant* functions
    case("RPR005", PKG, "def quantize(x):\n    return x / 127.0\n", 2, 12, "binop"),
    case("RPR005", PKG, "def _quant(x):\n    return x / (2 ** 7 - 1)\n", 2, 12, "const-expr"),
    case("RPR005", PKG, "def quantize(x):\n    return torch.div(x, 127.0)\n", 2, 12, "torch-div"),
    case("RPR005", PKG, "def quantize(x):\n    return torch.div(x, other=127)\n", 2, 12,
         "torch-div-kw"),
    case("RPR005", PKG, "def quantize(x):\n    return torch.true_divide(x, 127.0)\n", 2, 12,
         "torch-true_divide"),
    case("RPR005", PKG, "def quantize(x):\n    return x.div(float(127))\n", 2, 12, "method-div"),
    case("RPR005", PKG, "def dequantize(x):\n    x.div_(-127.0)\n", 2, 5, "method-div_"),
    # RPR006: tensor_parallel in a manual_tp block
    case("RPR006", PKG,
         "def step(mesh, g):\n    with manual_tp('model', group=g):\n"
         "        with tensor_parallel(mesh):\n            pass\n", 3, 14, "nested-with"),
    case("RPR006", "tests/_torch_x.py",
         "def step(mesh):\n    with sharded.manual_tp('model'):\n"
         "        sharded.tensor_parallel(mesh)\n", 3, 9, "attribute"),
    case("RPR006", PKG,
         "def helper(mesh):\n    return tensor_parallel(mesh)\n\n\n"
         "def step(mesh):\n    with manual_tp('model'):\n        helper(mesh)\n", 2, 12,
         "called-by-name"),
    case("RPR006", PKG,
         "def step(mesh):\n    with manual_tp('model'), tensor_parallel(mesh):\n        pass\n",
         2, 30, "same-with-line"),
    # RPR007: paged KV outside kv_cache
    case("RPR007", MODELS, "def f(kv_pool, idx):\n    return kv_pool[idx]\n", 2, 12, "load"),
    case("RPR007", MODELS, "def f(kv_pool, idx, v):\n    kv_pool[idx] = v\n", 2, 5, "store"),
    case("RPR007", RUNTIME, "def f(self, i):\n    return self.block_table[i]\n", 2, 12,
         "attribute"),
    case("RPR007", RUNTIME, "def f(k_block_tables):\n    return k_block_tables[0, :]\n", 2, 12,
         "suffixed"),
] + [
    case("RPR007", MODELS, f"def f(kv_pool, idx, v):\n    kv_pool.{name}(0, idx, v)\n", 2, 5,
         f"inplace-{name}")
    for name in sorted(_INPLACE_WRITERS)
] + [
    case("RPR007", RUNTIME, "def f(self, src):\n    self.kv_pools.copy_(src)\n", 2, 5,
         "attribute-copy_"),
    # RPR008: shoulders on an engine matmul output
    case("RPR008", MODELS, "def f(eng, x, w, s):\n    y = eng.matmul(x, w)\n    return y * s\n",
         3, 12, "binop-tracked"),
    case("RPR008", MODELS, "def f(eng, x, w, b):\n    return eng.matmul_float(x, w) + b\n", 2, 12,
         "binop-call"),
    case("RPR008", MODELS, "def f(eng, x, w, b):\n    y = eng.matmul(x, w)\n    y += b\n", 3, 5,
         "augassign"),
    case("RPR008", MODELS, "def f(x, w, s):\n    y = maybe_tp_matmul(x, w)\n"
         "    return torch.mul(y, s)\n", 3, 12, "torch-mul"),
    case("RPR008", MODELS, "def f(eng, x, w, b):\n    y = eng.matmul(x, w)\n"
         "    return torch.add(b, y)\n", 3, 12, "torch-add-second"),
    case("RPR008", MODELS, "def f(eng, x, w, b):\n    return torch.sub(eng.matmul(x, w), b)\n",
         2, 12, "torch-sub-call"),
    case("RPR008", MODELS, "def f(eng, x, w, s):\n    y = eng.matmul(x, w)\n"
         "    return torch.div(y, s)\n", 3, 12, "torch-div"),
] + [
    case("RPR008", MODELS, f"def f(eng, x, w, s):\n    y = eng.matmul(x, w)\n    y.{name}(s)\n",
         3, 5, f"method-{name}")
    for name in sorted(_ARITH_METHODS)
] + [
    case("RPR008", MODELS, "def f(eng, x, w, b):\n    return eng.matmul(x, w).add_(b)\n", 2, 12,
         "method-on-call"),
    # RPR009: platform strings
    case("RPR009", PKG, "def f(platform):\n    return platform.upper()\n", 2, 12,
         "platform-upper"),
    case("RPR009", "chip_smoke.py", "m = cfg.material.strip().lower()\n", 1, 5, "material"),
    # RPR010: timing arithmetic outside the mapper
    case("RPR010", PKG, "total = sum(s.time_s for s in stats)\n", 1, 13, "sum"),
    case("RPR010", PKG, "fps = 1.0 / tl.makespan_s\n", 1, 13, "binop"),
    case("RPR010", "chip_smoke.py", "e = 0\ne += node.energy_j\n", 2, 6, "augassign"),
    case("RPR010", PKG, "worst = max(n.busy_s for n in nodes)\n", 1, 13, "max"),
]


@pytest.mark.parametrize("rule,path,src,line,col", VIOLATIONS)
def test_violation_flagged_at_its_place(rule, path, src, line, col):
    assert hits(src, path) == [(rule, line, col)]


# ---------------------------------------------------------------------------
# Clean twins: (rule, path, source)
# ---------------------------------------------------------------------------
def clean(rule, path, src, name):
    return pytest.param(path, src, id=f"{rule}-{name}")


CLEAN = [
    clean("RPR001", PKG, "import torch\nimport numpy as np\n", "torch"),
    clean("RPR001", PKG, "from repro_torch.models import common\nimport repro_torch\n",
          "repro_torch"),
    clean("RPR001", PKG, "from . import common\nfrom .repro import x\n", "relative"),
    clean("RPR001", PKG, "import jaxtyping\nimport reprolib\n", "prefix-names"),
    clean("RPR001", PKG, "s = 'import jax'\n", "string"),
    clean("RPR002", PKG, "def f(org, name):\n    return orgs.resolve(org), name.upper()\n",
          "resolve"),
    clean("RPR003", MODELS,
          "from repro_torch.photonic import EpilogueSpec\n"
          "from repro_torch.models.common import dense\n\n\n"
          "def f(p, x, cfg, eng, w):\n"
          "    return dense(p, x, cfg, site='ffn.wi'), eng.matmul(x, w)\n", "engine-route"),
    clean("RPR004", MODELS,
          "def init_params(cfg):\n    def make(p):\n        return torch.randn(p.shape)\n"
          "    return make\n\n\n"
          "def _init_gate(w):\n    w.normal_()\n    return torch.Generator()\n", "init-paths"),
    clean("RPR004", MODELS,
          "def forward(key, x):\n    torch.manual_seed(0)\n"
          "    return x + prng.normal(key, x.shape) + torch.zeros_like(x)\n", "prng-stream"),
    clean("RPR005", PKG,
          "def quantize(x, scale, qmax):\n"
          "    a = x * (1.0 / 127.0)\n    b = torch.div(1.0, qmax)\n"
          "    c = x.div(scale)\n    d = torch.div(x, scale)\n    return a, b, c, d / qmax\n",
          "reciprocal"),
    clean("RPR005", PKG, "def norm(x):\n    return x / 127.0, x.div(2.0)\n", "non-quant-fn"),
    clean("RPR006", PKG,
          "def step(mesh, g):\n    with tensor_parallel(mesh):\n        pass\n"
          "    with tensor_parallel(mesh), manual_tp('model', group=g):\n        f(mesh)\n",
          "outside-block"),
    clean("RPR006", PKG,
          "def helper(mesh):\n    return tensor_parallel(mesh)\n\n\n"
          "def step(mesh):\n    with manual_tp('model'):\n        other(mesh)\n",
          "helper-not-called"),
    clean("RPR007", MODELS,
          "def f(kv_pool, block_table, kv_pool_size, cache, x):\n"
          "    kv_cache.gather_kv(kv_pool, block_table[None])\n"
          "    cache.copy_(x)\n"
          "    return block_table[None, None], kv_pool_size[0], kv_pool.shape\n",
          "api-and-axes"),
    clean("RPR008", MODELS,
          "def f(eng, p, x, w, s, cfg):\n"
          "    y = eng.matmul(x, w, epilogue=Epilogue(spec, b))\n"
          "    z = torch.matmul(x, w) * s\n"
          "    h = dense(p, x, cfg, site='ffn.wi')\n"
          "    h = h * torch.sigmoid(h)\n"
          "    y = y.float()\n"
          "    return y + z, h.mul_(s), torch.add(h, z)\n", "epilogue-and-digital"),
    clean("RPR009", PKG, "def f(platform, name):\n    return platforms.resolve(platform), name.lower()\n",
          "resolve"),
    clean("RPR010", PKG,
          "fps = tl.fps\nt = s.time_s\nprint(s.time_s, len(tl.busy_s))\n", "reads"),
]


@pytest.mark.parametrize("path,src", CLEAN)
def test_clean_twin_not_flagged(path, src):
    assert hits(src, path) == []


# ---------------------------------------------------------------------------
# Scopes: (path, source, expected rules)
# ---------------------------------------------------------------------------
_BACKEND_CALL = "from repro_torch.kernels.photonic_gemm import kernel as K\n"
_DRAW = "def forward(x):\n    return torch.randn(x.shape)\n"
_QUANT = "def quantize(x):\n    return x / 127.0\n"
_PAGED = "def f(kv_pool, i):\n    return kv_pool[i]\n"
_SHOULDER = "def f(eng, x, w, s):\n    return eng.matmul(x, w) * s\n"
_TIMING = "t = a.time_s + b.time_s\n"


@pytest.mark.parametrize(
    "path,src,expected",
    [
        ("src/repro_torch/models/ffn.py", _BACKEND_CALL, ["RPR003"]),
        ("src/repro_torch/runtime/serve.py", _BACKEND_CALL, ["RPR003"]),
        ("src/repro_torch/photonic/engine.py", _BACKEND_CALL, []),
        ("src/repro_torch/kernels/photonic_gemm/ops.py", _BACKEND_CALL, []),
        ("src/repro/models/ffn.py", _BACKEND_CALL, []),
        ("src/repro_torch/models/common.py", _DRAW, ["RPR004"]),
        ("src/repro_torch/kernels/photonic_gemm/ref.py", _DRAW, ["RPR004"]),
        ("src/repro_torch/noise/x.py", _DRAW, []),
        ("src/repro_torch/core/dpu.py", _QUANT, ["RPR005"]),
        ("tests/test_torch_x.py", _QUANT, []),
        ("chip_smoke.py", _QUANT, []),
        ("src/repro_torch/models/attention.py", _PAGED, ["RPR007"]),
        ("src/repro_torch/runtime/serve.py", _PAGED, ["RPR007"]),
        ("src/repro_torch/serving/kv_cache.py", _PAGED, []),
        ("src/repro_torch/models/ffn.py", _SHOULDER, ["RPR008"]),
        ("src/repro_torch/photonic/sharded.py", _SHOULDER, []),
        ("src/repro_torch/launch/x.py", _TIMING, ["RPR010", "RPR010"]),
        ("chip_smoke.py", _TIMING, ["RPR010", "RPR010"]),
        ("src/repro_torch/mapper/timeline.py", _TIMING, []),
        ("src/repro_torch/core/simulator.py", _TIMING, []),
        ("tests/test_torch_x.py", _TIMING, []),
        ("src/repro_torch/orgs.py", "def f(org):\n    return org.upper()\n", []),
        ("src/repro_torch/platforms.py", "def f(platform):\n    return platform.upper()\n", []),
        ("tests/test_torch_x.py", "import jax\nfrom repro import compat\n", []),
        ("tests/_torch_x.py", "import jax\n", []),
    ],
)
def test_scope(path, src, expected):
    assert [r for r, _, _ in hits(src, path)] == expected


# ---------------------------------------------------------------------------
# The noqa hatch and syntax errors
# ---------------------------------------------------------------------------
_BAD = "def _quantize(x, amax):\n    return x / 127.0{comment}\n"


@pytest.mark.parametrize(
    "comment,expected",
    [
        ("", ["RPR005"]),
        ("  # repro: noqa", []),
        ("  # repro: noqa[RPR005]", []),
        ("  # repro: noqa[rpr001, RPR005]", []),
        ("  # repro: noqa[RPR001]", ["RPR005"]),
    ],
    ids=["none", "bare", "by-id", "in-list", "other-id"],
)
def test_noqa(comment, expected):
    assert [r for r, _, _ in hits(_BAD.format(comment=comment), PKG)] == expected


def test_syntax_error_is_rpr999():
    (f,) = check_source("def f(:\n    pass\n", PKG)
    assert (f.rule, f.line, f.path) == ("RPR999", 1, PKG)
    assert f.message.startswith("syntax error")


def test_rule_registry_complete():
    ids = [cls.id for cls in all_rules()]
    assert ids == [f"RPR{i:03d}" for i in range(1, 11)]
    for cls in all_rules():
        assert cls.summary and cls.rationale


# ---------------------------------------------------------------------------
# The clean tree
# ---------------------------------------------------------------------------
def test_run_all_default_paths_is_empty():
    assert run_all(root=ROOT) == []


def test_port_has_zero_noqa_suppressions():
    # analysis/ documents the syntax in docstrings, hence the carve-out.
    noqa = re.compile(r"#\s*repro:\s*noqa")
    files = [p for p in (ROOT / "src" / "repro_torch").rglob("*.py") if "analysis" not in p.parts]
    hits_ = [
        f"{f}:{i}"
        for f in files + [ROOT / "chip_smoke.py"]
        for i, line in enumerate(f.read_text().splitlines(), 1)
        if noqa.search(line)
    ]
    assert hits_ == []


# ---------------------------------------------------------------------------
# Mutations of real files of the port
# ---------------------------------------------------------------------------
def _lines(relpath):
    return (ROOT / relpath).read_text().splitlines(keepends=True)


def test_mutation_kernel_import_in_ffn():
    rel = "src/repro_torch/models/ffn.py"
    lines = _lines(rel)
    i = lines.index("from repro_torch.photonic import EpilogueSpec\n")
    assert hits("".join(lines), rel) == []
    lines[i] = "from repro_torch.kernels.photonic_gemm.epilogue import EpilogueSpec\n"
    assert hits("".join(lines), rel) == [("RPR003", i + 1, 1)]


def test_mutation_draw_in_a_forward_of_common():
    rel = "src/repro_torch/models/common.py"
    text = (ROOT / rel).read_text()
    tree = ast.parse(text)
    (cls,) = [n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == "_Softplus"]
    (fwd,) = [n for n in cls.body if isinstance(n, ast.FunctionDef) and n.name == "forward"]
    first = fwd.body[0]
    lines = text.splitlines(keepends=True)
    indent = " " * first.col_offset
    lines.insert(first.lineno - 1, f"{indent}x = x + torch.randn(x.shape)\n")
    assert hits(text, rel) == []
    assert hits("".join(lines), rel) == [("RPR004", first.lineno, first.col_offset + 9)]


def test_mutation_jax_import_in_chip_smoke():
    rel = "chip_smoke.py"
    lines = _lines(rel)
    i = lines.index("import numpy as np\n") + 1
    assert hits("".join(lines), rel) == []
    lines.insert(i, "import jax\n")
    assert hits("".join(lines), rel) == [("RPR001", i + 1, 1)]


# ---------------------------------------------------------------------------
# The CLI on a temporary project
# ---------------------------------------------------------------------------
def _project(tmp_path, ffn_src="x = 1\n"):
    (tmp_path / "pyproject.toml").write_text("[project]\nname = 'p'\n")
    models = tmp_path / "src" / "repro_torch" / "models"
    models.mkdir(parents=True)
    (models / "ffn.py").write_text(ffn_src)
    (tmp_path / "chip_smoke.py").write_text("import torch\n")
    tests = tmp_path / "tests"
    tests.mkdir()
    (tests / "test_torch_a.py").write_text("import jax\n")  # tests may call the reference
    # the reference's tests and build output are not the port's files
    (tests / "test_other.py").write_text("def f(org):\n    return org.upper()\n")
    (tmp_path / "src" / "repro_torch" / "build").mkdir()
    (tmp_path / "src" / "repro_torch" / "build" / "gen.py").write_text("import jax\n")
    return tmp_path


def _cli(cwd, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=120,
    )


def test_cli_clean_project_exits_zero(tmp_path):
    out = _cli(_project(tmp_path))
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout == ""
    assert out.stderr.strip() == (
        "repro_torch.analysis: ok over src/repro_torch, chip_smoke.py, "
        "tests/test_torch_*.py, tests/_torch_*.py"
    )


def test_cli_finding_text_github_and_report(tmp_path):
    root = _project(tmp_path, _BACKEND_CALL)
    (root / "tests" / "_torch_ranks.py").write_text("def f(platform):\n    return platform.lower()\n")
    out = _cli(root)
    assert out.returncode == 1
    assert out.stdout.splitlines() == [
        "src/repro_torch/models/ffn.py:1:1: RPR003 import from kernel backend "
        "'repro_torch.kernels.photonic_gemm'; route via dense(site=...) / engine.matmul*",
        "tests/_torch_ranks.py:2:12: RPR009 case-normalizing a platform-typed value via "
        ".lower(); route through repro_torch.platforms.resolve",
    ]
    assert "2 finding(s)" in out.stderr
    report = root / "report.json"
    out = _cli(root, "--format", "github", "--report", str(report), "src")
    assert out.returncode == 1
    assert out.stdout.splitlines() == [
        "::error file=src/repro_torch/models/ffn.py,line=1,col=1,title=RPR003::import from "
        "kernel backend 'repro_torch.kernels.photonic_gemm'; route via dense(site=...) / "
        "engine.matmul*",
    ]
    rep = json.loads(report.read_text())
    assert rep["tool"] == "repro_torch.analysis" and rep["ok"] is False and rep["count"] == 1
    assert [r["id"] for r in rep["rules"]] == [f"RPR{i:03d}" for i in range(1, 11)]
    assert rep["findings"][0]["rule"] == "RPR003" and rep["findings"][0]["line"] == 1


def test_cli_select_and_json(tmp_path):
    root = _project(tmp_path, _BACKEND_CALL + _QUANT)
    out = _cli(root, "--select", "rpr005, RPR010", "--format", "json")
    assert out.returncode == 1
    rep = json.loads(out.stdout)
    assert [r["id"] for r in rep["rules"]] == ["RPR005", "RPR010"]
    assert [(f["rule"], f["line"]) for f in rep["findings"]] == [("RPR005", 3)]
    out = _cli(root, "--select", "RPR010", "--root", str(root))
    assert out.returncode == 0 and "ok" in out.stderr


def test_cli_list_rules():
    out = _cli(ROOT, "--list-rules")
    assert out.returncode == 0
    ids = [line.split()[0] for line in out.stdout.splitlines()]
    assert ids == [f"RPR{i:03d}" for i in range(1, 11)]


def test_cli_loads_no_jax_and_no_repro():
    code = (
        "import runpy, sys\n"
        "sys.argv = ['repro_torch.analysis']\n"
        "try:\n"
        "    runpy.run_module('repro_torch.analysis', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    print('RC', e.code)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro') "
        "or m.startswith(('jax.', 'jaxlib', 'repro.')))\n"
        "print('BAD', bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert "RC 0" in out.stdout and "BAD []" in out.stdout, out.stdout + out.stderr
