"""The port's linter against the reference's, where the matchers do not
depend on the framework: RPR002, RPR005 (the ``/`` spelling), RPR009,
RPR010 and the core machinery (noqa, ``RPR999``, sort order, the JSON
report, the CLI).

Each fixture goes to ``repro.analysis.check_source`` at
``src/repro/<x>`` and to ``repro_torch.analysis.check_source`` at
``src/repro_torch/<x>``; both must give the same ``(rule, line, col)``
list, every rule of each side run.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.analysis as ref  # noqa: E402
import repro.analysis.__main__ as ref_main  # noqa: E402
import repro_torch.analysis as port  # noqa: E402
import repro_torch.analysis.__main__ as port_main  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _both(src, tail, rule_ids=None):
    a = ref.check_source(src, f"src/repro/{tail}", rule_ids=rule_ids)
    b = port.check_source(src, f"src/repro_torch/{tail}", rule_ids=rule_ids)
    return [(f.rule, f.line, f.col) for f in a], [(f.rule, f.line, f.col) for f in b]


FIXTURES = {
    # RPR002
    "org-upper": "def f(org):\n    return org.upper()\n",
    "org-attr-chain": "def f(self):\n    return self.cfg.organization.strip().lower()\n",
    "orders-title": "x = [o for o in orders.title()]\n",
    "org-with-args": "def f(org):\n    return org.upper(1), org.lower(k=1)\n",
    "not-orgish": "def f(name):\n    return name.upper(), orgs.resolve(name)\n",
    # RPR009
    "platform-upper": "def f(platform):\n    return platform.upper()\n",
    "materials-casefold": "m = spec.materials.casefold()\n",
    "not-platformish": "def f(plat):\n    return plat.lower(), platforms.resolve(plat)\n",
    # RPR005
    "quant-binop": "def quantize(x):\n    return x / 127.0\n",
    "quant-const-expr": "def _quant_scale(x):\n    return x / (2 ** 7 - 1), x / -float(127)\n",
    "quant-nested": "def quantize(x):\n    def g(y):\n        return y / 3\n    return g(x)\n",
    "quant-reciprocal": "def quantize(x, q):\n    return x * (1.0 / 127.0), x / q, 1 / q\n",
    "non-quant-division": "def norm(x):\n    return x / 127.0\n",
    # RPR010
    "sum-time": "total = sum(s.time_s for s in stats)\n",
    "binop-makespan": "fps = 1.0 / tl.makespan_s\n",
    "augassign-energy": "e = 0\nfor n in nodes:\n    e += n.energy_j\n",
    "min-call-func": "t = min(a.stream_s, b.reduce_s) * 2\n",
    "timing-reads": "fps = tl.fps\nt = s.time_s\nprint(s.tune_s)\n",
    # several rules and several findings on one line: the sort order
    "sort-order": (
        "def quantize(org, platform, s):\n"
        "    a = (platform.upper(), org.upper(), s.time_s + s.busy_s / 2.0)\n"
        "    return a, org.lower()\n"
    ),
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
@pytest.mark.parametrize("tail", ["x.py", "models/x.py"])
def test_findings_equal_the_reference(name, tail):
    a, b = _both(FIXTURES[name], tail)
    assert a == b
    # the fixtures exercise both arms: some flag, some are clean twins
    assert bool(a) == (name not in {
        "org-with-args", "not-orgish", "not-platformish", "quant-reciprocal",
        "non-quant-division", "timing-reads",
    })


@pytest.mark.parametrize(
    "src,tail",
    [
        ("def f(org):\n    return org.upper()\n", "orgs.py"),
        ("def f(platform):\n    return platform.upper()\n", "platforms.py"),
        ("t = a.time_s + b.time_s\n", "mapper/timeline.py"),
        ("t = sum(n.busy_s for n in ns)\n", "core/simulator.py"),
    ],
    ids=["orgs", "platforms", "mapper", "simulator"],
)
def test_exemptions_equal_the_reference(src, tail):
    assert _both(src, tail) == ([], [])
    assert _both(src, "x.py")[0]  # flagged outside the exempt module


@pytest.mark.parametrize(
    "comment",
    ["", "  # repro: noqa", "  # repro: noqa[RPR005]", "  #repro:noqa[rpr002,RPR005]",
     "  # repro: noqa[RPR001]", "  # repro: noqa[RPR010]"],
)
def test_noqa_equal_the_reference(comment):
    src = (
        "def _quantize(x, org, s):\n"
        f"    return x / 127.0, org.upper(), s.time_s * 2{comment}\n"
    )
    a, b = _both(src, "x.py")
    assert a == b


@pytest.mark.parametrize(
    "src", ["def f(:\n    pass\n", "x = (\n", "def f():\nreturn 1\n", "x = 1 +* 2\n"],
)
def test_syntax_error_equal_the_reference(src):
    a = ref.check_source(src, "src/repro/x.py")
    b = port.check_source(src, "src/repro_torch/x.py")
    assert [(f.rule, f.line, f.col, f.message) for f in a] == [
        (f.rule, f.line, f.col, f.message) for f in b
    ]
    assert [f.rule for f in b] == ["RPR999"]


@pytest.mark.parametrize("rule_ids", [("RPR002",), ("RPR005", "RPR010"), ("RPR009",), ()])
def test_selection_equal_the_reference(rule_ids):
    a, b = _both(FIXTURES["sort-order"], "x.py", rule_ids=rule_ids)
    assert a == b


def test_finding_formats_and_report_keys_equal_the_reference():
    src = FIXTURES["sort-order"]
    a = ref.check_source(src, "src/repro/x.py")
    b = port.check_source(src, "src/repro_torch/x.py")

    def ported(text):  # the port's messages name its own modules
        return text.replace("src/repro/", "src/repro_torch/").replace("repro.", "repro_torch.")

    for fmt in ("format_text", "format_github"):
        assert [ported(getattr(f, fmt)()) for f in a] == [getattr(f, fmt)() for f in b]
    ra = ref_main._build_report(a, None)
    rb = port_main._build_report(b, None)
    assert (ra["tool"], rb["tool"]) == ("repro.analysis", "repro_torch.analysis")
    assert sorted(ra) == sorted(rb)
    assert sorted(ra["rules"][0]) == sorted(rb["rules"][0])
    assert [r["id"] for r in ra["rules"]] == [r["id"] for r in rb["rules"]]
    assert [sorted(f) for f in ra["findings"]] == [sorted(f) for f in rb["findings"]]
    assert (ra["count"], ra["ok"]) == (rb["count"], rb["ok"]) == (len(b), False)


def test_cli_equal_the_reference(tmp_path):
    (tmp_path / "pyproject.toml").write_text("[project]\nname = 'p'\n")
    src = "def quantize(x, platform):\n    return x / 127.0, platform.upper()\n"
    for pkg in ("repro", "repro_torch"):
        (tmp_path / "src" / pkg).mkdir(parents=True)
        (tmp_path / "src" / pkg / "q.py").write_text(src)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    outs = {}
    for pkg in ("repro", "repro_torch"):
        outs[pkg] = subprocess.run(
            [sys.executable, "-m", f"{pkg}.analysis", f"src/{pkg}", "--format", "github",
             "--report", str(tmp_path / f"{pkg}.json")],
            cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
        )
    a, b = outs["repro"], outs["repro_torch"]
    assert a.returncode == b.returncode == 1, a.stderr + b.stderr
    assert a.stdout.replace("src/repro/", "src/repro_torch/").replace(
        "repro.platforms", "repro_torch.platforms"
    ) == b.stdout
    ja = json.loads((tmp_path / "repro.json").read_text())
    jb = json.loads((tmp_path / "repro_torch.json").read_text())
    assert [(f["rule"], f["line"], f["col"]) for f in ja["findings"]] == [
        (f["rule"], f["line"], f["col"]) for f in jb["findings"]
    ]
