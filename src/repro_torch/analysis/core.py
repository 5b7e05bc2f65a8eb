"""Level-1 machinery of the port's invariant checker: rules, findings, the
runner.

Port of ``repro.analysis.core``.  The port's conventions are the
reference's contracts in torch spelling: each *rule* is a small AST
visitor with the reference's stable ID (``RPR001``...), a one-line
summary, and a rationale naming the contract it guards.  Rules are
plugins — a module under ``repro_torch.analysis.rules`` defines a
:class:`Rule` subclass and registers it with :func:`register_rule`; the
runner, the CLI, and the tests all consume the same registry.  The port
keeps its own registry: nothing here imports ``repro``.

Escape hatch: a ``# repro: noqa[RPR001]`` (or bare ``# repro: noqa``)
comment on the flagged line suppresses the finding.  The acceptance bar
for the port itself is *zero* suppressions under ``src/repro_torch/`` and
in ``chip_smoke.py`` — the hatch exists for deliberate fixtures, not for
code.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Type

_NOQA_RE = re.compile(r"#\s*repro:\s*noqa(?:\[([A-Za-z0-9_, ]+)\])?")

# Directories never scanned (caches, VCS internals, build output).
_SKIP_DIRS = {"__pycache__", ".git", ".ruff_cache", "build", "dist", ".eggs"}

#: The port's own files, relative to the repo root: the counterparts of
#: the reference's ``src tests benchmarks examples``.  Port tests are in
#: the set; the reference's tests are not.
DEFAULT_PATTERNS = (
    "src/repro_torch",
    "chip_smoke.py",
    "tests/test_torch_*.py",
    "tests/_torch_*.py",
)


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One rule violation, anchored to a repo-relative location.
    Reference: ``repro.analysis.core:Finding``."""

    path: str  # repo-relative, posix separators
    line: int
    col: int
    rule: str
    message: str

    def format_text(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"

    def format_github(self) -> str:
        # GitHub workflow-command annotation (rendered inline on the diff).
        return (
            f"::error file={self.path},line={self.line},col={self.col},"
            f"title={self.rule}::{self.message}"
        )

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


class Rule:
    """Base class for a lint rule.  Reference: ``repro.analysis.core:Rule``.

    Subclasses set ``id`` / ``summary`` / ``rationale`` and implement
    :meth:`check`; ``applies_to`` pre-filters by repo-relative path so a
    rule scoped to e.g. ``src/repro_torch/models/`` never walks other
    files.
    """

    id: str = "RPR000"
    summary: str = ""
    rationale: str = ""

    def applies_to(self, relpath: str) -> bool:
        return True

    def check(self, tree: ast.Module, text: str, relpath: str) -> Iterable[Finding]:
        raise NotImplementedError

    def finding(self, relpath: str, node: ast.AST, message: str) -> Finding:
        return Finding(
            path=relpath,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0) + 1,
            rule=self.id,
            message=message,
        )


_REGISTRY: Dict[str, Type[Rule]] = {}


def register_rule(cls: Type[Rule]) -> Type[Rule]:
    """Class decorator adding a rule to the shared registry (keyed by ID).
    Reference: ``repro.analysis.core:register_rule``."""
    if cls.id in _REGISTRY and _REGISTRY[cls.id] is not cls:
        raise ValueError(f"duplicate rule id {cls.id}")
    _REGISTRY[cls.id] = cls
    return cls


def all_rules() -> Tuple[Type[Rule], ...]:
    """Registered rule classes, sorted by ID (plugins imported on demand).
    Reference: ``repro.analysis.core:all_rules``."""
    # Importing the rules package populates the registry exactly once.
    from repro_torch.analysis import rules  # noqa: F401

    return tuple(_REGISTRY[k] for k in sorted(_REGISTRY))


def _noqa_lines(text: str) -> Dict[int, Optional[Tuple[str, ...]]]:
    """line -> suppressed rule IDs (None = all rules) for ``repro: noqa``."""
    out: Dict[int, Optional[Tuple[str, ...]]] = {}
    for i, line in enumerate(text.splitlines(), start=1):
        m = _NOQA_RE.search(line)
        if not m:
            continue
        ids = m.group(1)
        if ids:
            out[i] = tuple(s.strip().upper() for s in ids.split(",") if s.strip())
        else:
            out[i] = None
    return out


def check_source(
    text: str,
    relpath: str,
    rule_ids: Optional[Sequence[str]] = None,
) -> List[Finding]:
    """Run the (selected) rules over one source string.
    Reference: ``repro.analysis.core:check_source``.

    The entry point tests use for violation fixtures; ``relpath`` decides
    which path-scoped rules apply, exactly as in a tree run.
    """
    relpath = relpath.replace("\\", "/")
    try:
        tree = ast.parse(text)
    except SyntaxError as e:
        return [
            Finding(
                path=relpath,
                line=e.lineno or 1,
                col=(e.offset or 0) + 1,
                rule="RPR999",
                message=f"syntax error: {e.msg}",
            )
        ]
    suppressed = _noqa_lines(text)
    findings: List[Finding] = []
    for cls in all_rules():
        if rule_ids is not None and cls.id not in rule_ids:
            continue
        rule = cls()
        if not rule.applies_to(relpath):
            continue
        for f in rule.check(tree, text, relpath):
            ids = suppressed.get(f.line, ())
            if ids is None or (ids and f.rule in ids):
                continue
            findings.append(f)
    return sorted(findings)


def iter_python_files(paths: Sequence[Path]) -> Iterable[Path]:
    """Reference: ``repro.analysis.core:iter_python_files``."""
    for p in paths:
        if p.is_file() and p.suffix == ".py":
            yield p
        elif p.is_dir():
            for f in sorted(p.rglob("*.py")):
                if not _SKIP_DIRS.intersection(f.parts):
                    yield f


def default_paths(root: Path) -> List[Path]:
    """The port's own files (:data:`DEFAULT_PATTERNS`) that exist under
    ``root``.  Reference: ``repro.analysis.core:default_paths``."""
    out: List[Path] = []
    for pattern in DEFAULT_PATTERNS:
        if "*" in pattern:
            out.extend(sorted(root.glob(pattern)))
        elif (root / pattern).exists():
            out.append(root / pattern)
    return out


def find_repo_root(start: Optional[Path] = None) -> Path:
    """Nearest ancestor carrying pyproject.toml (fallback: the start dir).
    Reference: ``repro.analysis.core:find_repo_root``."""
    cur = (start or Path.cwd()).resolve()
    for candidate in (cur, *cur.parents):
        if (candidate / "pyproject.toml").is_file():
            return candidate
    return cur


def run_all(
    paths: Optional[Sequence] = None,
    root: Optional[Path] = None,
    rule_ids: Optional[Sequence[str]] = None,
) -> List[Finding]:
    """Lint a file set; returns all findings sorted by (path, line, rule).
    Reference: ``repro.analysis.core:run_all``.

    ``paths`` defaults to the port's files (:data:`DEFAULT_PATTERNS`)
    under ``root`` (which defaults to the nearest ancestor of cwd holding a
    pyproject.toml).  An empty return value is the machine-checked
    statement that every convention holds.
    """
    root = Path(root).resolve() if root is not None else find_repo_root()
    targets = [Path(p) for p in paths] if paths else default_paths(root)
    findings: List[Finding] = []
    for f in iter_python_files(targets):
        try:
            rel = f.resolve().relative_to(root).as_posix()
        except ValueError:
            rel = f.as_posix()
        findings.extend(check_source(f.read_text(), rel, rule_ids=rule_ids))
    return sorted(findings)


# ---------------------------------------------------------------------------
# Shared AST helpers used by several rules
# ---------------------------------------------------------------------------
def dotted_name(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain rooted at a Name, else None.
    Reference: ``repro.analysis.core:dotted_name``."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def enclosing_functions(tree: ast.Module) -> Dict[ast.AST, List[ast.AST]]:
    """node -> chain of enclosing FunctionDef/AsyncFunctionDef (outer→inner).
    Reference: ``repro.analysis.core:enclosing_functions``."""
    out: Dict[ast.AST, List[ast.AST]] = {}

    def walk(node: ast.AST, stack: List[ast.AST]) -> None:
        out[node] = list(stack)
        is_fn = isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
        if is_fn:
            stack = stack + [node]
        for child in ast.iter_child_nodes(node):
            walk(child, stack)

    walk(tree, [])
    return out
