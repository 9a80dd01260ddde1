"""AST-based static-analysis framework with the port's contract checkers.

The port's copy of ``repro.analysis.core`` (the port imports nothing of the
JAX package).  The pieces are the same:

  * :class:`Checker` — one contract, one check id, one ``run(ctx)``;
    registered in :data:`REGISTRY` via :func:`register`;
  * :class:`Finding` — a violation at ``path:line`` with a stable
    fingerprint (check id, path, message) that excludes the line;
  * suppression — a ``# repro_torch: ignore[check-id]`` comment on the
    finding's line (or the line above it) marks the finding as reviewed
    and keeps it out of the failing set; every suppression should say why
    on the same line.  The JAX package's marker (``repro:``) is a different
    comment: neither gate reads the other's;
  * :class:`Report` — machine-readable JSON (schema
    ``repro_torch.analysis/v1``: findings, per-checker counts, and each
    checker's positive ``facts``, such as the kernel contracts proven on
    the split MTTKRP kernel's replay), written by ``python -m
    repro_torch.analysis --json``.

What is scanned differs too: the port's sources, its tests and its card
check (:data:`DEFAULT_SCAN`), while the JAX package's gate owns
``src/repro``.  The generic checkers are pure AST inspection; the kernel
contract checkers replay the split kernel's launches on the CPU
(``kernels/mttkrp/partition.py``) over small deterministic plans.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import json
import re
import tokenize
from pathlib import Path
from typing import Any, Sequence

__all__ = [
    "AnalysisContext",
    "Checker",
    "DEFAULT_SCAN",
    "Finding",
    "REGISTRY",
    "Report",
    "SCHEMA",
    "SourceFile",
    "default_checkers",
    "register",
    "run_analysis",
]

SCHEMA = "repro_torch.analysis/v1"

#: ``# repro_torch: ignore[check-id]`` (one or more comma-separated ids).
SUPPRESS_RE = re.compile(r"#\s*repro_torch:\s*ignore\[([A-Za-z0-9_,\- ]+)\]")

#: Globs scanned by default, relative to the repo root: the port, its
#: tests and its card check.
DEFAULT_SCAN = ("src/repro_torch/**/*.py", "tests/test_torch_*.py", "chip_smoke.py")

#: Path fragment identifying the port's checker fixtures: files under it
#: deliberately violate contracts and are excluded from every repo-level
#: scan (each checker consults :func:`is_fixture_path`).
FIXTURE_PATH_PART = "torch_analysis_fixtures"


def is_fixture_path(path: str) -> bool:
    """True for intentional-violation fixtures (the shared waiver list)."""
    return FIXTURE_PATH_PART in path


@dataclasses.dataclass(frozen=True)
class Finding:
    """One contract violation at a source location.

    ``fingerprint`` deliberately excludes the line number, so that a known
    finding keeps matching when unrelated edits shift it a few lines.
    """

    check_id: str
    path: str  # repo-relative posix path
    line: int
    message: str
    suppressed: bool = False

    @property
    def fingerprint(self) -> tuple[str, str, str]:
        return (self.check_id, self.path, self.message)

    @property
    def location(self) -> str:
        return f"{self.path}:{self.line}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class SourceFile:
    """One parsed source file: text, AST, and suppression table."""

    def __init__(self, abspath: Path, root: Path) -> None:
        self.abspath = abspath
        self.root = root
        self.path = abspath.relative_to(root).as_posix()
        self.text = abspath.read_text()
        self.lines = self.text.splitlines()
        self.tree = ast.parse(self.text, filename=self.path)
        # line -> suppressed check ids on that line
        self.suppressions: dict[int, set[str]] = {}
        # (suppression line, check id) pairs that matched an emitted
        # finding this run: the stale-suppression audit's evidence.
        self.used_suppressions: set[tuple[int, str]] = set()
        # Only real comments suppress: the syntax quoted in a docstring must
        # not absorb findings on its line.
        for tok in tokenize.generate_tokens(io.StringIO(self.text).readline):
            if tok.type != tokenize.COMMENT:
                continue
            m = SUPPRESS_RE.search(tok.string)
            if m:
                ids = {c.strip() for c in m.group(1).split(",") if c.strip()}
                self.suppressions.setdefault(tok.start[0], set()).update(ids)

    @property
    def module(self) -> str:
        """Dotted module name for files under ``src/``; else the stem."""
        parts = Path(self.path).with_suffix("").parts
        if parts and parts[0] == "src":
            parts = parts[1:]
        name = ".".join(parts)
        return name[: -len(".__init__")] if name.endswith(".__init__") else name

    def match_suppression(self, line: int, check_id: str) -> int | None:
        """The suppression line covering ``line`` for ``check_id``: the
        finding's own line or the standalone line above.  Exact id only."""
        for ln in (line, line - 1):
            if check_id in self.suppressions.get(ln, ()):
                return ln
        return None


class AnalysisContext:
    """Everything a checker sees: the parsed file set plus the root."""

    def __init__(self, root: Path, files: Sequence[SourceFile]) -> None:
        self.root = Path(root)
        self.files = list(files)
        self._by_path = {f.path: f for f in self.files}
        # check ids selected for this run; set by run_analysis before any
        # checker executes (the stale-suppression audit only judges
        # suppressions whose checker actually ran).
        self.checks_run: set[str] = set()
        # Work several checkers share within one run (the kernel replays).
        self.memo: dict[str, Any] = {}

    def file(self, path: str) -> SourceFile | None:
        return self._by_path.get(path)

    def under(self, prefix: str) -> list[SourceFile]:
        """Files whose repo-relative path starts with ``prefix``."""
        return [f for f in self.files if f.path.startswith(prefix)]

    def scannable(self) -> list[SourceFile]:
        """Every file minus the intentional-violation fixtures."""
        return [f for f in self.files if not is_fixture_path(f.path)]


class Checker:
    """Base class: one contract.  Subclasses set ``check_id`` and
    ``description`` and implement :meth:`run`, emitting findings through
    :meth:`emit` (which applies the suppression table) and positive
    evidence through ``self.facts``."""

    check_id: str = ""
    description: str = ""

    def __init__(self) -> None:
        self.findings: list[Finding] = []
        self.facts: dict = {}

    def emit(self, sf: SourceFile, node: ast.AST | int, message: str) -> Finding:
        line = node if isinstance(node, int) else getattr(node, "lineno", 1)
        sline = sf.match_suppression(line, self.check_id)
        if sline is not None:
            sf.used_suppressions.add((sline, self.check_id))
        f = Finding(self.check_id, sf.path, line, message, suppressed=sline is not None)
        self.findings.append(f)
        return f

    def run(self, ctx: AnalysisContext) -> None:  # pragma: no cover - interface
        raise NotImplementedError


#: check id -> checker class.  Populated by :func:`register` at import of
#: ``repro_torch.analysis.checkers``.
REGISTRY: dict[str, type[Checker]] = {}


def register(cls: type[Checker]) -> type[Checker]:
    if not cls.check_id:
        raise ValueError(f"{cls.__name__} must declare a check_id")
    if cls.check_id in REGISTRY and REGISTRY[cls.check_id] is not cls:
        raise ValueError(f"duplicate checker id {cls.check_id!r}")
    REGISTRY[cls.check_id] = cls
    return cls


def default_checkers() -> list[str]:
    """All registered check ids, in registration order."""
    from repro_torch.analysis import checkers as _checkers  # noqa: F401 - registers

    return list(REGISTRY)


@dataclasses.dataclass
class Report:
    """The outcome of one analysis run, JSON-serializable."""

    root: str
    files_scanned: int
    checkers: list[dict]  # {id, description, findings, suppressed}
    findings: list[Finding]
    facts: dict

    @property
    def active(self) -> list[Finding]:
        return [f for f in self.findings if not f.suppressed]

    @property
    def suppressed(self) -> list[Finding]:
        return [f for f in self.findings if f.suppressed]

    def to_dict(self) -> dict:
        return {
            "schema": SCHEMA,
            "root": self.root,
            "files_scanned": self.files_scanned,
            "checkers": self.checkers,
            "totals": {
                "findings": len(self.findings),
                "active": len(self.active),
                "suppressed": len(self.suppressed),
            },
            "findings": [f.to_dict() for f in self.findings],
            "facts": self.facts,
        }

    def to_json(self, **kwargs: Any) -> str:
        kwargs.setdefault("indent", 2)
        kwargs.setdefault("sort_keys", True)
        return json.dumps(self.to_dict(), **kwargs)


def collect_files(root: Path, patterns: Sequence[str] = DEFAULT_SCAN) -> list[SourceFile]:
    """Parse every file matching ``patterns`` (globs relative to ``root``), sorted."""
    root = Path(root)
    paths = {p for pattern in patterns for p in root.glob(pattern) if p.is_file()}
    return [SourceFile(p, root) for p in sorted(paths)]


def run_analysis(
    root: Path | str,
    *,
    checks: Sequence[str] | None = None,
    patterns: Sequence[str] = DEFAULT_SCAN,
    files: Sequence[SourceFile] | None = None,
) -> Report:
    """Run the selected checkers over the repo and return a :class:`Report`.

    ``checks=None`` runs every registered checker; ``files`` injects a
    pre-parsed file set (the fixture tests use this to point a single
    checker at a snippet).
    """
    root = Path(root)
    registered = default_checkers()
    ids = list(checks) if checks is not None else registered
    unknown = [c for c in ids if c not in REGISTRY]
    if unknown:
        raise ValueError(f"unknown check ids {unknown}; registered: {sorted(REGISTRY)}")
    # The stale-suppression audit judges which suppressions the OTHER
    # checkers matched, so it must run after all of them.
    if "stale-suppression" in ids:
        ids = [c for c in ids if c != "stale-suppression"] + ["stale-suppression"]
    ctx = AnalysisContext(root, collect_files(root, patterns) if files is None else files)
    ctx.checks_run = set(ids)

    checker_rows: list[dict] = []
    findings: list[Finding] = []
    facts: dict = {}
    for cid in ids:
        checker = REGISTRY[cid]()
        checker.run(ctx)
        findings.extend(checker.findings)
        if checker.facts:
            facts[cid] = checker.facts
        checker_rows.append(
            {
                "id": cid,
                "description": checker.description,
                "findings": sum(not f.suppressed for f in checker.findings),
                "suppressed": sum(f.suppressed for f in checker.findings),
            }
        )
    findings.sort(key=lambda f: (f.path, f.line, f.check_id))
    return Report(str(root), len(ctx.files), checker_rows, findings, facts)


# --------------------------------------------------------------------------
# Shared AST helpers used by several checkers
# --------------------------------------------------------------------------


def dotted_name(node: ast.AST) -> str | None:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(node: ast.Call) -> str | None:
    return dotted_name(node.func)


def names_in(node: ast.AST) -> set[str]:
    """All Name identifiers loaded anywhere inside ``node``."""
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}
