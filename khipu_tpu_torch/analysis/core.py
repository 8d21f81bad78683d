"""Analyzer core: module loading, pragmas, baseline, rule driving.

Stdlib only. A ``Project`` is the parsed view of every ``*.py`` file
under the scanned paths; per-module rules walk one tree at a time and
whole-program rules (the lock-order analysis) see the project after
every module has parsed. Findings are suppressed two ways:

* a pragma comment ``# khipu-lint: ok KL00x <reason>`` on the flagged
  line or the line directly above it (comment tokens only — a pragma
  inside a string literal does not count), or
* a fingerprint match against the committed baseline file
  (``baseline.json`` beside this package) — line numbers are NOT part
  of the fingerprint so unrelated edits cannot churn it.
"""

from __future__ import annotations

import ast
import io
import json
import os
import re
import tokenize
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Set

SEVERITY_ERROR = "error"
SEVERITY_WARNING = "warning"

_PRAGMA_RE = re.compile(
    r"#\s*khipu-lint:\s*ok\s+(KL\d{3}(?:\s*,\s*KL\d{3})*)\s*(.*)"
)

DEFAULT_BASELINE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "baseline.json"
)


@dataclass(frozen=True)
class Finding:
    """One rule violation at one site. ``context`` is the enclosing
    function's qualname (or ``<module>``) — it anchors the baseline
    fingerprint so line drift elsewhere in the file never invalidates
    an accepted entry."""

    rule: str
    severity: str
    path: str  # posix-style, relative to the scan invocation
    line: int
    message: str
    context: str = "<module>"

    @property
    def fingerprint(self) -> str:
        return "|".join((self.rule, self.path, self.context, self.message))

    def render(self) -> str:
        return (
            f"{self.path}:{self.line}: {self.rule} {self.severity}: "
            f"{self.message} [{self.context}]"
        )


class Module:
    """One parsed source file plus its pragma map."""

    def __init__(self, path: str, source: str, tree: ast.Module):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self.pragmas: Dict[int, Set[str]] = _collect_pragmas(source)
        _attach_parents(tree)

    def suppressed(self, rule: str, line: int) -> bool:
        """Pragma on the flagged line, or anywhere in the contiguous
        comment block directly above it (multi-line reasons)."""
        if rule in self.pragmas.get(line, ()):
            return True
        ln = line - 1
        while 1 <= ln <= len(self.lines):
            text = self.lines[ln - 1].strip()
            if not text.startswith("#"):
                break
            if rule in self.pragmas.get(ln, ()):
                return True
            ln -= 1
        return False


class Project:
    """Every module under the scanned paths."""

    def __init__(self, modules: List[Module]):
        self.modules = modules
        self.by_path = {m.path: m for m in modules}

    @property
    def parse_errors(self) -> List[Finding]:
        return getattr(self, "_parse_errors", [])


def _attach_parents(tree: ast.AST) -> None:
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child._kl_parent = node  # type: ignore[attr-defined]


def parent(node: ast.AST) -> Optional[ast.AST]:
    return getattr(node, "_kl_parent", None)


def enclosing_function(node: ast.AST) -> str:
    """Dotted qualname of the innermost enclosing def chain (class
    names included), or ``<module>``."""
    names: List[str] = []
    cur = parent(node)
    while cur is not None:
        if isinstance(
            cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            names.append(cur.name)
        cur = parent(cur)
    return ".".join(reversed(names)) if names else "<module>"


def in_with_transfer(node: ast.AST) -> bool:
    """True when ``node`` sits inside a ``with *.transfer(...)`` block
    (the TransferLedger timing-context idiom)."""
    cur = parent(node)
    while cur is not None:
        if isinstance(cur, ast.With):
            for item in cur.items:
                ctx = item.context_expr
                if (
                    isinstance(ctx, ast.Call)
                    and isinstance(ctx.func, ast.Attribute)
                    and ctx.func.attr == "transfer"
                ):
                    return True
        cur = parent(cur)
    return False


def _collect_pragmas(source: str) -> Dict[int, Set[str]]:
    pragmas: Dict[int, Set[str]] = {}
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _PRAGMA_RE.search(tok.string)
            if m:
                codes = {c.strip() for c in m.group(1).split(",")}
                pragmas.setdefault(tok.start[0], set()).update(codes)
    except (tokenize.TokenError, IndentationError, SyntaxError):
        pass
    return pragmas


# ------------------------------------------------------------ file walk


def iter_python_files(paths: Sequence[str]) -> Iterable[str]:
    seen: Set[str] = set()
    for p in paths:
        if os.path.isfile(p):
            if p not in seen:
                seen.add(p)
                yield p
        elif os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(
                    d for d in dirs
                    if d != "__pycache__" and not d.startswith(".")
                )
                for f in sorted(files):
                    if f.endswith(".py"):
                        full = os.path.join(root, f)
                        if full not in seen:
                            seen.add(full)
                            yield full


def _rel_posix(path: str) -> str:
    cwd = os.getcwd()
    ap = os.path.abspath(path)
    if ap.startswith(cwd + os.sep):
        ap = os.path.relpath(ap, cwd)
    return ap.replace(os.sep, "/")


def load_project(paths: Sequence[str]) -> Project:
    modules: List[Module] = []
    errors: List[Finding] = []
    for f in iter_python_files(paths):
        rel = _rel_posix(f)
        try:
            with open(f, "r", encoding="utf-8") as fh:
                source = fh.read()
            tree = ast.parse(source, filename=rel)
        except (SyntaxError, UnicodeDecodeError, OSError) as e:
            errors.append(Finding(
                rule="KL000",
                severity=SEVERITY_ERROR,
                path=rel,
                line=getattr(e, "lineno", 0) or 0,
                message=f"unparseable module: {e.__class__.__name__}",
            ))
            continue
        modules.append(Module(rel, source, tree))
    project = Project(modules)
    project._parse_errors = errors  # type: ignore[attr-defined]
    return project


# ------------------------------------------------------------- baseline


def load_baseline(path: Optional[str] = None) -> Dict[str, dict]:
    """{fingerprint: entry}. A missing file is an empty baseline."""
    path = path or DEFAULT_BASELINE
    if not os.path.isfile(path):
        return {}
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    out: Dict[str, dict] = {}
    for entry in data.get("entries", []):
        fp = "|".join((
            entry["rule"], entry["path"], entry.get("context", "<module>"),
            entry["message"],
        ))
        out[fp] = entry
    return out


def write_baseline(findings: Sequence[Finding], path: str) -> None:
    entries = [
        {
            "rule": f.rule,
            "path": f.path,
            "context": f.context,
            "message": f.message,
            "reason": "baselined — fix or annotate, then remove",
        }
        for f in sorted(findings, key=lambda f: (f.rule, f.path, f.line))
    ]
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"version": 1, "entries": entries}, fh, indent=2)
        fh.write("\n")


# --------------------------------------------------------------- driver


def run_analysis(
    paths: Sequence[str],
    rules: Optional[Sequence[object]] = None,
    baseline: Optional[Dict[str, dict]] = None,
) -> dict:
    """Run every rule over ``paths``.

    Returns ``{"findings": [new], "baselined": [known], "stale":
    [baseline entries that no longer match], "project": Project}``.
    Pragma-suppressed findings are dropped before baseline matching.
    """
    from khipu_tpu_torch.analysis.rules import ALL_RULES

    project = load_project(paths)
    active = list(rules) if rules is not None else list(ALL_RULES)
    raw: List[Finding] = list(project.parse_errors)
    for rule in active:
        check_module = getattr(rule, "check_module", None)
        if check_module is not None:
            for mod in project.modules:
                raw.extend(check_module(mod))
        check_project = getattr(rule, "check_project", None)
        if check_project is not None:
            raw.extend(check_project(project))

    visible: List[Finding] = []
    for f in raw:
        mod = project.by_path.get(f.path)
        if mod is not None and mod.suppressed(f.rule, f.line):
            continue
        visible.append(f)
    visible.sort(key=lambda f: (f.path, f.line, f.rule))

    baseline = baseline if baseline is not None else {}
    new: List[Finding] = []
    known: List[Finding] = []
    seen_fps: Set[str] = set()
    for f in visible:
        seen_fps.add(f.fingerprint)
        (known if f.fingerprint in baseline else new).append(f)
    stale = [
        entry for fp, entry in baseline.items() if fp not in seen_fps
    ]
    return {
        "findings": new,
        "baselined": known,
        "stale": stale,
        "project": project,
    }
