"""KL005 — observability discipline.

Two invariants from the tracing/metrics planes (docs/observability.md):

* ``span(...)`` must be used as a context manager. The span ring
  publishes on ``__exit__``; a span that is called and never entered
  (or entered by hand and dropped on an exception path) leaks an
  unclosed span into the nesting audit and skews the recorder's
  phase percentiles. Only the ``with span(...)`` form is audited to
  be exception-safe.

* Registry families must be created at module import time. The
  registry de-duplicates by (name, labels), so a family created
  per-call "works" — but its help text / bucket shape is then decided
  by whichever call path ran first, and the scrape-pass collector
  cache (PR-7) assumes the family set is stable after import. The one
  sanctioned exception is lazy creation of LABELED children under a
  creation lock (profiler/slo idiom) — a ``labels=`` kwarg marks it.
"""

from __future__ import annotations

import ast
from typing import Iterator

from khipu_tpu_torch.analysis.core import (
    SEVERITY_ERROR,
    Finding,
    Module,
    enclosing_function,
    parent,
)

RULE_ID = "KL005"

_FAMILY_CTORS = {"counter", "gauge", "histogram", "gauge_group"}

_EXEMPT_SUFFIXES = (
    "observability/trace.py",  # defines span()
    "observability/registry.py",  # defines the family ctors
)


def _in_function(node: ast.AST) -> bool:
    cur = parent(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return True
        cur = parent(cur)
    return False


def _is_withitem_context(node: ast.AST) -> bool:
    p = parent(node)
    return isinstance(p, ast.withitem) and p.context_expr is node


class Rule:
    id = RULE_ID
    severity = SEVERITY_ERROR
    description = (
        "span not used as a context manager / registry family "
        "created after import time"
    )

    def check_module(self, mod: Module) -> Iterator[Finding]:
        if mod.path.endswith(_EXEMPT_SUFFIXES):
            return
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            # --- span discipline -------------------------------------
            is_span = (
                isinstance(f, ast.Name) and f.id == "span"
            ) or (
                isinstance(f, ast.Attribute) and f.attr == "span"
            )
            if is_span and not _is_withitem_context(node):
                yield Finding(
                    rule=self.id,
                    severity=self.severity,
                    path=mod.path,
                    line=node.lineno,
                    message=(
                        "span opened outside a `with` statement — "
                        "only the context-manager form closes the "
                        "span on every exit path"
                    ),
                    context=enclosing_function(node),
                )
                continue
            # --- registry family discipline --------------------------
            if (
                isinstance(f, ast.Attribute)
                and f.attr in _FAMILY_CTORS
                and "registry" in ast.unparse(f.value).lower()
                and _in_function(node)
                and not any(k.arg == "labels" for k in node.keywords)
            ):
                yield Finding(
                    rule=self.id,
                    severity=self.severity,
                    path=mod.path,
                    line=node.lineno,
                    message=(
                        f"registry family `{f.attr}(...)` created "
                        "inside a function — create families at "
                        "module import time (lazy LABELED children "
                        "are the only sanctioned runtime creation)"
                    ),
                    context=enclosing_function(node),
                )
