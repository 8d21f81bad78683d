"""KL002 — chaos-unsafe broad exception handlers.

``chaos.InjectedDeath`` subclasses ``BaseException`` precisely so that
``except Exception`` cannot swallow it — a die fault must behave like a
SIGKILL (docs/recovery.md fail-stop contract). The remaining hole is a
bare ``except:`` or an ``except BaseException`` that neither re-raises
nor was deliberately annotated: such a handler turns an injected death
into a silently-handled error, the 120-seed corruption sweep stops
meaning anything, and real crash recovery diverges from what chaos
tested.

A handler is safe when its body contains any ``raise`` (bare re-raise,
re-raise of the bound name, or raise-from — the fault still propagates
and fail-stops the plane). Everything else needs the explicit
``# khipu-lint: ok KL002 <reason>`` pragma stating why the swallow is
correct (e.g. a ctypes callback boundary that captures and re-raises
on the host side).
"""

from __future__ import annotations

import ast
from typing import Iterator

from khipu_tpu_torch.analysis.core import (
    SEVERITY_ERROR,
    Finding,
    Module,
    enclosing_function,
)

RULE_ID = "KL002"


def _is_broad(h: ast.ExceptHandler) -> str:
    """'' when narrow; otherwise a human name for the broad catch."""
    t = h.type
    if t is None:
        return "bare except:"
    names = []
    for node in [t] + (list(t.elts) if isinstance(t, ast.Tuple) else []):
        if isinstance(node, ast.Name):
            names.append(node.id)
        elif isinstance(node, ast.Attribute):
            names.append(node.attr)
    if "BaseException" in names:
        return "except BaseException"
    return ""


def _reraises(h: ast.ExceptHandler) -> bool:
    for node in ast.walk(h):
        if isinstance(node, ast.Raise):
            return True
    return False


class Rule:
    id = RULE_ID
    severity = SEVERITY_ERROR
    description = (
        "broad except would swallow chaos InjectedDeath "
        "(fail-stop semantics)"
    )

    def check_module(self, mod: Module) -> Iterator[Finding]:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            broad = _is_broad(node)
            if not broad or _reraises(node):
                continue
            yield Finding(
                rule=self.id,
                severity=self.severity,
                path=mod.path,
                line=node.lineno,
                message=(
                    f"`{broad}` without re-raise would swallow "
                    "InjectedDeath — catch Exception, re-raise, or "
                    "annotate why the swallow is chaos-safe"
                ),
                context=enclosing_function(node),
            )
