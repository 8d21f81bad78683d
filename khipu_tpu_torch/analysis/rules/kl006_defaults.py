"""KL006 — mutable default arguments.

A ``def f(x=[])`` default is evaluated once at import and shared by
every call — in a tree this threaded (driver, collector thread, shard
servers, serving workers all share modules) a mutated default is a
cross-thread, cross-request data leak that no lock discipline can
save. Flagged: list/dict/set displays and comprehension literals, and
zero-argument ``list()``/``dict()``/``set()``/``bytearray()`` calls in
any default position (positional or keyword-only).
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

RULE_ID = "KL006"

_MUTABLE_NODES = (
    ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp, ast.SetComp,
)
_MUTABLE_CTORS = {"list", "dict", "set", "bytearray"}


def _is_mutable(node: ast.AST) -> bool:
    if isinstance(node, _MUTABLE_NODES):
        return True
    return (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Name)
        and node.func.id in _MUTABLE_CTORS
    )


class Rule:
    id = RULE_ID
    severity = SEVERITY_ERROR
    description = "mutable default argument"

    def check_module(self, mod: Module) -> Iterator[Finding]:
        for node in ast.walk(mod.tree):
            if not isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef)
            ):
                continue
            defaults = list(node.args.defaults) + [
                d for d in node.args.kw_defaults if d is not None
            ]
            for d in defaults:
                if _is_mutable(d):
                    yield Finding(
                        rule=self.id,
                        severity=self.severity,
                        path=mod.path,
                        line=d.lineno,
                        message=(
                            f"mutable default argument in "
                            f"`{node.name}(...)` — default to None "
                            "and construct inside the function"
                        ),
                        context=enclosing_function(d),
                    )
