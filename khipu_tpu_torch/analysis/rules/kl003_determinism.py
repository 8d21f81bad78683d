"""KL003 — nondeterminism inside deterministic replay paths.

Deterministic replay is the repo's load-bearing test instrument: the
chaos harness replays fault schedules by seed (chaos/plan.py), the
journal recovers windows bit-exactly (sync/journal.py), and the
cluster retry schedule must replay identically for a given seed. Any
wall-clock read or unseeded RNG draw on those paths makes a replay
diverge in ways no assertion can pin down.

Scope: modules whose path contains a ``sync``, ``trie``, ``ledger``,
``storage``, ``chaos`` or ``cluster`` directory segment. Flagged:
``time.time``/``time.time_ns``, ``datetime.now/utcnow/today``,
module-level ``random.*`` draws (a seeded ``random.Random(seed)``
instance is the approved seam), and unseeded ``np.random`` access.
Monotonic timing (``perf_counter``/``monotonic``) is allowed — it
feeds metrics, never replayed state.
"""

from __future__ import annotations

import ast
from typing import Iterator, Set

from khipu_tpu_torch.analysis.core import (
    SEVERITY_ERROR,
    Finding,
    Module,
    enclosing_function,
)

RULE_ID = "KL003"

PROTECTED_SEGMENTS = {
    "sync", "trie", "ledger", "storage", "chaos", "cluster",
}

_TIME_BANNED = {"time", "time_ns"}
_DATETIME_BANNED = {"now", "utcnow", "today"}
# random-module attributes that are fine: the seeded-instance
# constructor (with a seed argument) and explicit global seeding
_RANDOM_SEEDED_CTORS = {"Random", "SystemRandom"}
_NP_SEEDED_OK = {"default_rng", "RandomState", "Generator", "seed"}


def _module_aliases(tree: ast.Module, target: str) -> Set[str]:
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == target:
                    out.add(a.asname or a.name)
    return out


def _from_imports(tree: ast.Module, target: str) -> Set[str]:
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == target:
            for a in node.names:
                out.add(a.asname or a.name)
    return out


def _protected(path: str) -> bool:
    return bool(PROTECTED_SEGMENTS & set(path.split("/")[:-1]))


class Rule:
    id = RULE_ID
    severity = SEVERITY_ERROR
    description = (
        "wall-clock or unseeded RNG in a deterministic replay path"
    )

    def check_module(self, mod: Module) -> Iterator[Finding]:
        if not _protected(mod.path):
            return
        time_mods = _module_aliases(mod.tree, "time")
        random_mods = _module_aliases(mod.tree, "random")
        dt_mods = _module_aliases(mod.tree, "datetime")
        np_mods = _module_aliases(mod.tree, "numpy")
        random_names = {
            n for n in _from_imports(mod.tree, "random")
            if n not in _RANDOM_SEEDED_CTORS
        }
        time_names = _from_imports(mod.tree, "time") & _TIME_BANNED

        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            bad = self._classify(
                node, time_mods, random_mods, dt_mods, np_mods,
                random_names, time_names,
            )
            if bad:
                yield Finding(
                    rule=self.id,
                    severity=self.severity,
                    path=mod.path,
                    line=node.lineno,
                    message=(
                        f"nondeterministic call `{bad}` in a "
                        "deterministic path — route through a seeded "
                        "RNG / injected clock seam"
                    ),
                    context=enclosing_function(node),
                )

    def _classify(self, call: ast.Call, time_mods, random_mods,
                  dt_mods, np_mods, random_names, time_names) -> str:
        f = call.func
        if isinstance(f, ast.Name):
            if f.id in random_names:
                return f"random.{f.id}"
            if f.id in time_names:
                return f"time.{f.id}"
            return ""
        if not isinstance(f, ast.Attribute):
            return ""
        recv = f.value
        if isinstance(recv, ast.Name):
            if recv.id in time_mods and f.attr in _TIME_BANNED:
                return f"time.{f.attr}"
            if recv.id in random_mods:
                if f.attr in _RANDOM_SEEDED_CTORS:
                    return "" if call.args else f"random.{f.attr}()"
                if f.attr == "seed":
                    return ""
                return f"random.{f.attr}"
            if recv.id in dt_mods and f.attr in _DATETIME_BANNED:
                return f"datetime.{f.attr}"
        # datetime.datetime.now() / np.random.X()
        if isinstance(recv, ast.Attribute) and isinstance(
            recv.value, ast.Name
        ):
            if (
                recv.value.id in dt_mods
                and recv.attr == "datetime"
                and f.attr in _DATETIME_BANNED
            ):
                return f"datetime.datetime.{f.attr}"
            if recv.value.id in np_mods and recv.attr == "random":
                if f.attr in _NP_SEEDED_OK:
                    if f.attr == "seed" or call.args:
                        return ""
                    return f"np.random.{f.attr}()"
                return f"np.random.{f.attr}"
        return ""
