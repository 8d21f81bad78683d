"""KL004 — static lock-order and blocking-under-lock analysis.

The Eraser lockset idea turned inside out: instead of detecting races
at runtime, derive the locking discipline from the tree and fail the
build when it drifts. Khipu's planes share one process — driver,
collector thread, shard bridge servers, serving workers, health
probes — and the 40+ ``threading.Lock``/``RLock``/``Condition`` sites
have no checked acquisition order. A cycle in the may-acquire order
graph is a latent deadlock that only a specific thread interleaving
exposes; a blocking call (RPC, ``device_get``, ``Thread.join``,
``sleep``) made while holding a lock is a latent convoy that turns one
slow shard into a stalled plane.

Approach (intra-package, flow-insensitive where it must be):

1. Per module, collect lock *identities* — ``self.X =
   threading.Lock()`` keyed ``(module, class, attr)``, module-level
   and function-local locks keyed by name — plus per-function event
   streams: lock acquisitions (``with`` items and ``.acquire()``
   calls) with the held-set at that point, calls with the held-set,
   and directly-blocking calls.
2. Resolve calls over an intra-package graph: ``self.m()`` to the same
   class, bare names to module/nested functions and from-imports,
   ``self.attr.m()`` through ``self.attr = Ctor(...)`` attribute
   types, ``Ctor(...)`` to ``Ctor.__init__``.
3. Fixpoint ``may_acquire`` and ``may_block`` over the call graph,
   then emit order edges ``held -> acquired`` (direct nesting and
   through calls) and report: SCC cycles in the order graph (error),
   same-non-reentrant-lock re-acquisition (error), and blocking calls
   — direct or via a callee — under any held lock (warning).
4. Shared-mutable-state locksets (the Eraser half proper):
   ``Thread(target=...)`` callables and the functions that spawn them
   are thread entry points ("roots"); a per-root *always-held*
   intersection fixpoint gives the locks provably held whenever each
   function runs under that root.  A ``self.attr`` write's lockset is
   the always-held set plus the locks held at the write site; an
   attribute written from >= 2 distinct roots whose write locksets
   share no common lock is a latent write-write race (warning).
   ``__init__`` bodies are exempt — construction happens before
   publication.

Identity is per (class, attr), not per instance: two instances of the
same class share an order node, which over-approximates (safe) and
keeps fingerprints stable for the baseline.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from khipu_tpu_torch.analysis.core import (
    SEVERITY_ERROR,
    SEVERITY_WARNING,
    Finding,
    Module,
    Project,
)

RULE_ID = "KL004"

LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore",
              "BoundedSemaphore"}
REENTRANT_CTORS = {"RLock"}

_RPC_ATTRS = {
    "get_node_data", "put_node_data", "stream_node_data",
    "get_trace_spans", "khipu_metrics", "window_report", "ping",
}
_THREADISH = re.compile(r"thread|worker|collector|proc", re.I)
_THREAD_NAMES = {"t", "w", "th"}


class LockId(tuple):
    """(module_path, scope, attr) — ``scope`` is the class name, a
    function qualname for locals, or '' for module globals."""

    def render(self) -> str:
        mod, scope, attr = self
        short = mod.rsplit("/", 1)[-1]
        return f"{short}::{scope + '.' if scope else ''}{attr}"


class FuncInfo:
    def __init__(self, key: Tuple[str, str]):
        self.key = key  # (module_path, qualname)
        self.acquires: List[Tuple[LockId, Tuple[LockId, ...], int]] = []
        self.calls: List[Tuple[tuple, Tuple[LockId, ...], int]] = []
        self.blocking: List[Tuple[str, str, Tuple[LockId, ...], int]] = []
        # self.attr writes: (class, attr, held-set, line)
        self.writes: List[Tuple[str, str, Tuple[LockId, ...], int]] = []
        # Thread(target=...) callable refs spawned by this function
        self.thread_targets: List[Tuple[tuple, int]] = []


class ModuleScan:
    def __init__(self, mod: Module):
        self.mod = mod
        self.path = mod.path
        self.threading_aliases: Set[str] = set()
        self.threading_names: Set[str] = set()
        self.thread_ctor_names: Set[str] = set()  # from-imported Thread
        self.time_aliases: Set[str] = set()
        self.time_sleep_names: Set[str] = set()
        self.jax_aliases: Set[str] = set()
        # local binding -> dotted module ("import khipu_tpu.x as y")
        self.module_imports: Dict[str, str] = {}
        # local binding -> (dotted module, original name)
        self.object_imports: Dict[str, Tuple[str, str]] = {}
        # class -> {attr: ctor_name} for locks
        self.class_locks: Dict[str, Dict[str, str]] = {}
        # class -> {attr: (binding, class_name)} resolved in pass 2
        self.attr_types: Dict[str, Dict[str, str]] = {}
        self.module_locks: Dict[str, str] = {}
        self.classes: Dict[str, Set[str]] = {}  # class -> method names
        # class -> base-class bindings as written ("Base", "mod.Base")
        self.class_bases: Dict[str, List[str]] = {}
        self.functions: Dict[str, FuncInfo] = {}  # qualname -> info


def _dotted(path: str) -> str:
    p = path[:-3] if path.endswith(".py") else path
    if p.endswith("/__init__"):
        p = p[: -len("/__init__")]
    return p.replace("/", ".")


class _Scanner:
    """Pass 1: one module, no cross-module knowledge yet."""

    def __init__(self, mod: Module):
        self.s = ModuleScan(mod)
        self._collect_imports(mod.tree)
        self._collect_toplevel(mod.tree)

    # ------------------------------------------------------- collection

    def _collect_imports(self, tree: ast.Module) -> None:
        s = self.s
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    bind = a.asname or a.name.split(".")[0]
                    if a.name == "threading":
                        s.threading_aliases.add(bind)
                    elif a.name == "time":
                        s.time_aliases.add(bind)
                    elif a.name == "jax" or a.name.startswith("jax."):
                        s.jax_aliases.add(bind)
                    s.module_imports[bind] = a.name
            elif isinstance(node, ast.ImportFrom):
                if node.module is None:
                    continue
                for a in node.names:
                    bind = a.asname or a.name
                    if node.module == "threading":
                        if a.name in LOCK_CTORS:
                            s.threading_names.add(bind)
                        elif a.name in ("Thread", "Timer"):
                            s.thread_ctor_names.add(bind)
                    elif node.module == "time" and a.name == "sleep":
                        s.time_sleep_names.add(bind)
                    s.object_imports[bind] = (node.module, a.name)

    def _lock_ctor(self, call: ast.Call) -> str:
        """Ctor name when ``call`` constructs a lock, else ''."""
        f = call.func
        if (
            isinstance(f, ast.Attribute)
            and isinstance(f.value, ast.Name)
            and f.value.id in self.s.threading_aliases
            and f.attr in LOCK_CTORS
        ):
            return f.attr
        if isinstance(f, ast.Name) and f.id in self.s.threading_names:
            return f.id
        return ""

    def _collect_toplevel(self, tree: ast.Module) -> None:
        s = self.s
        for stmt in tree.body:
            if isinstance(stmt, ast.Assign) and isinstance(
                stmt.value, ast.Call
            ):
                ctor = self._lock_ctor(stmt.value)
                if ctor:
                    for t in stmt.targets:
                        if isinstance(t, ast.Name):
                            s.module_locks[t.id] = ctor
            if isinstance(stmt, ast.ClassDef):
                s.classes[stmt.name] = {
                    b.name for b in stmt.body
                    if isinstance(
                        b, (ast.FunctionDef, ast.AsyncFunctionDef)
                    )
                }
                bases: List[str] = []
                for b in stmt.bases:
                    if isinstance(b, ast.Name):
                        bases.append(b.id)
                    elif isinstance(b, ast.Attribute) and isinstance(
                        b.value, ast.Name
                    ):
                        bases.append(f"{b.value.id}.{b.attr}")
                s.class_bases[stmt.name] = bases
                self._collect_class(stmt)
        # functions (including nested) get walked after lock discovery
        for stmt in tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._walk_function(stmt, stmt.name, None)
            elif isinstance(stmt, ast.ClassDef):
                for b in stmt.body:
                    if isinstance(
                        b, (ast.FunctionDef, ast.AsyncFunctionDef)
                    ):
                        self._walk_function(
                            b, f"{stmt.name}.{b.name}", stmt.name
                        )

    def _collect_class(self, cls: ast.ClassDef) -> None:
        s = self.s
        locks: Dict[str, str] = {}
        types: Dict[str, str] = {}
        for node in ast.walk(cls):
            if not (
                isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Call)
            ):
                continue
            for t in node.targets:
                if not (
                    isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                ):
                    continue
                ctor = self._lock_ctor(node.value)
                if ctor:
                    locks[t.attr] = ctor
                    continue
                f = node.value.func
                # self.X = Ctor(...) / mod.Ctor(...): attribute type
                if isinstance(f, ast.Name):
                    types[t.attr] = f.id
                elif isinstance(f, ast.Attribute) and isinstance(
                    f.value, ast.Name
                ):
                    types[t.attr] = f"{f.value.id}.{f.attr}"
        s.class_locks[cls.name] = locks
        s.attr_types[cls.name] = types

    # ---------------------------------------------------- function walk

    def _walk_function(self, fn, qualname: str,
                       cls: Optional[str]) -> None:
        s = self.s
        info = FuncInfo((s.path, qualname))
        s.functions[qualname] = info
        local_locks: Dict[str, str] = {}
        self._block(fn.body, [], info, cls, qualname, local_locks)

    def _lock_of(self, expr: ast.AST, cls: Optional[str], qualname: str,
                 local_locks: Dict[str, str]) -> Optional[LockId]:
        s = self.s
        if isinstance(expr, ast.Name):
            if expr.id in local_locks:
                return LockId((s.path, qualname, expr.id))
            if expr.id in s.module_locks:
                return LockId((s.path, "", expr.id))
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
            and cls is not None
            and expr.attr in s.class_locks.get(cls, ())
        ):
            return LockId((s.path, cls, expr.attr))
        return None

    def lock_ctor_of(self, lock: LockId) -> str:
        mod, scope, attr = lock
        if scope and scope in self.s.class_locks:
            return self.s.class_locks[scope].get(attr, "")
        if not scope:
            return self.s.module_locks.get(attr, "")
        return ""  # function-local

    def _block(self, stmts, held: List[LockId], info: FuncInfo,
               cls, qualname, local_locks) -> List[LockId]:
        held = list(held)
        for stmt in stmts:
            held = self._stmt(stmt, held, info, cls, qualname,
                              local_locks)
        return held

    def _stmt(self, stmt, held, info, cls, qualname, local_locks):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested def runs later (possibly on another thread):
            # analyzed as its own function with an empty held-set
            self._walk_function(stmt, f"{qualname}.{stmt.name}", cls)
            return held
        if isinstance(stmt, ast.ClassDef):
            return held
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            newly: List[LockId] = []
            for item in stmt.items:
                lock = self._lock_of(item.context_expr, cls, qualname,
                                     local_locks)
                if lock is not None:
                    info.acquires.append(
                        (lock, tuple(held + newly), item.context_expr.lineno)
                    )
                    newly.append(lock)
                else:
                    self._scan_calls(item.context_expr, held + newly,
                                     info, cls, qualname, local_locks)
            self._block(stmt.body, held + newly, info, cls, qualname,
                        local_locks)
            return held
        if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            self._record_writes(stmt, held, info, cls)
        if isinstance(stmt, ast.Assign) and isinstance(
            stmt.value, ast.Call
        ):
            ctor = self._lock_ctor(stmt.value)
            if ctor:
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        local_locks[t.id] = ctor
                return held
        # expressions embedded in this statement (incl. If.test etc.)
        for field in ast.iter_child_nodes(stmt):
            if isinstance(field, ast.expr):
                held = self._scan_calls(field, held, info, cls,
                                        qualname, local_locks)
        # sub-blocks
        for attr in ("body", "orelse", "finalbody"):
            sub = getattr(stmt, attr, None)
            if sub:
                self._block(sub, held, info, cls, qualname, local_locks)
        for h in getattr(stmt, "handlers", ()):
            self._block(h.body, held, info, cls, qualname, local_locks)
        return held

    def _record_writes(self, stmt, held, info, cls) -> None:
        """``self.attr = ...`` targets, plain or tuple-unpacked.
        Subscript targets (container mutation) and writes to the lock
        attributes themselves are out of scope."""
        if cls is None:
            return
        targets = (stmt.targets if isinstance(stmt, ast.Assign)
                   else [stmt.target])
        flat: List[ast.AST] = []
        for t in targets:
            flat.extend(t.elts if isinstance(t, (ast.Tuple, ast.List))
                        else [t])
        for t in flat:
            if (
                isinstance(t, ast.Attribute)
                and isinstance(t.value, ast.Name)
                and t.value.id == "self"
                and t.attr not in self.s.class_locks.get(cls, ())
            ):
                info.writes.append((cls, t.attr, tuple(held), t.lineno))

    def _thread_ctor(self, call: ast.Call) -> str:
        """'Thread'/'Timer' when ``call`` constructs one, else ''."""
        f = call.func
        if (
            isinstance(f, ast.Attribute)
            and isinstance(f.value, ast.Name)
            and f.value.id in self.s.threading_aliases
            and f.attr in ("Thread", "Timer")
        ):
            return f.attr
        if isinstance(f, ast.Name) and f.id in self.s.thread_ctor_names:
            return f.id
        return ""

    def _scan_calls(self, expr, held, info, cls, qualname, local_locks):
        held = list(held)
        calls = [n for n in ast.walk(expr) if isinstance(n, ast.Call)]
        calls.sort(key=lambda c: (c.lineno, c.col_offset))
        for call in calls:
            f = call.func
            ctor = self._thread_ctor(call)
            if ctor:
                # the target runs on ANOTHER thread — record it as a
                # thread entry point, not a synchronous call edge
                refs = [kw.value for kw in call.keywords
                        if kw.arg in ("target", "function")]
                if ctor == "Timer" and len(call.args) >= 2:
                    refs.append(call.args[1])
                for r in refs:
                    tref = self._callable_arg_ref(r, cls)
                    if tref is not None:
                        info.thread_targets.append((tref, call.lineno))
                continue
            if isinstance(f, ast.Attribute):
                lock = self._lock_of(f.value, cls, qualname, local_locks)
                if lock is not None and f.attr == "acquire":
                    info.acquires.append(
                        (lock, tuple(held), call.lineno)
                    )
                    held.append(lock)
                    continue
                if lock is not None and f.attr == "release":
                    held = [h for h in held if h != lock]
                    continue
            # a function/method REFERENCE passed as an argument is a
            # call edge too: the receiver may invoke it synchronously
            # under the caller's held-set (registry collectors, the
            # cluster client's ``_call(endpoint, op)`` trampoline,
            # ``sorted(key=...)``) — conservative, like the rest of
            # the analysis
            for a in list(call.args) + [
                kw.value for kw in call.keywords
            ]:
                aref = self._callable_arg_ref(a, cls)
                if aref is not None:
                    info.calls.append(
                        (aref, tuple(held), call.lineno)
                    )
            kind, desc = self._blocking_kind(call)
            if kind:
                info.blocking.append(
                    (kind, desc, tuple(held), call.lineno)
                )
                continue
            ref = self._callee_ref(call, cls)
            if ref is not None:
                info.calls.append((ref, tuple(held), call.lineno))
        return held

    def _callable_arg_ref(self, expr: ast.AST,
                          cls: Optional[str]) -> Optional[tuple]:
        """A bare name or ``self.attr`` passed as an argument. Names
        that are plain data (locals, parameters) resolve to nothing
        later; names that collide with a known function create an
        over-approximate edge — acceptable for a may-analysis."""
        if isinstance(expr, ast.Name):
            return ("name", expr.id)
        if isinstance(expr, ast.Attribute) and isinstance(
            expr.value, ast.Name
        ):
            if expr.value.id == "self" and cls is not None:
                return ("self", cls, expr.attr)
            return ("dotted", expr.value.id, expr.attr)
        return None

    def _blocking_kind(self, call: ast.Call) -> Tuple[str, str]:
        s = self.s
        f = call.func
        if isinstance(f, ast.Name):
            if f.id in s.time_sleep_names:
                return "sleep", "time.sleep"
            return "", ""
        if not isinstance(f, ast.Attribute):
            return "", ""
        recv = f.value
        recv_txt = ast.unparse(recv)
        if f.attr == "sleep" and (
            (isinstance(recv, ast.Name) and recv.id in s.time_aliases)
            or recv_txt.endswith("_sleep")
        ):
            return "sleep", f"{recv_txt}.sleep"
        if f.attr == "_sleep":
            return "sleep", f"{recv_txt}._sleep"
        if f.attr == "join" and (
            _THREADISH.search(recv_txt)
            or (isinstance(recv, ast.Name) and recv.id in _THREAD_NAMES)
        ):
            return "join", f"{recv_txt}.join"
        if f.attr in ("device_get", "device_put") and (
            isinstance(recv, ast.Name) and recv.id in s.jax_aliases
        ):
            return "device", f"jax.{f.attr}"
        if f.attr == "block_until_ready":
            return "device", f"{recv_txt}.block_until_ready"
        if f.attr in _RPC_ATTRS or f.attr.startswith("rpc_"):
            return "rpc", f"{recv_txt}.{f.attr}"
        return "", ""

    def _callee_ref(self, call: ast.Call,
                    cls: Optional[str]) -> Optional[tuple]:
        f = call.func
        if isinstance(f, ast.Name):
            return ("name", f.id)
        if isinstance(f, ast.Attribute):
            recv = f.value
            if isinstance(recv, ast.Name):
                if recv.id == "self" and cls is not None:
                    return ("self", cls, f.attr)
                return ("dotted", recv.id, f.attr)
            if (
                isinstance(recv, ast.Attribute)
                and isinstance(recv.value, ast.Name)
                and recv.value.id == "self"
                and cls is not None
            ):
                return ("self_attr", cls, recv.attr, f.attr)
        return None


class LockOrderAnalysis:
    def __init__(self, project: Project):
        self.scans: Dict[str, _Scanner] = {
            m.path: _Scanner(m) for m in project.modules
        }
        self.by_dotted: Dict[str, _Scanner] = {
            _dotted(p): sc for p, sc in self.scans.items()
        }
        # (path, qualname) -> FuncInfo
        self.functions: Dict[Tuple[str, str], FuncInfo] = {}
        for path, sc in self.scans.items():
            for qn, fi in sc.s.functions.items():
                self.functions[(path, qn)] = fi

    # ------------------------------------------------------- resolution

    def _locate_class(
        self, sc: _Scanner, binding: str
    ) -> Optional[Tuple[_Scanner, str]]:
        """Resolve a class binding as visible in ``sc`` to the scanner
        + class name that DEFINE it (same module, a from-import, or a
        ``mod.Cls`` dotted reference)."""
        s = sc.s
        if binding in s.classes:
            return sc, binding
        if binding in s.object_imports:
            mod, orig = s.object_imports[binding]
            other = self.by_dotted.get(mod)
            if other is not None and orig in other.s.classes:
                return other, orig
        if "." in binding:
            head, tail = binding.split(".", 1)
            mod = s.module_imports.get(head)
            other = self.by_dotted.get(mod) if mod else None
            if other is not None and tail in other.s.classes:
                return other, tail
        return None

    def _method_on_class(self, sc: _Scanner, cls_name: str,
                         method: str,
                         visited: Set[Tuple[str, str]]
                         ) -> Optional[Tuple[str, str]]:
        """MRO-style lookup: the class's own method, else the first
        base (left-to-right, depth-first) that defines it — bases
        resolved across modules through the import maps, cycle-guarded.
        A ``self.m()`` in a subclass thus reaches the inherited body,
        whose lock usage then propagates into the caller's lockset."""
        if (sc.s.path, cls_name) in visited:
            return None
        visited.add((sc.s.path, cls_name))
        if method in sc.s.classes.get(cls_name, ()):
            return (sc.s.path, f"{cls_name}.{method}")
        for base in sc.s.class_bases.get(cls_name, ()):
            located = self._locate_class(sc, base)
            if located is None:
                continue
            out = self._method_on_class(
                located[0], located[1], method, visited
            )
            if out is not None:
                return out
        return None

    def _resolve_class_method(self, sc: _Scanner, binding: str,
                              method: str) -> Optional[Tuple[str, str]]:
        """Resolve ``binding`` (a class name as visible in ``sc``) and
        a method on it — own or inherited — to a function key."""
        located = self._locate_class(sc, binding)
        if located is None:
            return None
        return self._method_on_class(
            located[0], located[1], method, set()
        )

    def resolve(self, caller_key: Tuple[str, str],
                ref: tuple) -> Optional[Tuple[str, str]]:
        path = caller_key[0]
        sc = self.scans[path]
        s = sc.s
        kind = ref[0]
        if kind == "self":
            _, cls, m = ref
            return self._method_on_class(sc, cls, m, set())
        if kind == "name":
            name = ref[1]
            # nested function of the caller?
            nested = f"{caller_key[1]}.{name}"
            if nested in s.functions:
                return (path, nested)
            if name in s.functions:
                return (path, name)
            if name in s.classes:
                return self._resolve_class_method(sc, name, "__init__")
            if name in s.object_imports:
                mod, orig = s.object_imports[name]
                other = self.by_dotted.get(mod)
                if other is not None:
                    if orig in other.s.functions:
                        return (other.s.path, orig)
                    if orig in other.s.classes:
                        return self._resolve_class_method(
                            other, orig, "__init__"
                        )
            return None
        if kind == "dotted":
            base, m = ref[1], ref[2]
            mod = s.module_imports.get(base)
            other = self.by_dotted.get(mod) if mod else None
            if other is not None and m in other.s.functions:
                return (other.s.path, m)
            return self._resolve_class_method(sc, f"{base}.{m}", "__init__")
        if kind == "self_attr":
            _, cls, attr, m = ref
            binding = s.attr_types.get(cls, {}).get(attr)
            if binding is None:
                return None
            return self._resolve_class_method(sc, binding, m)
        return None

    # --------------------------------------------------------- fixpoint

    def run(self) -> dict:
        resolved_calls: Dict[Tuple[str, str], List[tuple]] = {}
        for key, fi in self.functions.items():
            out = []
            for ref, held, line in fi.calls:
                callee = self.resolve(key, ref)
                if callee is not None and callee in self.functions:
                    out.append((callee, held, line))
            resolved_calls[key] = out

        may_acquire: Dict[Tuple[str, str], Set[LockId]] = {
            key: {a[0] for a in fi.acquires}
            for key, fi in self.functions.items()
        }
        may_block: Dict[Tuple[str, str], Set[Tuple[str, str]]] = {
            key: {(b[0], b[1]) for b in fi.blocking}
            for key, fi in self.functions.items()
        }
        changed = True
        while changed:
            changed = False
            for key, calls in resolved_calls.items():
                for callee, _held, _line in calls:
                    if not may_acquire[key] >= may_acquire[callee]:
                        may_acquire[key] |= may_acquire[callee]
                        changed = True
                    if not may_block[key] >= may_block[callee]:
                        may_block[key] |= may_block[callee]
                        changed = True

        # ------------------------------------------------- order edges
        # (held, acquired) -> (path, line, note)
        edges: Dict[Tuple[LockId, LockId], Tuple[str, int, str]] = {}
        for key, fi in self.functions.items():
            for lock, held, line in fi.acquires:
                for h in held:
                    edges.setdefault(
                        (h, lock), (key[0], line, f"in {key[1]}")
                    )
            for callee, held, line in resolved_calls[key]:
                if not held:
                    continue
                for lock in may_acquire[callee]:
                    for h in held:
                        edges.setdefault(
                            (h, lock),
                            (key[0], line,
                             f"in {key[1]} via {callee[1]}"),
                        )

        return {
            "edges": edges,
            "may_acquire": may_acquire,
            "may_block": may_block,
            "resolved_calls": resolved_calls,
            "races": self._shared_state_races(resolved_calls),
        }

    def _shared_state_races(
        self, resolved_calls
    ) -> List[Tuple[str, int, str, str, List[str]]]:
        """Eraser-style write locksets per thread entry point.

        Roots are resolved ``Thread(target=...)`` callables plus their
        spawners (spawner and target run concurrently by definition).
        For each root, a decreasing fixpoint computes the locks ALWAYS
        held when each reachable function runs; a write's lockset is
        that set plus the locks held at the write site.  An attribute
        written from >= 2 distinct roots with an empty intersection
        across all its write locksets is a latent write-write race.
        ``__init__`` writes are construction, not sharing — exempt.
        """
        roots: Set[Tuple[str, str]] = set()
        for key, fi in self.functions.items():
            if fi.thread_targets:
                roots.add(key)
            for ref, _line in fi.thread_targets:
                tgt = self.resolve(key, ref)
                if tgt is not None and tgt in self.functions:
                    roots.add(tgt)

        # (path, class, attr) -> accumulated evidence
        state: Dict[Tuple[str, str, str], dict] = {}
        for root in sorted(roots):
            always: Dict[Tuple[str, str], frozenset] = {
                root: frozenset()
            }
            work = [root]
            while work:
                f = work.pop()
                for callee, held, _line in resolved_calls[f]:
                    cand = always[f] | frozenset(held)
                    cur = always.get(callee)
                    new = cand if cur is None else (cur & cand)
                    if cur is None or new != cur:
                        always[callee] = new
                        work.append(callee)
            for f, base in always.items():
                if f[1].split(".")[-1] == "__init__":
                    continue
                for cls, attr, held, line in self.functions[f].writes:
                    lockset = base | frozenset(held)
                    rec = state.setdefault(
                        (f[0], cls, attr),
                        {"roots": set(), "common": None,
                         "where": (f[0], line)},
                    )
                    rec["roots"].add(root)
                    rec["common"] = (
                        lockset if rec["common"] is None
                        else rec["common"] & lockset
                    )
                    rec["where"] = min(rec["where"], (f[0], line))

        races = []
        for (path, cls, attr), rec in sorted(state.items()):
            if len(rec["roots"]) < 2 or rec["common"]:
                continue
            races.append((
                rec["where"][0], rec["where"][1], cls, attr,
                sorted(r[1] for r in rec["roots"]),
            ))
        return races

    # ---------------------------------------------------------- results

    def findings(self) -> Iterator[Finding]:
        data = self.run()
        edges = data["edges"]
        may_block = data["may_block"]

        # self-loops: re-acquiring a non-reentrant lock id
        graph: Dict[LockId, Set[LockId]] = {}
        for (a, b), (path, line, note) in sorted(edges.items()):
            if a == b:
                sc = self.scans[a[0]]
                if sc.lock_ctor_of(a) in REENTRANT_CTORS:
                    continue
                yield Finding(
                    rule=RULE_ID,
                    severity=SEVERITY_ERROR,
                    path=path,
                    line=line,
                    message=(
                        f"non-reentrant lock {a.render()} may be "
                        f"re-acquired while already held ({note})"
                    ),
                    context=note.split(" ")[1],
                )
                continue
            graph.setdefault(a, set()).add(b)
            graph.setdefault(b, set())

        for scc in _tarjan(graph):
            if len(scc) < 2:
                continue
            locks = sorted(lk.render() for lk in scc)
            examples = sorted(
                f"{a.render()}->{b.render()} "
                f"({edges[(a, b)][0]}:{edges[(a, b)][1]})"
                for (a, b) in edges
                if a in scc and b in scc and a != b
            )[:4]
            path, line, _note = edges[min(
                ((a, b) for (a, b) in edges
                 if a in scc and b in scc and a != b),
                key=lambda e: (edges[e][0], edges[e][1]),
            )]
            yield Finding(
                rule=RULE_ID,
                severity=SEVERITY_ERROR,
                path=path,
                line=line,
                message=(
                    "lock-order cycle between "
                    + ", ".join(locks)
                    + " — edges: " + "; ".join(examples)
                ),
                context="<lock-order>",
            )

        # blocking while holding a lock (direct and via callees)
        for key, fi in sorted(self.functions.items()):
            for kind, desc, held, line in fi.blocking:
                if not held:
                    continue
                yield Finding(
                    rule=RULE_ID,
                    severity=SEVERITY_WARNING,
                    path=key[0],
                    line=line,
                    message=(
                        f"blocking call `{desc}` ({kind}) while "
                        f"holding {held[-1].render()}"
                    ),
                    context=key[1],
                )
            for callee, held, line in data["resolved_calls"][key]:
                if not held or not may_block[callee]:
                    continue
                kind, desc = sorted(may_block[callee])[0]
                yield Finding(
                    rule=RULE_ID,
                    severity=SEVERITY_WARNING,
                    path=key[0],
                    line=line,
                    message=(
                        f"call to `{callee[1]}` may block "
                        f"({kind}: {desc}) while holding "
                        f"{held[-1].render()}"
                    ),
                    context=key[1],
                )

        # shared attrs written from >= 2 thread roots, no common lock
        for path, line, cls, attr, rootnames in data["races"]:
            yield Finding(
                rule=RULE_ID,
                severity=SEVERITY_WARNING,
                path=path,
                line=line,
                message=(
                    f"shared attribute {cls}.{attr} is written from "
                    f"{len(rootnames)} thread entry points "
                    f"({', '.join(rootnames)}) with no common lock in "
                    f"its write lockset"
                ),
                context=f"{cls}.{attr}",
            )

    def cycles(self) -> List[List[LockId]]:
        """SCCs with >= 2 locks — the acceptance-gate surface."""
        edges = self.run()["edges"]
        graph: Dict[LockId, Set[LockId]] = {}
        for (a, b) in edges:
            if a != b:
                graph.setdefault(a, set()).add(b)
                graph.setdefault(b, set())
        return [scc for scc in _tarjan(graph) if len(scc) >= 2]


def _tarjan(graph: Dict[LockId, Set[LockId]]) -> List[List[LockId]]:
    index: Dict[LockId, int] = {}
    low: Dict[LockId, int] = {}
    on_stack: Set[LockId] = set()
    stack: List[LockId] = []
    sccs: List[List[LockId]] = []
    counter = [0]

    def strongconnect(v: LockId) -> None:
        # iterative Tarjan: (node, child-iterator) frames
        work = [(v, iter(sorted(graph.get(v, ()))))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(graph.get(w, ())))))
                    advanced = True
                    break
                elif w in on_stack:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent_node = work[-1][0]
                low[parent_node] = min(low[parent_node], low[node])
            if low[node] == index[node]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.append(w)
                    if w == node:
                        break
                sccs.append(scc)

    for v in sorted(graph):
        if v not in index:
            strongconnect(v)
    return sccs


class Rule:
    id = RULE_ID
    severity = SEVERITY_ERROR
    description = (
        "lock-order cycles and blocking calls under a held lock"
    )

    def check_project(self, project: Project) -> Iterator[Finding]:
        yield from LockOrderAnalysis(project).findings()
