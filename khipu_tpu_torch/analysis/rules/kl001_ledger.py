"""KL001 — unledgered host<->card crossings.

The port's TransferLedger (``observability/profiler.py``) is the
movement instrument: the per-window movement report and the
``khipu_device_transfer_*`` families are only honest if EVERY crossing
of the host/card boundary is metered. A crossing added outside the
ledger silently disappears from them, exactly where a regression in
bytes moved should show.

The crossings the rule recognises, by their torch forms:

* ``x.cuda(...)`` and ``x.cpu()``;
* ``x.to(<device>)``: a positional device (a name, an attribute, a
  string, ``torch.device(...)``) or a ``device=`` keyword, but not a
  dtype cast (``torch.<dtype>``, a name or attribute called ``dtype``,
  only a ``dtype=`` keyword);
* ``torch.tensor(..., device=...)`` / ``torch.as_tensor(..., device=...)``
  (host data built on the card);
* ``dst.copy_(src, non_blocking=...)``: the pinned-buffer copy between
  host and card (a blocking ``copy_`` cannot be told from a copy on one
  device, and is out of reach).

What it cannot see statically: ``.item()``, ``.tolist()`` and ``.numpy()``
(each a copy back when its tensor is on the card), implicit
synchronisation, and whether a ``.to(device)`` crosses at all (card to
card, or CPU to CPU, is no crossing; the rule counts it as one, and such
a site carries a pragma saying so).

A crossing counts as metered when it is lexically inside a
``with *.transfer(...)`` timing context, or when the enclosing function
also calls ``*LEDGER*.record(...)`` (the one-shot form used where the
upload is asynchronous and the timing context would time only the
enqueue — storage/device_mirror.py mirror.init).

The rule also validates the SITE STRING of every ledger call against
the port's ``profiler.KNOWN_SITES``: a misspelled site is metered in the
totals but silently forks a new series in ``khipu_device_transfer_*``
and drops out of its COLLECT_CLASSES stream — the window report then
under-attributes exactly the bytes the site was added to explain.
"""

from __future__ import annotations

import ast
from typing import Iterator, Set

from khipu_tpu_torch.analysis.core import (
    SEVERITY_ERROR,
    Finding,
    Module,
    enclosing_function,
    in_with_transfer,
    parent,
)

RULE_ID = "KL001"

_EXEMPT_SUFFIXES = (
    "observability/profiler.py",  # the instrument itself
)

_TORCH_DTYPES = {
    "uint8", "int8", "int16", "int32", "int64", "uint16", "uint32",
    "uint64", "float16", "bfloat16", "float32", "float64", "bool",
    "long", "int", "short", "half", "float", "double", "complex64",
    "complex128", "cfloat", "cdouble",
}


def _is_dtype(node: ast.AST) -> bool:
    """A dtype-looking ``.to`` argument: ``torch.int64``, ``x.dtype``,
    a name spelled ``dtype`` / ``*_dtype``."""
    if isinstance(node, ast.Attribute):
        return node.attr in _TORCH_DTYPES or node.attr == "dtype" or \
            node.attr.endswith("_dtype")
    if isinstance(node, ast.Name):
        return node.id == "dtype" or node.id.endswith("_dtype")
    return False


def _crossing_name(call: ast.Call) -> str:
    f = call.func
    if not isinstance(f, ast.Attribute):
        return ""
    kw = {k.arg for k in call.keywords}
    if f.attr in ("cuda", "cpu") and not (
        isinstance(f.value, ast.Name) and f.value.id == "torch"
    ):
        return f".{f.attr}()"
    if f.attr == "to":
        if "device" in kw:
            return ".to(device)"
        if call.args and not _is_dtype(call.args[0]):
            return ".to(device)"
        return ""
    if (
        f.attr in ("tensor", "as_tensor")
        and isinstance(f.value, ast.Name)
        and f.value.id == "torch"
        and "device" in kw
    ):
        return f"torch.{f.attr}(device=)"
    if f.attr == "copy_" and "non_blocking" in kw:
        return ".copy_(non_blocking)"
    return ""


def _known_sites() -> Set[str]:
    """The runtime site registry — imported lazily so the analyzer can
    still scan trees where observability fails to import."""
    try:
        from khipu_tpu_torch.observability.profiler import KNOWN_SITES

        return set(KNOWN_SITES)
    except Exception:  # pragma: no cover - defensive
        return set()


def _ledger_site_arg(call: ast.Call) -> str | None:
    """The literal site string of a ``*LEDGER*.transfer(...)`` /
    ``*LEDGER*.record(...)`` call, or None when the call is not a
    ledger call or the site is not a string literal (dynamic sites are
    out of the rule's reach)."""
    f = call.func
    if not isinstance(f, ast.Attribute) or f.attr not in (
        "transfer", "record"
    ):
        return None
    if "ledger" not in ast.unparse(f.value).lower():
        return None
    if not call.args:
        return None
    a0 = call.args[0]
    if isinstance(a0, ast.Constant) and isinstance(a0.value, str):
        return a0.value
    return None


def _function_records_to_ledger(node: ast.AST) -> bool:
    fn = parent(node)
    while fn is not None and not isinstance(
        fn, (ast.FunctionDef, ast.AsyncFunctionDef)
    ):
        fn = parent(fn)
    if fn is None:
        return False
    for sub in ast.walk(fn):
        if (
            isinstance(sub, ast.Call)
            and isinstance(sub.func, ast.Attribute)
            and sub.func.attr == "record"
            and "ledger" in ast.unparse(sub.func.value).lower()
        ):
            return True
    return False


class Rule:
    id = RULE_ID
    severity = SEVERITY_ERROR
    description = (
        "host<->card crossing not metered by the TransferLedger"
    )

    def check_module(self, mod: Module) -> Iterator[Finding]:
        if mod.path.endswith(_EXEMPT_SUFFIXES):
            return
        known = _known_sites()
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            site = _ledger_site_arg(node)
            if site is not None and known and site not in known:
                yield Finding(
                    rule=self.id,
                    severity=self.severity,
                    path=mod.path,
                    line=node.lineno,
                    message=(
                        f"unknown TransferLedger site {site!r} — not "
                        "in profiler.KNOWN_SITES (a misspelled site "
                        "forks its own metrics series and drops out "
                        "of the window report's class breakdown)"
                    ),
                    context=enclosing_function(node),
                )
                continue
            name = _crossing_name(node)
            if not name:
                continue
            if in_with_transfer(node):
                continue
            if _function_records_to_ledger(node):
                continue
            yield Finding(
                rule=self.id,
                severity=self.severity,
                path=mod.path,
                line=node.lineno,
                message=(
                    f"unledgered device crossing `{name}` — wrap in "
                    "`with LEDGER.transfer(site, direction, nbytes):` "
                    "or account it via `LEDGER.record(...)` in the "
                    "same function"
                ),
                context=enclosing_function(node),
            )
