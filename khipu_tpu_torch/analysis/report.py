"""Finding reporters: human text and SARIF-ish JSON.

The JSON shape follows SARIF 2.1.0 closely enough for log viewers that
speak it (``runs[].tool.driver.rules`` + ``runs[].results`` with
``ruleId``/``level``/``message.text``/``physicalLocation``), without
claiming full schema conformance — tests pin the subset we emit.
"""

from __future__ import annotations

import json
from typing import List, Sequence

from khipu_tpu_torch.analysis.core import Finding


def render_text(new: Sequence[Finding], baselined: Sequence[Finding],
                stale: Sequence[dict]) -> str:
    lines: List[str] = []
    for f in new:
        lines.append(f.render())
    if baselined:
        lines.append(
            f"-- {len(baselined)} known finding(s) suppressed by the "
            "baseline"
        )
    for entry in stale:
        lines.append(
            "-- stale baseline entry (fixed? remove it): "
            f"{entry['rule']} {entry['path']} [{entry.get('context')}]"
        )
    if new:
        lines.append(
            f"khipu-lint: {len(new)} new finding(s)"
        )
    else:
        lines.append("khipu-lint: clean")
    return "\n".join(lines)


def render_annotations(new: Sequence[Finding]) -> str:
    """One line per new finding in the ``file:line: [RULE] message``
    shape review tooling greps (the same grammar compiler errors use,
    so editors and CI annotators parse it for free)."""
    return "\n".join(
        f"{f.path}:{f.line}: [{f.rule}] {f.message}" for f in new
    )


def render_json(new: Sequence[Finding], baselined: Sequence[Finding],
                stale: Sequence[dict]) -> str:
    from khipu_tpu_torch.analysis.rules import ALL_RULES

    def result(f: Finding, suppressed: bool) -> dict:
        out = {
            "ruleId": f.rule,
            "level": "error" if f.severity == "error" else "warning",
            "message": {"text": f.message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {"uri": f.path},
                    "region": {"startLine": f.line},
                },
                "logicalLocations": [{"fullyQualifiedName": f.context}],
            }],
        }
        if suppressed:
            out["suppressions"] = [{"kind": "external"}]
        return out

    doc = {
        "version": "2.1.0",
        "$schema": (
            "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
            "master/Schemata/sarif-schema-2.1.0.json"
        ),
        "runs": [{
            "tool": {"driver": {
                "name": "khipu-lint",
                "informationUri": "docs/static_analysis.md",
                "rules": [
                    {
                        "id": r.id,
                        "shortDescription": {"text": r.description},
                        "defaultConfiguration": {"level": r.severity},
                    }
                    for r in ALL_RULES
                ],
            }},
            "results": (
                [result(f, False) for f in new]
                + [result(f, True) for f in baselined]
            ),
            "properties": {
                "newFindings": len(new),
                "baselinedFindings": len(baselined),
                "staleBaselineEntries": len(stale),
            },
        }],
    }
    return json.dumps(doc, indent=2)
