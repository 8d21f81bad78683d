"""CLI: ``python -m khipu_tpu_torch.analysis [paths...]``.

Exit codes: 0 clean (baselined findings allowed), 1 new findings,
2 usage error. Run from the repository root it scans the port
(``khipu_tpu_torch``) against the port's own baseline.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from khipu_tpu_torch.analysis.core import (
    DEFAULT_BASELINE,
    load_baseline,
    run_analysis,
    write_baseline,
)
from khipu_tpu_torch.analysis.report import (
    render_annotations,
    render_json,
    render_text,
)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m khipu_tpu_torch.analysis",
        description=(
            "khipu-lint: AST invariant analysis (ledger coverage, "
            "chaos safety, determinism, lock order — "
            "docs/static_analysis.md)"
        ),
    )
    ap.add_argument(
        "paths", nargs="*", default=["khipu_tpu_torch"],
        help="files or directories to scan (default: khipu_tpu_torch)",
    )
    ap.add_argument(
        "--format", choices=("text", "json"), default="text",
        help="output format (json is SARIF-ish)",
    )
    ap.add_argument(
        "--baseline", default=DEFAULT_BASELINE,
        help="baseline file of accepted findings "
             "(default: the committed "
             "khipu_tpu_torch/analysis/baseline.json)",
    )
    ap.add_argument(
        "--no-baseline", action="store_true",
        help="ignore the baseline: report every finding as new",
    )
    ap.add_argument(
        "--write-baseline", action="store_true",
        help="accept every current finding into --baseline and exit 0",
    )
    ap.add_argument(
        "--rules", default="",
        help="comma-separated rule ids to run (default: all)",
    )
    ap.add_argument(
        "--annotate", metavar="JSON_PATH", default=None,
        help="review-tooling mode: write the SARIF-ish JSON document "
             "to JSON_PATH and print findings as 'file:line: [KL00x] "
             "msg' annotation lines (exit codes unchanged)",
    )
    args = ap.parse_args(argv)

    rules = None
    if args.rules:
        from khipu_tpu_torch.analysis.rules import RULES_BY_ID

        try:
            rules = [
                RULES_BY_ID[r.strip()]
                for r in args.rules.split(",") if r.strip()
            ]
        except KeyError as e:
            print(f"khipu-lint: unknown rule {e}", file=sys.stderr)
            return 2

    baseline = {} if args.no_baseline else load_baseline(args.baseline)
    result = run_analysis(args.paths, rules=rules, baseline=baseline)
    new, known, stale = (
        result["findings"], result["baselined"], result["stale"]
    )

    if args.write_baseline:
        write_baseline(new + known, args.baseline)
        print(
            f"khipu-lint: wrote {len(new) + len(known)} entr"
            f"{'y' if len(new) + len(known) == 1 else 'ies'} to "
            f"{args.baseline}"
        )
        return 0

    if args.annotate:
        with open(args.annotate, "w") as fh:
            fh.write(render_json(new, known, stale))
        ann = render_annotations(new)
        if ann:
            print(ann)
        print(
            f"khipu-lint: {len(new)} new finding(s), JSON artifact at "
            f"{args.annotate}"
        )
    elif args.format == "json":
        print(render_json(new, known, stale))
    else:
        print(render_text(new, known, stale))
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
