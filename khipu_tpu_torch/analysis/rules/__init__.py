"""Rule registry. Adding a rule = one module with a ``Rule`` class
exposing ``id``, ``severity``, ``description`` and ``check_module(mod)``
(per-file) and/or ``check_project(project)`` (whole-tree), then listing
it here — docs/static_analysis.md walks through it."""

from khipu_tpu_torch.analysis import lockorder
from khipu_tpu_torch.analysis.rules import (
    kl001_ledger,
    kl002_chaos,
    kl003_determinism,
    kl005_observability,
    kl006_defaults,
)

ALL_RULES = (
    kl001_ledger.Rule(),
    kl002_chaos.Rule(),
    kl003_determinism.Rule(),
    lockorder.Rule(),
    kl005_observability.Rule(),
    kl006_defaults.Rule(),
)

RULES_BY_ID = {r.id: r for r in ALL_RULES}

__all__ = ["ALL_RULES", "RULES_BY_ID"]
