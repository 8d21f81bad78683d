"""khipu-lint for the port: AST invariant analysis of khipu_tpu_torch.

The JAX package's analyser (``khipu_tpu/analysis/``), aimed at the
port. The port's correctness story rests on the same invariants, which
no runtime test can see being *absent*: every host<->card crossing must
be metered by the TransferLedger or the movement report lies, chaos
``InjectedDeath`` (a BaseException with SIGKILL semantics) must never be
swallowed by a broad except, deterministic replay must not touch
wall-clock or unseeded RNG, and the ``threading.Lock`` sites across the
stage, cluster, serving and pool planes have no runtime check of
acquisition order. This package derives those disciplines statically
and fails when code drifts (``python -m khipu_tpu_torch.analysis``
exits 1 on a finding the baseline does not hold).

Pure stdlib (``ast`` + ``tokenize``); importing it never pulls torch,
jax or any runtime module. Its one lazy import reads the port's
``observability/profiler.KNOWN_SITES``.

Rules (docs/static_analysis.md has the catalog with rationale):

* KL001 — unledgered host<->card crossings (the port's torch forms)
* KL002 — chaos-unsafe broad excepts
* KL003 — nondeterminism in deterministic paths
* KL004 — lock-order cycles + blocking calls under a lock
* KL005 — observability discipline (spans / registry families)
* KL006 — mutable default arguments

Per-site suppression: ``# khipu-lint: ok KL00x <reason>`` on the
flagged line or the line above. Residual accepted findings live in the
committed ``baseline.json`` next to this file, each with its reason.
"""

from khipu_tpu_torch.analysis.core import (
    Finding,
    Project,
    load_baseline,
    run_analysis,
)

__all__ = ["Finding", "Project", "load_baseline", "run_analysis"]
