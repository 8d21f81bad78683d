"""khipu-lint aimed at the port (khipu_tpu_torch/analysis/).

KL002-KL006 are the JAX package's rules with their logic unchanged: its
fixtures (tests/test_analysis.py) run through both analysers give the
same findings. KL001 knows the port's crossings (``.cuda()``, ``.cpu()``,
``.to(device)``, ``torch.tensor(..., device=)``, a non-blocking
``copy_``) and its ``KNOWN_SITES``. The pragma and baseline channels,
the CLI, and the gate: the committed port tree is clean against the
port's own baseline, every entry of which carries a reason.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from khipu_tpu_torch.analysis import run_analysis
from khipu_tpu_torch.analysis.core import (
    DEFAULT_BASELINE,
    Finding,
    load_baseline,
    load_project,
)
from khipu_tpu_torch.analysis.lockorder import LockOrderAnalysis
from khipu_tpu_torch.analysis.report import render_annotations, render_json
from khipu_tpu_torch.analysis.rules import ALL_RULES, RULES_BY_ID

REPO_ROOT = Path(__file__).resolve().parent.parent


def _write(tmp_path, files):
    for rel, src in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src)


def _scan(tmp_path, files, rules=None):
    """Write {relpath: source} under tmp_path and lint it with the port's
    analyser and an empty baseline; returns the new findings."""
    _write(tmp_path, files)
    return run_analysis([str(tmp_path)], rules=rules, baseline={})["findings"]


def _rules_of(findings):
    return sorted({f.rule for f in findings})


# ----------------------------------------- KL002-KL006: parity fixtures

LOCKSET_SRC = (
    "import threading\n"
    "class Pump:\n"
    "    def __init__(self):\n"
    "        self.lock = threading.Lock()\n"
    "        self.count = 0\n"
    "        self.depth = 0\n"
    "    def _loop(self):\n"
    "        self.count = self.count + 1\n"
    "        with self.lock:\n"
    "            self.depth = 1\n"
    "    def kick(self):\n"
    "        t = threading.Thread(target=self._loop)\n"
    "        t.start()\n"
    "        self.count = 5\n"
    "        with self.lock:\n"
    "            self.depth = 2\n"
)

# (name, {relpath: source}, rule ids or None for every rule): the JAX
# package's fixtures of tests/test_analysis.py, KL002-KL006
PARITY = [
    ("kl002_broad_except", {"mod.py": (
        "def swallow():\n    try:\n        work()\n    except:\n"
        "        pass\n"
        "def swallow2():\n    try:\n        work()\n"
        "    except BaseException:\n        log()\n")}, None),
    ("kl002_reraise_and_narrow", {"mod.py": (
        "def ok():\n    try:\n        work()\n    except BaseException:\n"
        "        cleanup()\n        raise\n"
        "def narrow():\n    try:\n        work()\n    except ValueError:\n"
        "        pass\n")}, None),
    ("kl003_protected", {"sync/mod.py": (
        "import time, random\n"
        "def jitter():\n    return time.time() + random.random()\n")},
     None),
    ("kl003_unprotected", {"tools/mod.py": (
        "import time, random\n"
        "def jitter():\n    return time.time() + random.random()\n")},
     None),
    ("kl003_seeded_rng", {"sync/mod.py": (
        "import random\nRNG = random.Random(7)\n"
        "def jitter():\n    return RNG.random()\n")}, None),
    ("kl004_cycle", {"locks.py": (
        "import threading\nA = threading.Lock()\nB = threading.Lock()\n"
        "def ab():\n    with A:\n        with B:\n            pass\n"
        "def ba():\n    with B:\n        with A:\n            pass\n")},
     ["KL004"]),
    ("kl004_blocking_under_lock", {"locks.py": (
        "import threading, time\nA = threading.Lock()\n"
        "def hold_and_sleep():\n    with A:\n        time.sleep(1)\n")},
     ["KL004"]),
    ("kl004_inherited_method", {"locks.py": (
        "import threading\nA = threading.Lock()\nB = threading.Lock()\n"
        "class Base:\n    def inner(self):\n        with B:\n"
        "            pass\n"
        "class Sub(Base):\n    def outer(self):\n        with A:\n"
        "            self.inner()\n"
        "def ba():\n    with B:\n        with A:\n            pass\n")},
     ["KL004"]),
    ("kl004_callable_argument", {"locks.py": (
        "import threading\nA = threading.Lock()\nB = threading.Lock()\n"
        "def takes_b():\n    with B:\n        pass\n"
        "def run(fn):\n    fn()\n"
        "def ab():\n    with A:\n        run(takes_b)\n"
        "def ba():\n    with B:\n        with A:\n            pass\n")},
     ["KL004"]),
    ("kl004_consistent_order", {"locks.py": (
        "import threading\nA = threading.Lock()\nB = threading.Lock()\n"
        "def ab():\n    with A:\n        with B:\n            pass\n"
        "def ab2():\n    with A:\n        with B:\n            pass\n")},
     ["KL004"]),
    ("kl004_lockset", {"mod.py": LOCKSET_SRC}, ["KL004"]),
    ("kl004_single_root", {"mod.py": (
        "import threading\nclass Solo:\n    def __init__(self):\n"
        "        self.n = 0\n"
        "        threading.Thread(target=self._loop).start()\n"
        "    def _loop(self):\n        self.n = 1\n")}, ["KL004"]),
    ("kl005_span", {"mod.py": (
        "def f():\n    sp = span('work')\n"
        "def ok():\n    with span('work'):\n        pass\n")}, None),
    ("kl005_registry_family", {"mod.py": (
        "def lazy(registry):\n    return registry.counter('n')\n"
        "def labeled_child(registry):\n"
        "    return registry.counter('n', labels={'k': 'v'})\n")}, None),
    ("kl006_mutable_default", {"mod.py": (
        "def f(x=[]):\n    return x\ndef g(*, y={}):\n    return y\n"
        "def ok(z=(), w=None):\n    return z, w\n")}, None),
    ("kl000_parse_error", {"broken.py": "def f(:\n"}, None),
    ("pragma_on_line", {"mod.py": (
        "def f(x=[]):  # khipu-lint: ok KL006 fixture\n    return x\n")},
     None),
    ("pragma_block_above", {"mod.py": (
        "# khipu-lint: ok KL006 the reason spans a comment\n"
        "# block; the pragma may sit anywhere inside it\n"
        "def f(x=[]):\n    return x\n")}, None),
    ("pragma_other_rule", {"mod.py": (
        "def f(x=[]):  # khipu-lint: ok KL001 wrong rule\n"
        "    return x\n")}, None),
    ("pragma_in_string", {"mod.py": (
        "P = '# khipu-lint: ok KL006 not a comment'\n"
        "def f(x=[]):\n    return x\n")}, None),
]


def _findings(pkg, root, rule_ids):
    import importlib

    analysis = importlib.import_module(f"{pkg}.analysis")
    rules_mod = importlib.import_module(f"{pkg}.analysis.rules")
    rules = None if rule_ids is None else [rules_mod.RULES_BY_ID[r]
                                           for r in rule_ids]
    got = analysis.run_analysis([str(root)], rules=rules, baseline={})
    return [(f.rule, f.severity, f.path, f.line, f.message, f.context)
            for f in got["findings"]]


@pytest.mark.parametrize("name,files,rule_ids", PARITY,
                         ids=[p[0] for p in PARITY])
def test_rules_match_the_reference_analyser(tmp_path, name, files,
                                            rule_ids):
    _write(tmp_path, files)
    port = _findings("khipu_tpu_torch", tmp_path, rule_ids)
    ref = _findings("khipu_tpu", tmp_path, rule_ids)
    assert port == ref
    if name in ("kl002_broad_except", "kl006_mutable_default"):
        assert len(port) == 2
    if name == "kl004_cycle":
        assert any("cycle" in f[4] for f in port)


def test_lock_order_cycle_counts_as_the_reference(tmp_path):
    from khipu_tpu.analysis.core import load_project as ref_load
    from khipu_tpu.analysis.lockorder import LockOrderAnalysis as RefLOA

    _write(tmp_path, next(p[1] for p in PARITY if p[0] == "kl004_cycle"))
    port = LockOrderAnalysis(load_project([str(tmp_path)])).cycles()
    ref = RefLOA(ref_load([str(tmp_path)])).cycles()
    assert len(port) == len(ref) == 1 and len(port[0]) == 2


# ------------------------------------------- KL001: the port's crossings


@pytest.mark.parametrize("expr,name", [
    ("x.cuda()", ".cuda()"),
    ("x.cuda(non_blocking=True)", ".cuda()"),
    ("x.cpu()", ".cpu()"),
    ("x.to(dev)", ".to(device)"),
    ("x.to('cuda:0')", ".to(device)"),
    ("x.to(torch.device('cuda'))", ".to(device)"),
    ("x.to(device=dev)", ".to(device)"),
    ("x.to(dev, non_blocking=True)", ".to(device)"),
    ("torch.tensor([1, 2], device=dev)", "torch.tensor(device=)"),
    ("torch.as_tensor(a, device=dev)", "torch.as_tensor(device=)"),
    ("host.copy_(x, non_blocking=True)", ".copy_(non_blocking)"),
])
def test_kl001_unmetered_crossing_fires(tmp_path, expr, name):
    findings = _scan(tmp_path, {"mod.py": (
        "import torch\n"
        "def pull(x, dev, a, host):\n"
        f"    return {expr}\n"
    )})
    assert _rules_of(findings) == ["KL001"]
    assert f"`{name}`" in findings[0].message
    assert findings[0].context == "pull" and findings[0].line == 3


@pytest.mark.parametrize("expr", [
    "x.to(torch.int64)",
    "x.to(torch.uint8)",
    "x.to(dtype=torch.int32)",
    "x.to(y.dtype)",
    "x.to(dtype)",
    "torch.zeros(4, device=dev)",
    "torch.tensor([1, 2])",
    "host.copy_(x)",
    "torch.cuda.synchronize()",
    "x.is_cuda",
])
def test_kl001_casts_allocations_and_host_forms_are_clean(tmp_path, expr):
    findings = _scan(tmp_path, {"mod.py": (
        "import torch\n"
        "def f(x, y, dev, host, dtype):\n"
        f"    return {expr}\n"
    )})
    assert findings == []


def test_kl001_metered_forms_are_clean(tmp_path):
    findings = _scan(tmp_path, {"mod.py": (
        "def timed(x, dev):\n"
        "    with LEDGER.transfer('ops.keccak', 'h2d', 4):\n"
        "        return x.to(dev)\n"
        "def oneshot(x):\n"
        "    out = x.cpu()\n"
        "    LEDGER.record('ops.keccak', 'd2h', 4)\n"
        "    return out\n"
        "def pragma(x):\n"
        "    # khipu-lint: ok KL001 card to card, no host bytes\n"
        "    return x.cuda()\n"
    )})
    assert findings == []


def test_kl001_misspelled_site_fires(tmp_path):
    findings = _scan(tmp_path, {"mod.py": (
        "def timed(x):\n"
        "    with LEDGER.transfer('shard.gahter', 'd2h', 4):\n"
        "        return x.cpu()\n"
        "def oneshot(x):\n"
        "    out = x.cpu()\n"
        "    LEDGER.record('mirror.admitt', 'h2d', 4)\n"
        "    return out\n"
        "def known(x):\n"
        "    with LEDGER.transfer('shard.gather', 'd2h', 4):\n"
        "        return x.cpu()\n"
    )})
    assert _rules_of(findings) == ["KL001"]
    msgs = sorted(f.message for f in findings)
    assert len(msgs) == 2
    assert any("shard.gahter" in m for m in msgs)
    assert any("mirror.admitt" in m for m in msgs)
    assert all("KNOWN_SITES" in m for m in msgs)


def test_kl001_jax_forms_are_not_the_ports(tmp_path):
    """The JAX package's crossings mean nothing in the port: the port's
    KL001 looks for torch's forms only."""
    findings = _scan(tmp_path, {"mod.py": (
        "import jax\n"
        "def pull(x):\n"
        "    return jax.device_get(x)\n"
    )})
    assert findings == []


def test_known_sites_hold_the_shard_sites():
    from khipu_tpu_torch.observability.profiler import (
        COLLECT_CLASSES,
        KNOWN_SITES,
    )

    assert {"shard.keccak", "shard.gather", "shard.verify",
            "shard.dispatch"} <= KNOWN_SITES
    assert COLLECT_CLASSES["shard.gather"] == "placeholder-resolution"


# ------------------------------------------------- suppression channels


class TestSuppression:
    BAD = "def f(x=[]):\n    return x\n"

    def test_baseline_suppresses_and_line_drift_survives(self, tmp_path):
        first = _scan(tmp_path, {"mod.py": self.BAD})
        assert len(first) == 1
        baseline = {f.fingerprint: {"rule": f.rule} for f in first}
        (tmp_path / "mod.py").write_text("import os\nimport sys\n"
                                         + self.BAD)
        result = run_analysis([str(tmp_path)], baseline=baseline)
        assert result["findings"] == []
        assert [f.rule for f in result["baselined"]] == ["KL006"]
        assert result["stale"] == []

    def test_stale_baseline_entries_surface(self, tmp_path):
        (tmp_path / "mod.py").write_text("def ok():\n    pass\n")
        baseline = {"KL006|gone.py|f|msg": {"rule": "KL006",
                                            "path": "gone.py"}}
        result = run_analysis([str(tmp_path)], baseline=baseline)
        assert result["findings"] == []
        assert len(result["stale"]) == 1

    def test_finding_fingerprint_is_line_free(self):
        a = Finding("KL006", "error", "p.py", 10, "m", "f")
        b = Finding("KL006", "error", "p.py", 99, "m", "f")
        assert a.fingerprint == b.fingerprint


# ------------------------------------------------------- report + CLI


def _lint(*argv, cwd=REPO_ROOT):
    return subprocess.run(
        [sys.executable, "-m", "khipu_tpu_torch.analysis", *argv],
        cwd=cwd, capture_output=True, text=True, timeout=120,
    )


class TestReportAndCli:
    def test_json_report_is_sarif_ish(self, tmp_path):
        findings = _scan(tmp_path, {"mod.py": "def f(x=[]):\n    return x\n"})
        doc = json.loads(render_json(findings, [], []))
        run = doc["runs"][0]
        assert {r.id for r in ALL_RULES} <= {
            r["id"] for r in run["tool"]["driver"]["rules"]}
        assert run["results"][0]["ruleId"] == "KL006"
        ann = render_annotations(findings).splitlines()[0]
        assert f":{findings[0].line}: [KL006] " in ann

    def test_cli_exit_codes_and_filters(self, tmp_path):
        bad = tmp_path / "bad.py"
        bad.write_text("def f(x=[]):\n    return x.cuda()\n")
        good = tmp_path / "good.py"
        good.write_text("def f(x=None):\n    return x\n")
        r = _lint(str(good), "--no-baseline")
        assert r.returncode == 0 and "clean" in r.stdout
        r = _lint(str(bad), "--no-baseline")
        assert r.returncode == 1
        assert "KL006" in r.stdout and "KL001" in r.stdout
        r = _lint(str(bad), "--no-baseline", "--format=json")
        assert r.returncode == 1
        assert len(json.loads(r.stdout)["runs"][0]["results"]) == 2
        r = _lint(str(bad), "--no-baseline", "--rules", "KL002")
        assert r.returncode == 0
        assert _lint(str(bad), "--rules", "KL999").returncode == 2
        artifact = tmp_path / "findings.json"
        r = _lint(str(bad), "--no-baseline", "--annotate", str(artifact))
        assert r.returncode == 1 and f"{bad}:1: [KL006]" in r.stdout
        assert json.loads(artifact.read_text())["runs"][0]["results"]
        base = tmp_path / "base.json"
        assert _lint(str(bad), "--baseline", str(base),
                     "--write-baseline").returncode == 0
        assert _lint(str(bad), "--baseline", str(base)).returncode == 0

    def test_the_analyser_imports_neither_torch_nor_jax(self, tmp_path):
        (tmp_path / "mod.py").write_text("def f(x):\n    return x.cpu()\n")
        probe = (
            "import sys\n"
            "from khipu_tpu_torch.analysis import run_analysis\n"
            f"r = run_analysis([{str(tmp_path)!r}], baseline={{}})\n"
            "assert [f.rule for f in r['findings']] == ['KL001']\n"
            "print(sorted(m for m in ('torch', 'jax', 'numpy', 'khipu_tpu')"
            " if m in sys.modules))\n"
        )
        out = subprocess.run([sys.executable, "-c", probe], cwd=REPO_ROOT,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == "[]"


# --------------------------------------------------- the gate, the port


class TestPortTree:
    def test_committed_port_tree_is_clean_modulo_baseline(self):
        """``python -m khipu_tpu_torch.analysis`` exits 0 on the port."""
        r = _lint()
        assert r.returncode == 0, r.stdout + r.stderr
        assert "khipu-lint: clean" in r.stdout

    def test_every_baseline_entry_carries_its_reason(self):
        entries = json.loads(Path(DEFAULT_BASELINE).read_text())["entries"]
        assert DEFAULT_BASELINE.endswith(
            "khipu_tpu_torch/analysis/baseline.json")
        assert 0 < len(load_baseline()) == len(entries) <= 5
        for e in entries:
            assert e["path"].startswith("khipu_tpu_torch/")
            assert e["reason"] and "fix or annotate" not in e["reason"]

    def test_no_stale_baseline_entry(self):
        import os

        cwd = os.getcwd()
        os.chdir(REPO_ROOT)
        try:
            result = run_analysis(["khipu_tpu_torch"],
                                  baseline=load_baseline())
        finally:
            os.chdir(cwd)
        assert result["findings"] == [] and result["stale"] == []
        assert len(result["baselined"]) > 0

    def test_port_has_no_lock_order_cycles(self):
        project = load_project([str(REPO_ROOT / "khipu_tpu_torch")])
        assert LockOrderAnalysis(project).cycles() == []
        assert RULES_BY_ID["KL004"] in ALL_RULES
