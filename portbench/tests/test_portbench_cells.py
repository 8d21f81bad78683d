"""Every cell driven on the CPU at a tiny size: sound runs come out
correct; the control (the reference at 12 rounds in the program's
place) and each fault planted under the timed path come out not
correct; set-up loads nothing of JAX; without a card the measured path
refuses to run."""

import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench import faults, run

MANIFEST = run.load_manifest()
CELLS = [w["name"] for w in MANIFEST["workloads"]]
TINY = {"rows": 2048}
CPU = torch.device("cpu")
SEED = 2**31 + 12345  # wider than 32 signed bits, as the driver's are


def _driver(workload):
    return run.Cell(MANIFEST, workload).traffic["driver"]


def _run(workload, seed=SEED, trace=False, fault=None, **kw):
    # the CPU stands in for the kernels' launch counters
    # (faults.cpu_launch_counters), underneath the fault as the kernels'
    # wrappers are on the card
    with faults.cpu_launch_counters(), (faults.planted(fault, _driver(workload))
                                        if fault else contextlib.nullcontext()):
        return run.run_cell(workload, seed, 0.3, trace, CPU, manifest=MANIFEST,
                            sizes=TINY, t0=time.perf_counter(), **kw)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    result, checks = _run(workload)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {m["name"] for m in run.Cell(MANIFEST, workload).end_to_end}
    assert list(result)[-1] == "checks"
    assert all(c.value == 0 for c in checks)


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run(workload):
    result, _ = _run(workload, seed=7, trace=True)
    assert result["correct"]
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    cell = run.Cell(MANIFEST, workload)
    # the CPU has no device trace: only span readers find something
    assert set(result["metrics"]) <= {m["name"] for m in cell.per_layer}
    if workload.startswith("verify"):
        assert result["metrics"]["admit_us_per_row"]["value"] > 0


def _inputs(workload, seed):
    cell = run.Cell(MANIFEST, workload)
    drv = cell.driver({**cell.config, **TINY}, seed, CPU)
    if cell.traffic["driver"] == "hash_fixed":
        drv.setup()
        return [b.clone() for b in drv.batches]
    return [drv._make_rows(), torch.tensor(drv.altered), torch.tensor(drv.sample)]


@pytest.mark.parametrize("workload", CELLS)
def test_seed_sets_the_inputs(workload):
    a, b, c = (_inputs(workload, s) for s in (SEED, SEED, SEED + 1))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    result, checks = _run(workload, control_rounds=12)
    assert not result["correct"]
    # the full reference in the same place is correct but for the launches
    result, checks = _run(workload, control_rounds=24)
    assert all(c.ok for c in checks if "launches" not in c.name)


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("workload", CELLS)
def test_fault_is_not_correct(workload, fault):
    result, _ = _run(workload, fault=fault)
    assert not result["correct"], (fault, result["checks"])


SETUP_PROBE = """
import json, sys, time, torch
from portbench import run
for w in {cells!r}:
    cell = run.Cell(run.load_manifest(), w)
    drv = cell.driver({{**cell.config, "rows": 2048}}, 5, torch.device("cpu"))
    drv.setup()
    drv.warm()
    drv.call(0)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_setup_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", SETUP_PROBE.format(cells=CELLS)],
                         cwd=run.ROOT, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "khipu_tpu_torch" in loaded
    assert not loaded & set(run.BANNED), loaded & set(run.BANNED)


def test_banned_modules_compare_whole_names():
    import khipu_tpu_torch  # noqa: F401  (the port's name begins with the JAX package's)

    assert "khipu_tpu" not in run.banned_modules()
    sys.modules["jaxlib_probe.x"] = sys.modules["jaxlib.y"] = sys
    try:
        assert run.banned_modules() == ["jaxlib"]
    finally:
        del sys.modules["jaxlib_probe.x"], sys.modules["jaxlib.y"]


def _cli(cwd, workload="hash576.resident"):
    return subprocess.run(
        [sys.executable, "-m", "portbench", "--workload", workload, "--seed",
         str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


@pytest.mark.parametrize("workload", CELLS)
def test_cli_refuses_without_a_card(workload):
    out = _cli(run.ROOT, workload)
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_measured_path_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    with pytest.raises((RuntimeError, AssertionError)):
        run.run_cell("hash576.resident", 1, 0.1, False, torch.device("cuda", 0),
                     manifest=MANIFEST, sizes=TINY)


def test_only_the_benchmark_is_not_enough(tmp_path):
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for p in MANIFEST["paths"]:
        shutil.copytree(run.ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "portbench", "--workload", "hash576.resident",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
