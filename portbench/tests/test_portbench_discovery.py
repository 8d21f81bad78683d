"""A configuration, a traffic mix, a metric and a driver added as files
under new names are found by name, with no edit to a file that is there."""

import contextlib
import copy
import json
import shutil
import time

import pytest
import torch

from portbench import faults, roofline, run

CPU = torch.device("cpu")


def test_added_files_are_found(tmp_path):
    bench = tmp_path / "portbench"
    shutil.copytree(run.BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__"))
    config = json.loads((bench / "configs" / "keccak_1Mx576.json").read_text())
    config.update(rows=3072, row_bytes=136)
    (bench / "configs" / "keccak_3kx136.json").write_text(json.dumps(config))
    traffic = json.loads((bench / "traffic" / "hash_resident.json").read_text())
    traffic.update(distinct_batches=3, in_flight=3)
    (bench / "traffic" / "hash_three.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "calls_seen.py").write_text(
        "def read(r):\n    return float(r.calls)\n")

    manifest = run.load_manifest()
    manifest["configs"].append({"name": "keccak_3kx136", "source": "test",
                                "file": "portbench/configs/keccak_3kx136.json",
                                "reduced": [], "why": "test"})
    manifest["workloads"].append({"name": "hash136.three", "config": "keccak_3kx136",
                                  "traffic": "hash_three", "chips": 1, "why": "test"})
    manifest["end_to_end"].append({"name": "calls_seen", "unit": "calls",
                                   "better": "higher", "bound": 0.05,
                                   "source": "host_clock",
                                   "workloads": ["hash136.three"]})
    with faults.cpu_launch_counters("hash_fixed", bench):
        result, _ = run.run_cell("hash136.three", 3, 0.2, False, torch.device("cpu"),
                                 manifest=manifest, bench_dir=bench,
                                 t0=time.perf_counter())
    assert result["correct"], result["checks"]
    assert result["metrics"]["calls_seen"]["value"] == result["attempted"]
    assert {"nodes_per_s", "batch_p95_ms", "setup_s"} <= set(result["metrics"])
    # the new metric is reported only where it is listed
    other, _ = run.run_cell("hash576.resident", 3, 0.1, False, torch.device("cpu"),
                            manifest=manifest, bench_dir=bench,
                            sizes={"rows": 1024}, t0=time.perf_counter())
    assert "calls_seen" not in other["metrics"]


# A driver of its own, added as a file: the verify driver's text under a
# new name, stating the work a call does. It brings its fault seams, its
# launch seams and its inputs with it.
NEW_DRIVER_TAIL = """

_Verify = Driver


class Driver(_Verify):
    def setup(self):
        super().setup()
        self.work = {"rate_blocks": self.rows * (self.length // 136 + 1),
                     "bytes_moved": self.rows * (self.length + 32) + 4}
"""
NEW_CELL = "verifycopy.small"
ROWS, ROW_BYTES = 3072, 200


def _files(root):
    return {p.relative_to(root): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture(scope="module")
def added(tmp_path_factory):
    """The bench directory copied, a driver, a configuration, a traffic
    mix and a reader added to the copy as files, and a cell added to a
    copy of the manifest."""
    bench = tmp_path_factory.mktemp("added") / "portbench"
    shutil.copytree(run.BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__"))
    assert _files(bench) == _files(run.BENCH_DIR)
    (bench / "drivers" / "mirror_verify_copy.py").write_text(
        (bench / "drivers" / "mirror_verify.py").read_text() + NEW_DRIVER_TAIL)
    config = json.loads((bench / "configs" / "snapshot_10Mx576.json").read_text())
    config.update(rows=ROWS, row_bytes=ROW_BYTES)
    (bench / "configs" / "snapshot_3kx200.json").write_text(json.dumps(config))
    traffic = json.loads((bench / "traffic" / "verify_scrub.json").read_text())
    traffic["driver"] = "mirror_verify_copy"
    (bench / "traffic" / "verify_copy.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "rate_blocks_seen.py").write_text(
        "def read(r):\n    return r.work.get(\"rate_blocks\")\n")

    manifest = copy.deepcopy(run.load_manifest())
    manifest["configs"].append({"name": "snapshot_3kx200", "source": "test",
                                "file": "portbench/configs/snapshot_3kx200.json",
                                "reduced": [], "why": "test"})
    manifest["workloads"].append({"name": NEW_CELL, "config": "snapshot_3kx200",
                                  "traffic": "verify_copy", "chips": 1, "why": "test"})
    manifest["per_layer"].append({"name": "rate_blocks_seen", "unit": "blocks",
                                  "better": "higher", "source": "program_counter",
                                  "layer": "harness", "moves": "nodes_per_s",
                                  "workloads": [NEW_CELL]})
    for m in manifest["per_layer"]:
        if m["name"] == "admit_us_per_row":
            m["workloads"].append(NEW_CELL)
    yield bench, manifest
    # the cell came in through added files alone
    originals = _files(run.BENCH_DIR)
    now = _files(bench)
    assert {k: now[k] for k in originals} == originals


def _run_added(added, trace=False, fault=None, seed=2**31 + 777, **kw):
    bench, manifest = added
    driver = "mirror_verify_copy"
    with faults.cpu_launch_counters(driver, bench), (
            faults.planted(fault, driver, bench) if fault
            else contextlib.nullcontext()):
        return run.run_cell(NEW_CELL, seed, 0.2, trace, CPU, manifest=manifest,
                            bench_dir=bench, t0=time.perf_counter(), **kw)


def test_added_driver_sound_run_is_correct(added):
    result, checks = _run_added(added)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert {"nodes_per_s", "batch_p95_ms", "setup_s"} == set(result["metrics"])
    assert all(c.value == 0 for c in checks)


def test_added_driver_control_is_not_correct(added):
    result, _ = _run_added(added, control_rounds=12)
    assert not result["correct"]


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_added_driver_fault_is_not_correct(added, fault):
    result, _ = _run_added(added, fault=fault)
    assert not result["correct"], (fault, result["checks"])


def test_added_driver_inputs_follow_the_seed(added):
    bench, manifest = added
    cell = run.Cell(manifest, NEW_CELL, bench)
    a, b, c = (cell.driver(cell.config, s, CPU).inputs() for s in (5, 5, 6))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert tuple(a[0].shape) == (ROWS, ROW_BYTES)


def test_added_driver_traced_run_reads_spans_and_work(added):
    bench, manifest = added
    result, _ = _run_added(added, trace=True, seed=11)
    assert result["correct"], result["checks"]
    cell = run.Cell(manifest, NEW_CELL, bench)
    spans = [m["name"] for m in cell.per_layer if m["source"] == "program_span"]
    assert spans
    for name in spans:
        assert result["metrics"][name]["value"] > 0, name
    stated = ROWS * roofline.rate_blocks(ROW_BYTES)
    assert result["metrics"]["rate_blocks_seen"]["value"] == stated
