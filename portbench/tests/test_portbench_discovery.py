"""A configuration, a traffic mix and a metric added as files under new
names are found by name, with no edit to a file that is there."""

import json
import shutil
import time

import torch

from portbench import faults, run


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
    with faults.cpu_launch_counters():
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
