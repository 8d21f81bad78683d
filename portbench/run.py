"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

The harness is driven by data. A cell names a configuration and a
traffic mix; each is a file of its own, found by name:

* ``configs/<config>.json``: the sizes, the source and the guarantees;
* ``traffic/<traffic>.json``: the mix, and the ``driver`` that runs it;
* ``drivers/<driver>.py``: everything the harness, the faults, the
  controls and the tests need of a driver, in one file (below);
* ``metrics/<metric>.py``: one reader a metric, end-to-end or per
  layer, ``read(reading) -> float or None``.

A driver module holds:

* ``Driver(config, traffic, seed, device)`` with ``setup()``, ``warm()``,
  ``call(i)`` (the timed call), ``launches()`` (the kernel launches so
  far, or None), ``close_window(calls, launches)`` (the program's
  read-back, then its state freed), ``check() -> (checks, failed)``,
  ``use_reference(rounds)`` (the control), ``inputs()`` (the seeded
  tensors that define a run's inputs), the attributes ``in_flight`` and
  ``nodes_per_call``, and optionally ``work`` (``common.Reading.work``),
  set at set-up;
* ``fault_seams(fault)``: the ``(owner, attribute, replacement)``
  triples that plant ``fault`` underneath the timed path
  (``faults.planted``);
* ``cpu_launch_seams()``: the ``(owner, attribute, wrapper module,
  counter)`` of each plain function that stands in for a kernel on the
  CPU (``faults.cpu_launch_counters``).

Set-up (process start to the first timed call) makes the inputs from the
seed, builds the program's state, warms up the cell's own shapes and
ends with a full garbage collection.
The reference's own work in set-up (a driver's ``reference_s``, such as
the claims a mirror is admitted with) is left out of ``setup_s``.
The window then runs the driver's calls back to back for ``--seconds``
seconds, at most the traffic's ``in_flight`` calls ahead of their
results; a call's latency runs on the host clock from its submission
to its result. After the
window: the device's peak memory, the program's read-back, then the
program's state freed and the reference run (``reference.py``). With
``--trace 1`` the window runs under ``torch.profiler`` and the
program's span tracer is on from set-up, and the line carries the
per-layer metrics instead of the end-to-end ones.

Exits 2 without the cards the cell asks for, 3 if JAX or the JAX
package was loaded, in either case printing no result.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

from portbench import T0
from portbench.common import Reading

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
BANNED = ("jax", "jaxlib", "flax", "khipu_tpu")


def load_manifest(path: Path = ROOT / "BENCHMARK.json") -> dict:
    with open(path) as f:
        return json.load(f)


def find(bench_dir: Path, kind: str, name: str, suffix: str) -> Path:
    """The file of one configuration, traffic mix, driver or metric."""
    path = bench_dir / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1] if kind.endswith('s') else kind}"
                                f" file for {name!r} at {path}")
    return path


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, label: str):
    spec = importlib.util.spec_from_file_location(label, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(bench_dir: Path, driver: str):
    """The module of a traffic's ``driver``, loaded from its file."""
    return load_module(find(bench_dir, "drivers", driver, ".py"),
                       f"portbench_driver_{driver}")


class Cell:
    """One entry of ``workloads`` with its files and metrics."""

    def __init__(self, manifest: dict, workload: str, bench_dir: Path = BENCH_DIR):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.cell = cells[workload]
        self.bench_dir = bench_dir
        self.config = load_json(find(bench_dir, "configs", self.cell["config"], ".json"))
        self.traffic = load_json(find(bench_dir, "traffic", self.cell["traffic"], ".json"))
        self.driver_path = find(bench_dir, "drivers", self.traffic["driver"], ".py")
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in manifest["per_layer"]
                          if (workload in m["workloads"] if "workloads" in m
                              else m["moves"] in e2e)]

    def reader(self, metric: dict):
        name = metric["name"]
        return load_module(find(self.bench_dir, "metrics", name, ".py"),
                           f"portbench_metric_{name.replace('.', '_').replace('-', '_')}")

    def driver(self, config: dict, seed: int, device):
        mod = load_driver(self.bench_dir, self.traffic["driver"])
        return mod.Driver(config, self.traffic, seed, device)


class _Clock:
    """Per-call latency on the host clock, from the call's submission to
    its result: the call has returned and its work on the card is done
    (an event recorded on the card's stream after the call has
    completed). A call submitted behind others in flight waits for them,
    and its latency counts the wait. On the CPU, where only the tests
    run, a call is done when it returns."""

    def __init__(self, torch, device):
        self.torch, self.cuda = torch, device.type == "cuda"
        self.submitted, self.ends, self.done = [], [], []

    def start(self):
        self.submitted.append(time.perf_counter())

    def end(self):
        if self.cuda:
            e = self.torch.cuda.Event()
            e.record()
            self.ends.append(e)
        else:
            self.ends.append(time.perf_counter())

    def wait(self, i: int) -> None:
        """Wait for the results of calls up to ``i``, in order, and note
        when each is there."""
        while len(self.done) <= i:
            end = self.ends[len(self.done)]
            if self.cuda:
                end.synchronize()
                end = time.perf_counter()
            self.done.append(end)

    def latencies_ms(self):
        return [(d - s) * 1e3 for s, d in zip(self.submitted, self.done)]


def _sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device,
             *, manifest=None, bench_dir: Path = BENCH_DIR, sizes=None,
             control_rounds=None, t0: float = T0, marks=None):
    """Run a cell once on ``device``; returns (result line, checks).
    ``sizes`` overrides configuration keys and ``control_rounds`` puts
    the reference at that many rounds in the program's place: both only
    for the tests and the controls, never in a measured run. ``marks``
    (seconds since ``t0`` by step of set-up) is extended and reported."""
    import torch

    marks = dict(marks or {})

    cell = Cell(manifest if manifest is not None else load_manifest(), workload,
                bench_dir)
    config = {**cell.config, **(sizes or {})}
    tracer = None
    if trace:
        from khipu_tpu_torch.observability.trace import tracer

        tracer.reset()
        tracer.enable(capacity=1 << 18)
    drv = cell.driver(config, seed, device)
    if control_rounds is not None:
        drv.use_reference(control_rounds)
    marks["program_imported"] = time.perf_counter() - t0
    drv.setup()
    _sync(torch, device)
    marks["state_built"] = time.perf_counter() - t0
    drv.warm()
    _sync(torch, device)
    marks["warmed_up"] = time.perf_counter() - t0
    # a full collection now, not one that set-up's objects owe the window
    # (the verify cell's 10M keys make it take half a second)
    gc.collect()
    marks["reference_s"] = getattr(drv, "reference_s", 0.0)
    setup_s = time.perf_counter() - t0 - marks["reference_s"]

    launches0 = drv.launches()
    clock = _Clock(torch, device)
    prof = contextlib.nullcontext()
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
    calls = 0
    with prof:
        t_start = time.perf_counter()
        while calls == 0 or time.perf_counter() - t_start < seconds:
            clock.start()
            drv.call(calls)
            clock.end()
            clock.wait(calls - drv.in_flight + 1)
            calls += 1
        clock.wait(calls - 1)
        _sync(torch, device)
        window_s = time.perf_counter() - t_start
    launches = drv.launches() - launches0 if launches0 is not None else None
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    reading = Reading(config=config, traffic=cell.traffic, setup_s=setup_s,
                      calls=calls, window_s=window_s,
                      nodes_per_call=drv.nodes_per_call,
                      latencies_ms=clock.latencies_ms(),
                      work=dict(getattr(drv, "work", {})))
    if trace:
        from portbench import devtrace

        reading.trace = devtrace.read(prof, window_s)
        for s in tracer.snapshot():
            reading.spans[s.name] = reading.spans.get(s.name, 0.0) + s.duration
        tracer.disable()
        tracer.reset()
    del prof

    drv.close_window(calls, launches)
    checks, failed = drv.check()

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.reader(m).read(reading)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                    else "cpu"),
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": all(c.ok for c in checks), "attempted": calls,
              "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = reading.trace.busy_s()
        dev["window_s"] = window_s
        result["breakdown"] = {"device_ops": reading.trace.device_ops(),
                               "idle_gaps": reading.trace.idle_gaps()}
    result["setup_marks_s"] = marks
    result["window"] = _window_summary(reading)
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    return result, checks


def _window_summary(r: Reading) -> dict:
    """The window's calls at a glance, for whoever reads the line: its
    length, the calls' summed latency (the rest is time no call was on
    the card) and their quartiles and extremes."""
    lat = sorted(r.latencies_ms)
    q = statistics.quantiles(lat, n=4) if len(lat) > 1 else lat * 3
    return {"seconds": r.window_s, "calls": r.calls,
            "latency_sum_s": sum(lat) / 1e3, "latency_ms_min": lat[0],
            "latency_ms_quartiles": q, "latency_ms_max": lat[-1]}


def banned_modules():
    """Top-level names of loaded modules that the port must not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m portbench",
                                 description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    manifest = load_manifest()
    cells = {w["name"]: w for w in manifest["workloads"]}
    if args.workload not in cells:
        print(f"portbench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    marks = {"torch_imported": time.perf_counter() - T0}
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell asks for {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.zeros(1, device=device)
    marks["cuda_ready"] = time.perf_counter() - T0
    result, checks = run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), device, manifest=manifest,
                              marks=marks)
    found = banned_modules()
    if found:
        print(f"portbench: the process loaded {', '.join(found)}; no result",
              file=sys.stderr)
        return 3
    print(f"card: {card_line()}", file=sys.stderr)
    for c in checks:
        print(f"check {c.name}: {c.value} (limit {c.limit})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
