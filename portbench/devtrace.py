"""Reading a ``torch.profiler`` trace of the measured window.

The profiler's Chrome-trace export is read back as three lists: the
device's kernels, its copies (with their bytes) and memsets, and what
the host was doing (operators and CUDA runtime calls). The busy time is
the union of the device's intervals, the arithmetic of
``scripts/torch_profile.py``'s ``device_profile``, copied here so that
the yardstick does not change with that script.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")


@dataclass
class Event:
    name: str
    ts: float  # microseconds
    dur: float  # microseconds

    @property
    def end(self) -> float:
        return self.ts + self.dur


@dataclass
class DeviceTrace:
    window_s: float
    kernels: List[Event] = field(default_factory=list)
    copies: List[Event] = field(default_factory=list)
    memsets: List[Event] = field(default_factory=list)
    host: List[Event] = field(default_factory=list)

    def device_events(self) -> List[Event]:
        return [*self.kernels, *self.copies, *self.memsets]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device's intervals, in order (microseconds)."""
        merged: List[Tuple[float, float]] = []
        for e in sorted(self.device_events(), key=lambda e: e.ts):
            if merged and e.ts <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e.end))
            else:
                merged.append((e.ts, e.end))
        return merged

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def kernels_named(self, part: str) -> List[Event]:
        return [e for e in self.kernels if part in e.name]

    def device_ops(self, top: int = 10) -> List[list]:
        """The device operations that took most time: [name, seconds]."""
        total = {}
        for e in self.device_events():
            total[e.name] = total.get(e.name, 0.0) + e.dur / 1e6
        return [[k, v] for k, v in
                sorted(total.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """The longest gaps between device work, each named by the host
        event that overlaps it most: [name, seconds]."""
        busy = self.busy_intervals()
        gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]]
        gaps.sort(key=lambda g: g[0] - g[1])
        host = sorted(self.host, key=lambda e: e.ts)
        out = []
        for lo, hi in gaps[:top]:
            best, best_overlap = "host, no traced operation", 0.0
            for e in host:
                if e.ts >= hi:
                    break
                overlap = min(hi, e.end) - max(lo, e.ts)
                if overlap > best_overlap:
                    best, best_overlap = e.name, overlap
            out.append([best, (hi - lo) / 1e6])
        return out


def _short(name: str) -> str:
    return name if len(name) <= 96 else name[:93] + "..."


def read(prof, window_s: float) -> DeviceTrace:
    """A :class:`DeviceTrace` of a finished ``torch.profiler.profile``.
    The export goes to a temporary file in ``TMPDIR`` and is removed."""
    fd, path = tempfile.mkstemp(prefix="portbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    trace = DeviceTrace(window_s=window_s)
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = ev.get("cat", "")
        e = Event(_short(str(ev.get("name", ""))), float(ev["ts"]),
                  float(ev["dur"]))
        if cat == "kernel":
            trace.kernels.append(e)
        elif cat == "gpu_memcpy":
            trace.copies.append(e)
        elif cat == "gpu_memset":
            trace.memsets.append(e)
        elif cat in HOST_CATS:
            trace.host.append(e)
    return trace
