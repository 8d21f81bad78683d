"""Cost-model-adaptive commit: pick the commit path the device is
actually fast at.

The port's counterpart of ``khipu_tpu.sync.adaptive``. The device-
resident commit (the fused fixpoint K5 and the device mirror) is a bet:
that card-to-card gathers and one fixpoint launch beat the host memcpy
and scalar Keccak they replace. Two instruments and one controller keep
checking it:

* ``probe_backend()`` — a one-shot measurement per device, cached: time
  an ``index_select`` gather of a seeded random u8 tile on the device
  (CUDA events on the card) against numpy fancy indexing of the same
  tile on the host. Device commit only engages when the device wins by
  ``adaptive_d2d_margin``. On a CPU device "device" memory IS host RAM,
  so the probe reports ``device_ok=False`` without timing anything: the
  gather would be a memcpy by construction, and timing it would turn
  noise into a mode.
* ``AdaptiveCommitController`` — an EWMA over each window's seal-stage
  cost per hash, one series per mode, with a Schmitt trigger between
  them: flip device -> host when the device EWMA exceeds
  ``adaptive_flip_ratio`` x the host estimate, flip back only below
  ``adaptive_flip_back_ratio`` x, and never flip before
  ``adaptive_dwell_windows`` windows have passed in the current mode.
  The host estimate starts from a calibrated scalar-Keccak floor and is
  replaced by the measured host EWMA once host windows run.
  ``device_mirror_commit`` stays the CAP: the controller only ever
  downgrades device -> host.

Both commit paths produce byte-identical state roots, so adaptive timing
nondeterminism never touches replay bit-exactness — only which hardware
does the hashing.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from khipu_tpu_torch.base.keccak import keccak256
from khipu_tpu_torch.device import resolve_device
from khipu_tpu_torch.observability.profiler import H2D, LEDGER
from khipu_tpu_torch.observability.registry import REGISTRY

ADAPTIVE_GAUGES = REGISTRY.gauge_group("khipu_adaptive", {
    # 1 while the controller holds the device-mirror commit path
    "device_mode": 0,
    # mode changes, ever (the initial probe downgrade counts)
    "flips_total": 0,
    "windows_observed": 0,
    # probe readout (bytes/s; 0 until a probe ran)
    "probe_d2d_bytes_per_s": 0,
    "probe_memcpy_bytes_per_s": 0,
    # per-hash seal-stage EWMAs the Schmitt trigger compares (seconds)
    "ewma_device_hash_s": 0.0,
    "ewma_host_hash_s": 0.0,
    # flips wanted by the ratio but suppressed by the dwell window
    "flap_suppressed_total": 0,
}, help="cost-model-adaptive commit controller (sync/adaptive.py)")

# probe workload: ~0.5 MB gathered through 2k rows
_PROBE_ROWS = 2048
_PROBE_COLS = 256
_PROBE_REPS = 3

# one probe per device per process: the answer cannot change under us
_PROBE_CACHE: Dict[str, "ProbeResult"] = {}


class ProbeResult:
    """One device's gather-vs-memcpy measurement."""

    __slots__ = ("platform", "d2d_bytes_per_s", "memcpy_bytes_per_s",
                 "device_ok")

    def __init__(self, platform: str, d2d_bytes_per_s: float,
                 memcpy_bytes_per_s: float, device_ok: bool):
        self.platform = platform
        self.d2d_bytes_per_s = d2d_bytes_per_s
        self.memcpy_bytes_per_s = memcpy_bytes_per_s
        self.device_ok = device_ok

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"<Probe {self.platform} d2d={self.d2d_bytes_per_s:.3g}B/s "
            f"memcpy={self.memcpy_bytes_per_s:.3g}B/s "
            f"ok={self.device_ok}>"
        )


def _measure_probe(device: torch.device, margin: float) -> ProbeResult:
    rng = np.random.default_rng(0)  # seeded, replay-stable
    host = rng.integers(0, 256, size=(_PROBE_ROWS, _PROBE_COLS),
                        dtype=np.uint8)
    idx = rng.permutation(_PROBE_ROWS).astype(np.int64)
    with LEDGER.transfer("adaptive.probe", H2D, host.nbytes + idx.nbytes):
        dev = torch.from_numpy(host).to(device)
        idx_dev = torch.from_numpy(idx).to(device)
    dev.index_select(0, idx_dev)  # warm: allocator, kernel load
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(_PROBE_REPS):
        dev.index_select(0, idx_dev)
    end.record()
    end.synchronize()
    d2d_s = start.elapsed_time(end) / 1e3 / _PROBE_REPS

    host[idx]  # warm the host path too (page faults, cache)
    t0 = time.perf_counter()
    for _ in range(_PROBE_REPS):
        host[idx]
    memcpy_s = (time.perf_counter() - t0) / _PROBE_REPS

    nbytes = host.nbytes
    d2d_rate = nbytes / d2d_s if d2d_s > 0 else 0.0
    memcpy_rate = nbytes / memcpy_s if memcpy_s > 0 else 0.0
    ok = d2d_rate >= margin * memcpy_rate > 0
    return ProbeResult(str(device), d2d_rate, memcpy_rate, ok)


def probe_backend(margin: float = 1.5, device=None) -> ProbeResult:
    """Measure (once per device) whether card-to-card gathers beat the
    host memcpy they would replace by ``margin``. ``device=None`` means
    the card; a CPU device reports ``device_ok=False`` unmeasured."""
    dev = resolve_device(device)
    key = str(dev)
    cached = _PROBE_CACHE.get(key)
    if cached is not None:
        return cached
    if dev.type == "cpu":
        result = ProbeResult(key, 0.0, 0.0, False)
    else:
        result = _measure_probe(dev, margin)
    _PROBE_CACHE[key] = result
    ADAPTIVE_GAUGES["probe_d2d_bytes_per_s"] = int(result.d2d_bytes_per_s)
    ADAPTIVE_GAUGES["probe_memcpy_bytes_per_s"] = int(
        result.memcpy_bytes_per_s
    )
    return result


def exec_device_allowed(sync_cfg, device=None) -> bool:
    """Gate for the execute-stage device dispatch (ledger/batch_*.py
    -> trie/fused.fused_exec_validate, K6 on the card): the sync config
    must opt in (``exec_device``, the cap) AND, unless
    ``adaptive_probe`` is off, the one-shot probe of ``device`` must
    show real device memory — d2d beating host memcpy by the margin the
    adaptive commit controller demands. A CPU device reports False, so
    the host numpy pass runs there."""
    if not getattr(sync_cfg, "exec_device", False):
        return False
    if not getattr(sync_cfg, "adaptive_probe", True):
        return True  # explicit cap with probing disabled: honor it
    return probe_backend(sync_cfg.adaptive_d2d_margin, device).device_ok


def _calibrate_host_hash_s(samples: int = 256) -> float:
    """Seconds per scalar host Keccak — the host estimate the trigger
    compares against until measured host windows replace it."""
    msg = b"\x5a" * 128  # a typical branch-node encoding size
    keccak256(msg)  # bind the implementation outside the clock
    t0 = time.perf_counter()
    for _ in range(samples):
        keccak256(msg)
    return (time.perf_counter() - t0) / samples


class AdaptiveCommitController:
    """Per-replay mode controller. All methods run on the seal-stage
    thread (one window at a time), so plain attributes suffice.
    ``device`` is the replay's device (``None`` means the card)."""

    def __init__(self, sync_cfg, device_cap: bool = True, device=None):
        self.cfg = sync_cfg
        # the config is the CAP: adaptive only downgrades device->host
        self.device_cap = bool(device_cap)
        self.device_mode = self.device_cap
        self.windows = 0
        self.flips = 0
        self.flaps_suppressed = 0
        self._dwell = 0  # windows spent in the current mode
        self._ewma: Dict[str, Optional[float]] = {
            "device": None, "host": None,
        }
        self.host_floor_s = _calibrate_host_hash_s()
        self.probe: Optional[ProbeResult] = None
        if self.device_cap and sync_cfg.adaptive_probe:
            self.probe = probe_backend(sync_cfg.adaptive_d2d_margin, device)
            if not self.probe.device_ok:
                self._flip(False)
        self._export()

    def mode(self) -> str:
        return "device" if self.device_mode else "host"

    def observe_window(self, mode: str, hashes: int,
                       seal_seconds: float) -> None:
        """One window's seal-stage verdict: ``hashes`` nodes resolved in
        ``seal_seconds`` under ``mode``. Updates that mode's EWMA, then
        re-runs the Schmitt trigger."""
        self.windows += 1
        self._dwell += 1
        if hashes > 0 and seal_seconds > 0:
            per_hash = seal_seconds / hashes
            prev = self._ewma.get(mode)
            alpha = self.cfg.adaptive_ewma_alpha
            self._ewma[mode] = (
                per_hash if prev is None
                else alpha * per_hash + (1.0 - alpha) * prev
            )
        self._decide()
        self._export()

    def _host_estimate(self) -> float:
        measured = self._ewma.get("host")
        return measured if measured is not None else self.host_floor_s

    def _decide(self) -> None:
        if not self.device_cap:
            return
        host_est = self._host_estimate()
        dev = self._ewma.get("device")
        if host_est <= 0 or dev is None:
            return
        ratio = dev / host_est
        if self.device_mode and ratio > self.cfg.adaptive_flip_ratio:
            want = False
        elif (not self.device_mode
              and ratio < self.cfg.adaptive_flip_back_ratio
              and (self.probe is None or self.probe.device_ok)):
            want = True
        else:
            return
        if self._dwell >= self.cfg.adaptive_dwell_windows:
            self._flip(want)
        else:
            self.flaps_suppressed += 1

    def _flip(self, device_mode: bool) -> None:
        self.device_mode = device_mode
        self.flips += 1
        self._dwell = 0

    def _export(self) -> None:
        ADAPTIVE_GAUGES["device_mode"] = int(self.device_mode)
        ADAPTIVE_GAUGES["flips_total"] = self.flips
        ADAPTIVE_GAUGES["windows_observed"] = self.windows
        ADAPTIVE_GAUGES["flap_suppressed_total"] = self.flaps_suppressed
        dev = self._ewma.get("device")
        host = self._ewma.get("host")
        ADAPTIVE_GAUGES["ewma_device_hash_s"] = (
            round(dev, 9) if dev is not None else 0.0
        )
        ADAPTIVE_GAUGES["ewma_host_hash_s"] = (
            round(host, 9) if host is not None else 0.0
        )
