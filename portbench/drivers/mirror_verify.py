"""Driver of the snapshot-verify cells: a ``DeviceNodeMirror`` built at
set-up through its public API, then one caller making back to back
``DeviceNodeMirror.verify()`` calls.

Set-up makes the rows on the card from the seed, works out their claims
with the benchmark's own reference (timed as ``reference_s``, which the
harness leaves out of ``setup_s``), alters one bit of the claims of a
seeded number of rows (one in each of that many equal strata of the
rows, so that any half of the rows holds at least one), and admits rows
and claims with ``admit_packed(exact=True)``. The harness never reads
the mirror's private tensors.

Configuration keys: ``rows``, ``row_bytes``.
Traffic keys: ``altered_min``, ``altered_max`` (the bounds of the
number of altered claims), ``sample_keys`` (rows read back through
``get`` after the window, beside every altered one).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import common, faults, reference
from portbench.common import Check


def fault_seams(fault: str):
    """K4's entry (its wrapper on the card, its plain version on the
    CPU); for ``half`` the admit as well, for ``altered`` the read-back."""
    from khipu_tpu_torch.storage import device_mirror

    seams = [(device_mirror, "verify_planes",
              faults.verify_wrapper(device_mirror.verify_planes, fault))]
    mirror, cls = device_mirror.DeviceNodeMirror, device_mirror._ClassMirror
    if fault == "half":
        seams.append((mirror, "admit_packed", faults.admit_wrapper(mirror.admit_packed)))
    if fault == "altered":
        seams.append((cls, "fetch_row", faults.fetch_wrapper(cls.fetch_row)))
    return seams


def cpu_launch_seams():
    """K4's entry, counted as ``mirror_cuda.VERIFY_LAUNCHES``."""
    from khipu_tpu_torch.storage import device_mirror, mirror_cuda

    return [(device_mirror, "verify_planes", mirror_cuda, "VERIFY_LAUNCHES")]


class Driver:
    in_flight = 1

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.rows = int(config["rows"])
        self.length = int(config["row_bytes"])
        self.nodes_per_call = self.rows
        self.seed = seed
        self.device = device
        gen = common.rng(seed, 2)
        lo, hi = int(traffic["altered_min"]), int(traffic["altered_max"])
        if not 2 <= lo <= hi <= self.rows:
            raise ValueError("need 2 <= altered_min <= altered_max <= rows")
        self.altered_n = int(gen.integers(lo, hi + 1))
        edges = np.linspace(0, self.rows, self.altered_n + 1).astype(np.int64)
        self.altered = np.array([gen.integers(a, b) for a, b in
                                 zip(edges[:-1], edges[1:])], dtype=np.int64)
        self.flip_byte = gen.integers(0, 32, self.altered_n)
        self.flip_bit = gen.integers(0, 8, self.altered_n)
        sample = gen.choice(self.rows, size=min(int(traffic["sample_keys"]),
                                                self.rows), replace=False)
        self.sample = np.union1d(sample, self.altered)
        self.control_rounds = None
        self.counts = []

    def use_reference(self, rounds: int) -> None:
        """The control: the reference's verify at ``rounds`` rounds in
        the program's place (the mirror is still built and read back)."""
        self.control_rounds = rounds

    def inputs(self):
        """The rows, the altered rows and the rows read back, made from
        the seed."""
        return [self._make_rows(), torch.from_numpy(self.altered),
                torch.from_numpy(self.sample)]

    def _make_rows(self):
        return common.random_rows(torch, self.rows, self.length, self.seed,
                                  20, self.device)

    def setup(self) -> None:
        from khipu_tpu_torch.storage.device_mirror import DeviceNodeMirror

        rows = self._make_rows()
        _sync(self.device)
        t = time.perf_counter()
        claims = reference.keccak256_rows(rows)
        _sync(self.device)
        self.reference_s = time.perf_counter() - t
        idx = torch.from_numpy(self.altered).to(self.device)
        byte = torch.from_numpy(self.flip_byte).to(self.device)
        bit = torch.from_numpy(np.left_shift(1, self.flip_bit)
                               .astype(np.uint8)).to(self.device)
        claims[idx, byte] ^= bit
        self.claims = claims.cpu().numpy()
        raw = self.claims.tobytes()
        self.keys = [raw[i:i + 32] for i in range(0, len(raw), 32)]
        if self.device.type == "cuda":
            # the inputs are made; the peak counts from here
            torch.cuda.reset_peak_memory_stats(self.device)
        self.mirror = DeviceNodeMirror(capacity_rows_per_class=self.rows,
                                       device=self.device)
        self.mirror.admit_packed(self.keys, rows, exact=True)
        self.verify = self.mirror.verify
        if self.control_rounds is not None:
            self.verify = _reference_verify(rows, claims, self.control_rounds)

    def warm(self) -> None:
        for _ in range(2):
            self.verify()

    def call(self, i: int) -> None:
        self.counts.append(self.verify())

    def launches(self) -> int:
        from khipu_tpu_torch.storage import mirror_cuda

        return mirror_cuda.VERIFY_LAUNCHES

    def close_window(self, calls: int, launches) -> None:
        """Read what the program holds, then free it."""
        self.calls, self.k4_launches = calls, launches
        self.read_back = {int(r): self.mirror.get(self.keys[r])
                          for r in self.sample}
        self.resident = self.mirror.resident_count
        self.mirror = self.verify = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        rows = self._make_rows()
        claims = torch.from_numpy(self.claims).to(self.device)
        expected = reference.mismatches(rows, claims)
        if expected != self.altered_n:
            raise RuntimeError(f"the harness's own fault: the reference counts "
                               f"{expected} bad claims, {self.altered_n} were planted")
        del claims
        sampled = rows[torch.from_numpy(self.sample).to(self.device)].cpu().numpy()
        del rows
        rows_wrong = sum(self.read_back[int(r)] != sampled[j].tobytes()
                         for j, r in enumerate(self.sample))
        failed = sum(c != expected for c in self.counts)
        return [
            Check("count_gap", max(abs(c - expected) for c in self.counts), 0),
            Check("rows_wrong", rows_wrong, 0),
            Check("resident_gap", abs(self.resident - self.rows), 0),
            Check("k4_launches_short", max(0, self.calls - self.k4_launches), 0),
        ], failed


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _reference_verify(rows, claims, rounds: int):
    return lambda: reference.mismatches(rows, claims, rounds)
