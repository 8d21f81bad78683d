"""Driver of the hash cells: one caller, back to back
``khipu_tpu_torch.ops.keccak.keccak256_fixed`` calls, each on a batch of
equal-length rows made on the card from the seed, the digests left
there.

Configuration keys: ``rows`` (a batch), ``row_bytes``.
Traffic keys:

* ``distinct_batches``: the batches the calls go round.
* ``in_flight``: calls the caller lets run ahead of their results.
* ``check_share``, ``check_cap``: the share of the window's calls whose
  digests are kept and compared with the reference, drawn from the
  seed, and at most how many.

Every call has to launch K1f (``keccak_cuda.FIXED_LAUNCHES``): the
window goes round a few batches thousands of times, so a program that
kept the digests of an input it has seen would give right answers
without hashing.
"""

from __future__ import annotations

import torch

from portbench import common, faults, reference
from portbench.common import Check


def fault_seams(fault: str):
    """K1f's wrapper (on the card) and its plain version (on the CPU)."""
    from khipu_tpu_torch.ops import keccak_cuda, keccak_torch

    return [(mod, "absorb_fixed", faults.hash_wrapper(mod.absorb_fixed, fault))
            for mod in (keccak_cuda, keccak_torch)]


def cpu_launch_seams():
    """K1f's plain version, counted as ``keccak_cuda.FIXED_LAUNCHES``."""
    from khipu_tpu_torch.ops import keccak_cuda, keccak_torch

    return [(keccak_torch, "absorb_fixed", keccak_cuda, "FIXED_LAUNCHES")]


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.rows = int(config["rows"])
        self.length = int(config["row_bytes"])
        self.nbatches = int(traffic["distinct_batches"])
        self.in_flight = int(traffic["in_flight"])
        self.cap = int(traffic["check_cap"])
        self.nodes_per_call = self.rows
        self.seed = seed
        self.device = device
        self.sampler = common.Sampler(common.rng(seed, 1),
                                      float(traffic["check_share"]), self.cap)
        self.kept = []  # (batch, digests) of the calls compared
        from khipu_tpu_torch.ops.keccak import keccak256_fixed

        self.entry = lambda rows: keccak256_fixed(rows, device=device)

    def use_reference(self, rounds: int) -> None:
        """The control: the reference at ``rounds`` rounds in the
        program's place."""
        self.entry = lambda rows: reference.keccak256_rows(rows, rounds)

    def inputs(self):
        """The batches the calls go round, made from the seed."""
        return [common.random_rows(torch, self.rows, self.length, self.seed,
                                   10 + b, self.device)
                for b in range(self.nbatches)]

    def setup(self) -> None:
        self.batches = self.inputs()

    def _call(self, i: int, keep: bool) -> None:
        b = i % self.nbatches
        out = self.entry(self.batches[b])
        if keep:
            self.kept.append((b, out))

    def warm(self) -> None:
        for i in range(2 * self.nbatches):
            self._call(i, keep=False)
        # the kept calls' digests stay allocated: reserve their blocks now,
        # so that no allocation reaches the driver in the window
        reserve = [torch.empty((self.rows, 32), dtype=torch.uint8,
                               device=self.device)
                   for _ in range(self.cap + self.in_flight + 1)]
        del reserve

    def call(self, i: int) -> None:
        self._call(i, self.sampler.keep(i))

    def launches(self) -> int:
        from khipu_tpu_torch.ops import keccak_cuda

        return keccak_cuda.FIXED_LAUNCHES

    def close_window(self, calls: int, launches) -> None:
        self.calls, self.k1f_launches = calls, launches

    def check(self):
        ref = {}
        wrong, failed = 0, 0
        for b, digests in self.kept:
            if b not in ref:
                ref[b] = reference.keccak256_rows(self.batches[b])
            bad = int((digests != ref[b]).any(dim=1).sum())
            wrong += bad
            failed += bad > 0
        return [
            Check("digests_wrong", wrong, 0),
            Check("k1f_launches_short", max(0, self.calls - self.k1f_launches), 0),
        ], failed
