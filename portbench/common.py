"""What the harness, the drivers and the readers share: seeds, the record
of a compared number, and what a per-layer reader is given."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


def _entropy(seed: int) -> int:
    # any whole number, negative ones too, as 64 bits
    return int(seed) % (1 << 64)


def rng(seed: int, stream: int) -> np.random.Generator:
    """The host generator of one input stream of a run."""
    return np.random.default_rng(np.random.SeedSequence([_entropy(seed), stream]))


def torch_generator(torch, seed: int, stream: int, device):
    """A ``torch.Generator`` on ``device`` for one input stream of a run."""
    s = np.random.SeedSequence([_entropy(seed), stream]).generate_state(1, np.uint64)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(s[0]))
    return gen


def random_rows(torch, n: int, length: int, seed: int, stream: int, device):
    """u8[n, length] uniform bytes, made on ``device`` from the seed."""
    gen = torch_generator(torch, seed, stream, device)
    return torch.randint(0, 256, (n, length), dtype=torch.uint8,
                         device=device, generator=gen)


@dataclass
class Check:
    """One number compared with the reference, and its limit: a run is
    correct only where every value is at most its limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class Reading:
    """What a metric's reader gets: the cell, the set-up time, the
    measured window (its calls, their latencies, the nodes a call
    handles), the device trace (None where the run was not traced) and
    the spans the program recorded (name -> seconds, summed over set-up
    and window; empty where the run was not traced)."""
    config: dict
    traffic: dict
    setup_s: float
    calls: int
    window_s: float
    nodes_per_call: int
    latencies_ms: List[float] = field(default_factory=list)
    trace: Optional[object] = None
    spans: Dict[str, float] = field(default_factory=dict)


class Sampler:
    """Which calls of the window to keep for the comparison: each with
    probability ``share``, drawn from the seed before the window, the
    first two always, at most ``cap`` in all."""

    def __init__(self, gen: np.random.Generator, share: float, cap: int,
                 horizon: int = 1 << 20):
        self._draws = gen.random(horizon) < share
        self._draws[:2] = True
        self._cap = cap
        self.kept = 0

    def keep(self, i: int) -> bool:
        if self.kept >= self._cap or i >= self._draws.size or not self._draws[i]:
            return False
        self.kept += 1
        return True
