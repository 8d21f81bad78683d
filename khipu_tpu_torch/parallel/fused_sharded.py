"""Multi-card fused window finalize: the fixpoint split over a mesh.

The counterpart of ``khipu_tpu/parallel/fused_sharded.py``. The JAX
package deals rows round-robin to the chips and runs ``rounds`` rounds
of (hash every row, all_gather the digest table, substitute every
triple), depth bounded by ``MAX_DEPTH``.

The port packs the window once on every rank with the one-card pack
(``trie/fused.py``: ``pack_host``, ``level_plan``), so each rank holds
every encoding and the whole level order. Then, a level at a time:

1. each rank runs K5 over its contiguous share of the level's rows in
   ``order`` (a one-level plan, ``level_ptr = [lo, hi]``; the rows read
   their children's digests from ``digests``), or the plain version of
   those rows on the CPU;
2. one all_gather of the level's digests, scattered into
   ``digests[order[level]]`` on every rank.

A rank launches K5 once a level whose share is not empty (at world 1,
once a level: the one-card path's single launch becomes one a level,
the price of a collective between levels), and issues one all_gather a
level. No depth limit: the plan has as many levels as the DAG.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from khipu_tpu_torch.observability.profiler import D2H, H2D, LEDGER
from khipu_tpu_torch.parallel.mesh import Mesh
from khipu_tpu_torch.trie import fused


def fused_resolve_sharded(
    to_resolve: Dict[bytes, bytes],
    deps: Dict[bytes, List[bytes]],
    prefix: bytes,
    mesh: Mesh,
    stats_out: Optional[dict] = None,
) -> Dict[bytes, bytes]:
    """Resolve placeholder -> Keccak-256 hash for every entry across the
    mesh; every rank returns the whole mapping. The contract of
    ``trie.fused.fused_resolve``: the DAG comes from the encodings'
    ``prefix`` spans, so ``deps`` is not read. ``stats_out`` (a dict)
    receives ``levels``, ``k5_levels`` (the levels this rank launched
    on), ``loop_ms`` (the level loop) and ``gather_ms`` (its
    all_gathers and scatters), from CUDA events on the card."""
    if not to_resolve:
        return {}
    dev = mesh.device
    classes, dpos, total_rows, plan = fused.pack_host(to_resolve, prefix)
    # each level's share of this rank, [lo, hi) into order
    level_ptr = plan.level_ptr
    sizes = np.diff(level_ptr)
    per = -(-sizes // mesh.size)
    lo = np.minimum(level_ptr[:-1] + mesh.rank * per, level_ptr[1:])
    hi = np.minimum(lo + per, level_ptr[1:])
    bounds = np.stack([lo, hi], axis=1).astype(np.int32)
    with LEDGER.transfer("shard.dispatch", H2D,
                         fused.packed_nbytes(classes, plan) + bounds.nbytes):
        fused.upload_packed(classes, plan, dev)
        d_bounds = torch.from_numpy(bounds).to(dev)
    digests = torch.zeros((total_rows, 32), dtype=torch.uint8, device=dev)
    ext = torch.zeros((0, 32), dtype=torch.uint8, device=dev)
    order = plan.d_order.long()

    # one send and one receive buffer for every level, views of them a
    # level (a share's tail past its rows is zero filler)
    widest = int(per.max())
    send = torch.zeros((widest, 32), dtype=torch.uint8, device=dev)
    recv = torch.empty((mesh.size * widest, 32), dtype=torch.uint8,
                       device=dev)

    # the level loop's split, timed only when a caller asks for it
    timer = _Timer(dev) if stats_out is not None else None
    k5_levels = 0
    for lvl in range(plan.nlevels):
        a, b, p = int(lo[lvl]), int(hi[lvl]), int(per[lvl])
        if b > a:
            fused.resolve_level_rows(classes, total_rows, ext, plan,
                                     digests, a, b, d_bounds[lvl])
            k5_levels += 1
        if timer:
            timer.mark()
        local = send[:p]
        torch.index_select(digests, 0, order[a:b], out=local[: b - a])
        local[b - a:] = 0
        table = mesh.all_gather_rows(local, recv[: mesh.size * p])
        rows = order[level_ptr[lvl] : level_ptr[lvl + 1]]
        digests.index_copy_(0, rows, table[: int(sizes[lvl])])
        if timer:
            timer.mark(gather=True)

    with LEDGER.transfer("shard.gather", D2H, digests.numel()):
        blob = digests.cpu().numpy().tobytes()
    if stats_out is not None:
        stats_out.update(levels=plan.nlevels, k5_levels=k5_levels,
                         **timer.totals())
    return {ph: blob[32 * r : 32 * r + 32] for ph, r in dpos.items()}


class _Timer:
    """Splits the level loop into K5 work and gathers: CUDA events on
    the card (read once, after the loop), the host clock on the CPU."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.marks = [self._now()]
        self.gather = []

    def _now(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def mark(self, gather: bool = False) -> None:
        self.marks.append(self._now())
        if gather:
            self.gather.append(len(self.marks) - 1)

    def _ms(self, a, b) -> float:
        if self.cuda:
            return a.elapsed_time(b)
        return (b - a) * 1e3

    def totals(self) -> dict:
        if self.cuda:
            self.marks[-1].synchronize()
        return {"loop_ms": self._ms(self.marks[0], self.marks[-1]),
                "gather_ms": sum(self._ms(self.marks[i - 1], self.marks[i])
                                 for i in self.gather)}
