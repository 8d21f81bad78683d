#!/usr/bin/env python3
"""Profile the port's main-path workloads on one NVIDIA card.

    python3 scripts/torch_profile.py [--seed N] [--out DIR]

Runs main-path workloads of ``chip_smoke.py`` on the card — a fresh
100,000-account ``bulk_build(fused=True)``, a 16-block x 400-write
window ``finalize(fused=True, return_mapping=True)``, a fast sync of
that state with 1,000 contracts into a ``DeviceNodeMirror``, and the
serial replays with ``device_commit`` (128 blocks of one value transfer,
and a deploy block then 16 blocks of 200 ERC-20 transfers, each built on
the host first and replayed into a fresh chain, sender cache cold) and
the ERC-20 chain again through the windowed pipeline at
``commit_window_blocks=8`` (``replay_erc20_w8``, at the port's defaults:
no adaptive controller, so every window runs K5; the line gives the
adaptive probe's readout in this process), that chain at
``parallel_tx=True`` (``replay_erc20_par_w8``: the scheduled executor)
and 32 blocks of 200 contended transfers at window 16 through the
vectorized transfer lane with ``exec_device=True`` and the probe off
(``replay_transfers_par_w16``: K6 a batch) — each once with only the
port's spans on, then once under ``torch.profiler``. ``--only`` names
the workloads to run (default: all).
For each it prints one JSON line: host wall seconds, span seconds, the
device's busy seconds (the union of device activity intervals in the
trace), the device's idle share of the profiled wall time, device time
by kernel name, and the launches, device time and share of the busy
time of K5 (the fixpoint kernel), of K1r (the batched sponge of fast
sync's content check and of the replays' trie commits and sender
batches) and of K6 (the row validation); the replays also give K1r's,
K5's and K6's device ms a block, and the frames the native VM and the
Python VM ran. ``focus_s`` picks the spans the native host closure
should move: ``seal.dispatch_build`` (the seal stage's scan, RLP-decoding
every staged node) and ``fastsync.fetch`` (fast sync's fetch and child
decode). ``--beside FILE`` (this script's output from another tree, for
instance the parent commit's, run in the same call) puts that run's
focus spans beside this one's.
Chrome traces go to ``DIR`` (default ``_profiles/``, which
``.gitignore`` lists).
Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FOCUS_SPANS = ("seal.dispatch_build", "fastsync.fetch")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def device_profile(torch, prof, wall_s: float, top: int = 8) -> dict:
    """Busy time, idle share and per-kernel device time from a trace."""
    from torch.autograd import DeviceType

    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in prof.events()
        if e.device_type == DeviceType.CUDA
    )
    busy_us, cur_start, cur_end = 0.0, None, None
    for start, end in spans:
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy_us += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy_us += cur_end - cur_start
    kernels = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", 0.0)
        if dev_us > 0:
            kernels.append({"name": e.key[:80], "count": e.count,
                            "device_ms": dev_us / 1e3})
    kernels.sort(key=lambda k: -k["device_ms"])
    busy_s = busy_us / 1e6

    def kernel(match):
        rows = [k for k in kernels if match in k["name"]]
        ms = sum(k["device_ms"] for k in rows)
        return {"launches": sum(k["count"] for k in rows), "device_ms": ms,
                "share_of_device_time": (ms / 1e3 / busy_s) if busy_s else None}

    return {
        "device_busy_s": busy_s,
        "device_idle_share": (1.0 - busy_s / wall_s) if busy_s else None,
        "device_events": len(spans),
        "k5": kernel("fixpoint_levels"),
        "k1r": kernel("ragged"),
        "k6": kernel("exec_validate"),
        "kernels": kernels[:top],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--accounts", type=int, default=100_000)
    ap.add_argument("--blocks", type=int, default=16)
    ap.add_argument("--writes", type=int, default=400)
    ap.add_argument("--new-accounts", type=int, default=20)
    ap.add_argument("--out", default=os.path.join(ROOT, "_profiles"))
    ap.add_argument("--only", default="",
                    help="comma-separated workload names (default: all)")
    ap.add_argument("--beside", default="",
                    help="an earlier run's output, whose focus spans each "
                    "line repeats")
    args = ap.parse_args()
    only = set(filter(None, args.only.split(",")))
    beside = {}
    if args.beside:
        with open(args.beside) as f:
            for raw in f:
                if raw.startswith("{"):
                    earlier = json.loads(raw)
                    beside[earlier["workload"]] = earlier.get("spans_s", {})

    import torch

    if not torch.cuda.is_available():
        print("torch_profile: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from khipu_tpu_torch import workloads
    from khipu_tpu_torch.domain.block import Block
    from khipu_tpu_torch.domain.blockchain import Blockchain
    from khipu_tpu_torch.evm.dispatch import VM_GAUGES
    from khipu_tpu_torch.ledger.schedule import reset_learner
    from khipu_tpu_torch.observability.trace import tracer
    from khipu_tpu_torch.ops import build
    from khipu_tpu_torch.state import load_reference_nodes
    from khipu_tpu_torch.storage.datasource import MemoryKeyValueDataSource
    from khipu_tpu_torch.storage.device_mirror import TILE, DeviceNodeMirror
    from khipu_tpu_torch.storage.storages import Storages
    from khipu_tpu_torch.sync import adaptive, prefetch
    from khipu_tpu_torch.sync.fast_sync import FastSyncStateStorage, StateSyncer
    from khipu_tpu_torch.sync.replay import ReplayDriver
    from khipu_tpu_torch.trie import bulk, deferred

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip(), flush=True)
    os.makedirs(args.out, exist_ok=True)
    dev = torch.device("cuda")
    build.load()

    def wanted(name):
        return not only or name in only

    def measure(name, fn, **extra):
        # every thread's spans, on the process tracer, for this run only
        tracer.reset()
        tracer.enable(capacity=1 << 20)
        frames0 = dict(VM_GAUGES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tracer.disable()
        frames = {k: VM_GAUGES[k] - frames0[k] for k in frames0}
        if tracer.dropped:
            raise RuntimeError(f"the span ring dropped {tracer.dropped}")
        spans = {}
        for s in tracer.snapshot():
            spans[s.name] = spans.get(s.name, 0.0) + s.duration
        tracer.reset()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            pwall = time.perf_counter() - t0
        prof.export_chrome_trace(os.path.join(args.out, f"{name}.json"))
        line = {"workload": name, "wall_s": wall, "spans_s": spans,
                "focus_s": {k: spans.get(k) for k in FOCUS_SPANS},
                "profiled_wall_s": pwall, **device_profile(torch, prof, pwall),
                **frames, **extra}
        if name in beside:
            line["focus_s_beside"] = {k: beside[name].get(k)
                                      for k in FOCUS_SPANS}
        if "blocks" in extra:
            for k in ("k1r", "k5", "k6"):
                line[f"{k}_device_ms_per_block"] = (line[k]["device_ms"]
                                                    / extra["blocks"])
                line[f"{k}_launches_per_block"] = (line[k]["launches"]
                                                   / extra["blocks"])
        if hasattr(result, "phases"):  # a replay's ReplayStats
            line["phases_s"] = result.phases
            line["blocks_per_s"] = result.blocks_per_s
            line["parallel_rate"] = result.parallel_rate
        emit(line)
        return result

    if wanted("bulk_100k") or wanted("fast_sync") or wanted("window_16x400"):
        pairs = workloads.fresh_state_pairs(args.accounts, device=dev)
        bulk.bulk_build(pairs[:1000], fused=True, device=dev)  # warm-up
        root, nodes = measure(
            "bulk_100k",
            lambda: bulk.bulk_build(pairs, fused=True, device=dev),
            accounts=args.accounts,
        )

    if wanted("fast_sync"):
        src_root, stores = workloads.contract_snapshot(
            pairs, np.random.default_rng(args.seed + 1), device=dev)
        total = sum(len(s) for s in stores)
        capacity = -(-total // TILE) * TILE

        def sync():
            syncer = StateSyncer(
                Storages(), FastSyncStateStorage(MemoryKeyValueDataSource()),
                workloads.snapshot_fetch(stores),
                mirror=DeviceNodeMirror(capacity, device=dev), device=dev)
            return syncer.start(src_root).downloaded_nodes

        measure("fast_sync", sync, nodes=total)

    if wanted("window_16x400"):
        session = deferred.DeferredMPT(load_reference_nodes(nodes),
                                       root_hash=root)
        blocks = workloads.TransferBlocks(pairs,
                                          np.random.default_rng(args.seed))
        for _ in range(args.blocks):
            for k, v in blocks.next(args.writes, args.new_accounts).items():
                session = session.put(k, v)
            session.force_hashed_root()
        measure(
            "window_16x400",
            lambda: deferred.finalize(session, return_mapping=True,
                                      fused=True, device=dev),
            blocks=args.blocks, writes=args.writes,
        )

    serial = workloads.replay_config()  # builds every chain, serially
    erc20 = workloads.erc20_chain(serial, 16, 200, 256)
    replays = (
        ("replay_transfers_128x1", serial, lambda: workloads.transfer_chain(
            serial, 128, 1)),
        ("replay_erc20_16x200", serial, lambda: erc20),
        ("replay_erc20_w8", workloads.replay_config(commit_window_blocks=8),
         lambda: erc20),
        ("replay_erc20_par_w8", workloads.replay_config(
            parallel_tx=True, commit_window_blocks=8), lambda: erc20),
        ("replay_transfers_par_w16", workloads.replay_config(
            parallel_tx=True, commit_window_blocks=16, exec_device=True,
            adaptive_probe=False),
         lambda: workloads.contended_transfer_chain(serial, 32, 200)),
    )
    for name, cfg, chain in replays:
        if not wanted(name):
            continue
        _, spec, blocks = chain()
        wire = [b.encode() for b in blocks]
        targets = []
        for _ in range(2):  # one chain for each of measure's two runs
            targets.append(Blockchain(Storages(), cfg))
            targets[-1].load_genesis(spec, on_device=True, device=dev)

        def run(cfg=cfg, targets=targets, wire=wire):
            prefetch.flush_sender_cache()
            reset_learner()
            return ReplayDriver(targets.pop(0), cfg, device_commit=True,
                                device=dev).replay(
                [Block.decode(w) for w in wire])

        extra = {}
        if cfg.sync.commit_window_blocks > 1:
            probe = adaptive.probe_backend(cfg.sync.adaptive_d2d_margin, dev)
            extra["probe"] = {"device_ok": probe.device_ok,
                              "d2d_bytes_per_s": probe.d2d_bytes_per_s,
                              "memcpy_bytes_per_s": probe.memcpy_bytes_per_s}
        measure(name, run, blocks=len(blocks),
                txs=sum(len(b.body.transactions) for b in blocks), **extra)
    return 0


if __name__ == "__main__":
    sys.exit(main())
