#!/usr/bin/env python3
"""Drive the khipu_tpu_torch port on one NVIDIA card and check it.

    python3 chip_smoke.py [--seed N]

Builds kernels K1r (the Keccak sponge over a ragged batch, the pad in
registers; row mode and column mode), K1f (rows of one length, the pad
fused), K5 (the level-ordered fixpoint: substitute and hash every staged
node once, all levels in one launch), K3 (mirror hash), K4 (mirror
verify) and K6 (the execute stage's row validation: nonce equal, balance
>= upfront cost) from the repository's CUDA sources, holds each against
its plain PyTorch version on the card, then drives the port through the
entry points a user calls:

  1. build every kernel with nvcc, one process per source, while two
     threads build the host library (native Keccak, secp256k1, the EVM
     core and the append-log store) with g++ and the RLP extension with
     gcc
  1b. native_host: ``khipu_evm_test_arith`` on 10,000 seeded triples per
     arithmetic opcode against the Python DataWord ops, and the C RLP
     codec against ``_py_rlp_*`` on 20,000 seeded items and on malformed
     inputs (RLPError from both), exact; base.rlp's names must be the
     extension's; the compile log's host build times
  2. K1r in each mode vs its plain version (``absorb_ragged``) and the
     scalar oracle: the pad's and rate classes' edges, a 5,000-row mixed
     batch with 2,048 B rows (and ``keccak256_batch`` on it in input
     order), 1,048,576 x 576 B (also vs K1f); timed at 1M x 576 beside
     K1f, and at fast sync's 100-row batches (1, 4, 16 and mixed 1/4
     rate blocks) in both modes beside the design it replaced (one
     row-mode launch per rate class after host padding): kernel-only
     from the profiler and launch-inclusive from CUDA events
  2b. K1f (``keccak256_device_fixed``) vs K1r over the same 1,048,576 x
     576 B rows, and vs the plain version (and the scalar oracle on
     sampled rows) at the pad's edge lengths
  3. K5 vs its plain version on the card: ``fused_submit`` of a
     6-root session (children with several parents) with a
     resolved-input (ext) tile and mirror admit rows, against
     ``resolve_levels_plain`` and the level loop's digests
  4. mainnet genesis (8,893 accounts): ``bulk_build(fused=True)`` root
     equals geth's
  5. a fresh 100,000-account state trie: ``bulk_build(fused=True)``
     equals the level loop with the plain hasher (root and node dict)
  6. a window of 16 blocks x 400 account writes in one ``DeferredMPT``
     session, ``finalize(fused=True)``: every per-block root and the
     persisted node set equal the level loop with the plain hasher
  7. launch counts of phases 4-6 (K5 three times, K1r never), K5 timed
     at the 100k trie's and the window's shapes beside its plain
     version and K1r's row mode run over every row once per level (the
     design K5 replaced); K5 also held against its plain version at the
     sharded fixpoint's per-level shape (each level in two shares, then
     whole) and timed a launch a level
  8. mirror_verify (BASELINE config #5 on one card): 10,485,760 x 576 B
     nodes generated on the card, claims by K1f, ``admit_packed(...,
     exact=True)``, ``verify()`` == 0 and exactly 1 for each negative
     control; K3 and K4 vs their plain versions, timed
  9. fast_sync: ``StateSyncer`` downloads the 100,000-account state with
     1,000 contracts (storage trie + 2,048 B code each) into fresh
     ``Storages`` with a ``DeviceNodeMirror``, one corrupt delivery
     retried; stores byte-equal, mirror verify 0, nothing unreachable;
     K1r launched once per content check (``fastsync.verify`` span)
 10. window_admit: phase 6's window through ``fused_submit(admit_live=)``,
     its admit tiles landed with ``admit_device`` and ``rekey``ed;
     ``verify()`` == 0 and ``spill_rows`` equal the persisted nodes
 10b. k6: K6 vs its plain version (``fused.exec_validate_plain``), byte
     for byte, on edge rows (nonce 2^64-1, balance == upfront, rows that
     differ only in the last or the first limb, all-zero rows, balance
     2^256-1) and at 8, 200, 4,096 and 1,048,576 seeded rows; timed
     beside the plain version and the bound (81 B a row, or the launch
     floor measured here)

 11. replay_block1: the mainnet genesis loaded on the card
     (``load_genesis(on_device=True)``, K1r once a trie level), then
     mainnet block 1 through ``ReplayDriver(device_commit=True)``: the
     root must be the sealed header's, the miner must hold 5 ETH
 12. replay_transfers: 32 blocks of one value transfer each, built by
     ``ChainBuilder`` on the host, round-tripped through wire RLP and
     replayed on the card
 13. replay_erc20: a deploy block, then 16 blocks of 200 ERC-20
     ``transfer(to, amount)`` calls (200 senders, 256 holders), built and
     replayed as in 12; K1r then held against its plain version in both
     modes on every 12th batch the replay's trie commits hashed, and
     timed over all of them

 13b. replay_prebyz_optimistic: 16 blocks of 50 contended transfers
     (a fifth paying 4 hot recipients) under a schedule with every fork
     through Spurious Dragon at genesis and Byzantium unscheduled, at
     ``parallel_tx=True``: the optimistic executor (the exec pool, the
     serial merge and its re-executions, > 0 required); stores and the
     intermediate-root receipts equal the host-built serial chain's

The replays 11-13 run serially (``parallel_tx=False``), one block a
commit (``commit_window_blocks=1``), senders recovered by the prefetch
thread with each block's signing hashes in one K1r launch. Every block
passes ``save_block``'s root check; 12 and 13 also hold the final root,
the three node stores and every block's receipts to the host-built
chain's. Each replay line gives blocks/s, tx/s, the driver's phase split
and K1r's launches a block, the trie commits' and the senders' apart.

 14. replay_transfers_w16: 12's chain through the windowed, pipelined
     replay at ``commit_window_blocks=16``
 15. replay_erc20_w8: 13's chain at ``commit_window_blocks=8``
 16. replay_erc20_100k_w8: a deploy and 16 blocks of 200 ERC-20
     transfers over a genesis with 100,000 more accounts, window 8

14-16 run ``ReplayDriver(device_commit=True)`` with every other sync
setting at its default (pipeline depth 2, the device mirror commit, the
journal; the adaptive controller is off by default in the port): each
window resolves in one K5 launch, its roots are checked by a 32 B a block fetch, its live nodes
are admitted to the device mirror and spilled by the stage threads.
Each is held against the port's own windowed replay of the same chain
on the CPU (the plain K5 and mirror): the nodes reachable from the head
root byte-equal, receipts equal, ``verify_reachable`` with hashes 0
missing and 0 corrupt, mirror verify (K4) 0, no collector death, no
journal intent pending, no window hashed on the host, K5 launches equal
to the windows and K1r launches equal to the sender batches (no trie
commit launches K1r). A failed K5 build or launch stops the replay. The
first windowed replay in the process pays one-time costs, so 14 runs
twice and reports both. K5 is then held against its plain version at
every recorded window's shape and timed there.

 17. replay_erc20_par_w8: 15's chain at ``parallel_tx=True`` (the
     scheduled executor: residue, checked calls, the trusted vectorized
     call lane), window 8: nodes equal the CPU serial windowed replay's,
     lanes equal the port's CPU parallel replay's
 18. replay_erc20_100k_par_w8: 16's chain the same way
 19. replay_transfers_par_w16: 16 blocks of 200 transfers (200 senders,
     a fifth paying 4 hot recipients, the rest fresh addresses) through
     the vectorized transfer lane with ``exec_device=True`` and the
     adaptive probe off (its verdict, unstable on this card, is printed
     on a line of its own, ``exec_probe``): K6 launched once for every
     fast or call batch the replay ran; nodes, receipts and lanes equal
     the CPU replay's with ``exec_device`` off

16b. traced_replay_erc20_w8: 15's chain again with the observability
     plane on (``ObservabilityConfig(enabled=True, ledger_enabled=True,
     journey_enabled=True)``): 15's gates and its chain, block by block;
     every block's lifecycle complete with ``window.pack`` and
     ``fused.dispatch``, the four stage spans on their stage threads
     under their window's ``window.seal``, no nesting violation; the
     ledger's ``seal.upload`` bytes equal to the tensors the seal stage
     uploaded and its ``mirror.get`` bytes to the reads, both counted
     apart; a window report for every block; every transaction's journey
     ingress -> seal -> journal.intent -> durable; the Chrome trace read
     back with one flow pair a stage span; a verdict for every seal
     sub-phase of every window. The line gives traced over untraced
     blocks/s (not gated) and the cost model's floors, calibrated here:
     the median blocking 32 B device-to-host round trip, the pinned
     host-to-device rate at the largest window upload, K1f's kernel-only
     hash rate at 1M x 576 (phase 2) and the op rate of the bounds

17-19 give their lanes (residue, checked and vectorized calls,
vectorized transfers, conflicts, mispredictions) beside the serial
execution lines of the same process. Each process-global template
learner is reset before every replay.

Every replay runs its EVM frames on the native core and its line gives
``native_frames`` / ``python_frames`` (python 0; native > 0 where
transactions run frames). Two Python-VM oracles rerun a chain with every
frame on ``evm/vm.py`` (``set_backend("python")``):
``replay_erc20_python_vm`` after 13 (every block's root, receipts and
the three node stores equal the native run's) and
``replay_erc20_w8_python_vm`` after 16 (roots, receipts and reachable
nodes equal 15's); each line gives the native run's blocks/s and
execute phase beside its own. ``replay_erc20_w8_durable`` then replays
15's chain into ``Storages("native", <tmpdir>)``, stops it and opens a
fresh ``Storages`` on the same directory: the reachable nodes, every
header, body and receipt, the best block and an empty journal must
match the memory engine's run, with 15's gates (mirror verify 0 among
them) on the run itself.

Then crash recovery, the chain switch and the seal check:

 20. ethash_block1: the epoch-0 Ethash cache at its spec size
     (16,776,896 B, on the host, as in the JAX package), and mainnet
     block 1 validated against the mainnet genesis header with
     ``BlockHeaderValidator(seal_check=...)`` (``check_pow`` at the
     epoch's dataset size); nonce + 1 and one flipped mix byte must be
     refused
 21. recover_erc20_w8: 15's chain at window 8 with
     ``degrade_on_collector_death=False``, once per recovery branch of
     its path (``collector.seal``, ``fused.collect``,
     ``storage.block.put``, ``collector.save``, ``collector.commit``;
     the CPU tests kill every seam), a ``die`` rule killing the second
     window; a fresh driver's ``recover()`` then settles the
     journal (nothing pending, best on a window's top at or below the
     dead window's; a torn block, whole blocks or a missing commit mark
     repaired as ``RECOVER_SEAMS`` expects) and the replay resumes on
     the card from best + 1:
     roots, receipts and reachable nodes equal 15's run, mirror verify
     0, K5 = the resumed replay's device windows, 0 host windows. One
     more run at the default degrade setting finishes with the same gates
 22. recover_durable: the same chain into ``Storages("native", tmp)``, a
     ``die`` at ``collector.save`` in the second window, then ``stop()``,
     a fresh ``Storages`` and ``Blockchain`` on the directory, recover
     and resume: nodes, headers, bodies, receipts and best block equal
     the memory run's, mirror verify 0
 23. reorg_erc20: 15's chain replayed windowed on the card, then a
     ``ReorgManager`` switch to a heavier branch
     (``workloads.erc20_fork_chain``: 200 transfers a block, shifted
     amounts, another miner) at depth 2 (a 3-block branch, adopted block
     by block: K1r) and depth 8 (a 12-block branch, adopted windowed:
     K5 = its device windows); roots, receipts and reachable nodes equal
     the host-built fork's, the orphaned-only transactions recycled into
     the pool as in the port's CPU run of the same switch. The ancestor
     lies inside a committed window, so the switch first rebuilds its
     state. Then one kill at each of ``reorg.intent``,
     ``reorg.rollback``, ``reorg.adopt`` and ``reorg.finalize`` on the
     depth-8 switch, ``recover(config=...)``: each lands bit-exact on
     exactly the old chain or exactly the new one

Then the Kesque segment engine (the log-structured store) under the
windowed replay:

 24. replay_erc20_w8_kesque: 15's chain at window 8 into
     ``Storages("kesque", <tmpdir>)`` with 15's gates (roots, receipts
     and reachable nodes equal the memory run's, K5 = windows, 0 host
     windows, mirror verify 0); the persist stage's bytes/s beside the
     memory and native engines' of the same process, bytes on disk,
     segments, the read amplification of 10,000 seeded point reads; then
     stopped and reopened twice, with its sidecar indexes (a fast open,
     nothing repaired) and with every ``.kidx`` deleted (every index
     rebuilt from its segments), each reading back byte-equal
 25. recover_kesque: the same chain killed in its second window at
     ``kesque.append`` (the persist stage's account spill, a frame torn
     mid-write), ``kesque.roll`` (at 16 KiB segments, so that a window
     rolls) and ``kesque.index`` (a checkpoint once window 1 is saved);
     the files closed unflushed, reopened in a new ``Storages``,
     recovered (a ``storage:`` line for every torn tail) and resumed on
     the card: roots, receipts and nodes equal the uninterrupted run's
 26. compact_kesque: 24's store compacted to its head root while four
     reader threads read every reachable node: every read equal, bytes
     reclaimed, the state complete after compaction and after a reopen;
     a ``kesque.compact`` raise first leaves the store readable
 27. segment_ingest_100k: phase 9's snapshot (139,802 nodes) appended
     into a kesque source at 128 KiB segments and streamed by
     ``segment_snapshot_ingest`` (4 workers, 1 MiB chunks, the
     hash-verified walk from its root) into a fresh kesque store:
     records = nodes, nothing corrupt or missing; a chunk with one
     flipped byte lands no record; the admission hash timed on one
     thread and on four

Then the node on the network and behind its RPC front:

 28. live_sync_erc20_100k: a fresh node over RLPx from three loopback
     port nodes serving 16's chain (``live_sync_phase``)
 29. serve_erc20_100k_w8: a ``ServiceBoard`` at 16's genesis serving
     JSON-RPC (the serving plane's read view and admission) while
     ``ReplayDriver(device_commit=True, read_view=...)`` imports 16's
     chain and two blocks of a Transfer-event token at window 8, one
     read replica tailing it, under MIXED load 2 x 200 and 4 x 250 at
     open-loop rates that span the import's windows, 16 x 75 closed-loop
     in process and READ_ONLY 4 x 50 over HTTP, then a depth-2
     switch that a log filter must see retracted and the replica must
     mirror (``serve_phase``). Gates: every root on both nodes, 0
     checker violations and errors with exact request counts, step B
     mid-import, a window retired while step A or B ran, the read
     view's published = retired = blocks and 0 invalidated before the
     switch, the SLO's bad = sheds, K5 = windows,
     mirror verify 0, the replica's head and state equal the primary's,
     every retracted log returned with ``removed: true``

Then the bridge and the sharded node-cache cluster:

 30. bridge_cluster_100k_w8 (``bridge_cluster_phase``): a primary
     ``ServiceBoard`` (memory, window 8) at 16's genesis runs
     ``start_bridge()`` (its commits on the card) and a ``BridgeClient`` sends
     16's chain in ``ExecuteBlocks`` batches of 8: every answered root
     the header's, K5 = the windows (one a batch), K1r = the sender
     batches, the primary's reachable nodes equal 16's CPU windowed
     import's. Two more boards execute 13's first 8 blocks over their bridges at
     once, one batch each (both sets of roots, K5 2). Three kesque
     shard boards take the primary's state through
     ``ShardedNodeClient.replicate`` (replication 2, 64 vnodes); a reader
     board's ``start_cluster`` fetches every node in batches of 2,048
     (byte-equal, none missing) and walks 500 accounts through
     ``RemoteReadThroughNodeStorage``; midway one shard stops and the
     health prober drops it within ``down_after`` probes. ``join_shard``
     of a fourth kesque shard (the segment ship), then ``retire_shard``
     of an original: the epoch one up each time, the moved copies 1/N
     of the cluster's, every node bit-exact after, the joiner serving
     its share to a direct call. A ``ClusterTelemetry`` scrape (one
     family set a live shard, the stopped shard's health under the
     threshold) and a merged Chrome trace under ``chiprun_out/`` (every
     linked ``bridge.serve.*`` inside its ``bridge.call``)

Then the multi-card path:

 31. parallel_mesh (``parallel_mesh_phase``): ``torchrun --standalone
     -m khipu_tpu_torch.parallel`` as a subprocess, so this process's
     context carries no process group: world 1 over NCCL at full width
     (BASELINE #5's 10,485,760 x 576 B rows: ``keccak256_fixed_sharded``,
     ``hash_level_all_gather`` equal to the one-card K1f,
     ``snapshot_verify_sharded`` 0 and 1 with a byte flipped; #3's
     100,000 accounts through ``bulk_build(hasher=sharded_hasher(mesh))``
     equal to the one-card ``bulk_build(fused=True)``;
     ``fused_resolve_sharded`` on the dry run's session, the bulk's
     placeholder DAG and a 16 x 400 window equal to ``fused_resolve``),
     then world 2 as two gloo ranks sharing the card (1,048,576 rows,
     10,000 accounts, the same window): the rows and the window equal
     to world 1's, and K5 once a level at world 1. The dry run's own
     gates, on every rank (``check_records``): every rank's results
     equal, K1f once a sharded hash a rank, K1r once a hasher call, K5
     once a level a rank's share reaches, one all_gather a hash, a
     hasher call and a level, one all_reduce a verify

After phases 9 and 10, K3 and K4 are held against their plain versions
on every class of that phase's mirror, whole (the padded generic
classes the paths gave them), with the negative controls in each class.

Launch counts are zeroed just before each driven path (4-6, 8, 9, 10,
each genesis load and replay of 11-19 and 24, and each killed run,
resume, mirror verify and switch of 21-23 and 25, and 28-30; 31's ranks
zero their own before each step and report them) and read just after
it; 26 and 27 run on the host and launch nothing. Every comparison is exact (bytes). Each phase
prints one JSON line; the first line is the card's name and power limit from nvidia-smi, the line
before the last lists the kernels, and the last line is the result. Any
failure exits non-zero before the result line; without a card the
script exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.abspath(__file__))
GENESIS_ROOT = "d7f8974fb5ac78d9ac099b9ad5018bedc2ce0a72dad1827a1709da30580f0544"
# rate-class edges: 0..5 rate blocks and 16 (a 2,048 B code blob), both
# sides of each boundary
K1R_EDGES = (0, 1, 31, 32, 135, 136, 137, 271, 272, 407, 408, 543, 544,
             576, 2048)
# fast sync's batches: 100 rows of leaves (1 rate block), full branches
# (4), code blobs (16), and leaves and branches mixed
BATCH100 = {"100x1": [1] * 100, "100x4": [4] * 100, "100x16": [16] * 100,
            "100x1+4": [1, 4] * 50}

# Bounds (the least time the card could take for the same work), from the
# H100 SXM's published figures at its 700 W limit:
H100_BYTES_PER_S = 3.35e12  # HBM3
# INT32 lanes: 64 per SM (Hopper architecture white paper) x 132 SMs x the
# 1.98 GHz boost clock. Logic ops and funnel shifts issue on these lanes.
H100_INT32_OPS_PER_S = 64 * 132 * 1.98e9
# 32-bit integer operations of one Keccak-f[1600] with three-input LOP3
# folding: theta 80 (column parities 20, D rotations 10, state update
# 50), rho 48 funnel shifts, chi 50 LOP3s, iota 2 -> 180 per round, 24
# rounds; absorbing a 136-byte block adds 34 XORs.
SPONGE_OPS_PER_BLOCK = 180 * 24 + 34
# The latency floor of one permutation, which a batch too small to fill
# the card cannot go under: each round's dependent chain is 7 integer
# operations (theta's parity in 2 LOP3s, its D as a funnel shift and an
# XOR, the XOR into the lane, rho's funnel shift, chi's LOP3; iota folds
# into the next), at 4 cycles each before a result can be used (an
# assumed Hopper ALU latency, not measured here), at 1.98 GHz.
PERM_CHAIN_S = 24 * 7 * 4 / 1.98e9
K1F_EDGES = (0, 1, 20, 32, 135, 136, 137, 271, 272)
# k1r_replay_batches holds K1r against its plain version on every 12th
# of the ERC-20 commits' batches (15 of 180), cut from all of them to
# pay for parallel_mesh; every batch is still timed
K1R_HOLD_EVERY = 12


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also gives the seconds since the
    script started (``t_s``)."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - _T0}
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def check(cond, what: str) -> None:
    if not cond:
        raise AssertionError(what)


@contextmanager
def span_totals():
    """Record every thread's spans on the process tracer for the block;
    the yielded dict then holds ``{name: [count, seconds]}``. Fails if
    the ring dropped a span (the totals would be short)."""
    from khipu_tpu_torch.observability.trace import tracer

    tracer.reset()
    tracer.enable(capacity=1 << 20)
    totals = {}
    try:
        yield totals
    finally:
        tracer.disable()
    check(tracer.dropped == 0, f"the span ring dropped {tracer.dropped}")
    for s in tracer.snapshot():
        tot = totals.setdefault(s.name, [0, 0.0])
        tot[0] += 1
        tot[1] += s.duration
    tracer.reset()


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` runs, after one warm-up,
    timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_median(torch, fn, reps: int, warmup: bool = True) -> float:
    """Median milliseconds of ``reps`` single runs of ``fn``, each timed
    with its own pair of CUDA events; after one warm-up unless told
    otherwise (the plain versions at full size, where a second run would
    double the cost)."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def timed_once(torch, fn) -> tuple:
    """(``fn()``, its milliseconds) from one run between CUDA events, no
    warm-up: the plain versions whose result is compared anyway and whose
    further runs would be this script's cost."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def sponge_bound_ms(n_rows: int, nblocks: int, bytes_moved: int) -> tuple:
    """The least time for ``n_rows`` sponges of ``nblocks`` rate blocks
    that read and write ``bytes_moved`` bytes in all."""
    ops_s = n_rows * nblocks * SPONGE_OPS_PER_BLOCK / H100_INT32_OPS_PER_S
    bytes_s = bytes_moved / H100_BYTES_PER_S
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s >= bytes_s else "bytes")


def kernel_us(torch, fn, reps: int, match: str) -> tuple:
    """(launches per run, mean device microseconds per launch) of the
    kernels whose name holds ``match``, over ``reps`` runs of ``fn``
    under ``torch.profiler`` after one warm-up run: the kernels' own
    durations, without the host's launch gaps."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if match in e.key]
    count = sum(e.count for e in events)
    check(count > 0, f"no kernel named *{match}* in the profile")
    return count // reps, sum(e.self_device_time_total for e in events) / count


def ptxas_by_kernel(log) -> dict:
    """Kernel name -> its registers and spills, from ``-Xptxas -v``."""
    import re

    out, name = {}, None
    for line in (ln for entry in log for ln in entry.splitlines()):
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            found = re.search(r"\d((?:keccak|mirror|fixpoint)\w*?_kernel)",
                              mangled)
            name = found.group(1) if found else mangled
            if "ILb1E" in mangled:
                name += "<words>"
            elif "ILb0E" in mangled:
                name += "<bytes>"
        elif name and ("spill" in line or "registers" in line):
            out[name] = f"{out.get(name, '')} {line.split(':', 1)[-1].strip()}".strip()
    return out


def per_class_rows(torch, np, build, keccak_torch, msgs, dev) -> list:
    """The design K1r replaced, for timing it: bucket by rate class, pad
    each class on the host, then per class one upload (header and padded
    rows together), one K1r row-mode launch (reading each row's message
    bytes, as K1 read the padded row) and one copy back. Returns the
    digests in input order."""
    buckets = {}
    for i, m in enumerate(msgs):
        buckets.setdefault(len(m) // 136 + 1, []).append(i)
    out = [b""] * len(msgs)
    lib = build.load()
    for nb, idxs in sorted(buckets.items()):
        group = [msgs[i] for i in idxs]
        k, width = len(group), nb * 136
        rows = keccak_torch.pad_to_words(group, nb).view(np.uint8)
        header = np.concatenate([np.arange(k, dtype=np.int32) * width,
                                 np.fromiter(map(len, group), np.int32, k)])
        staged = torch.from_numpy(np.concatenate(
            [header.view(np.uint8), rows.reshape(-1)])).to(dev)
        got = torch.empty((k, 32), dtype=torch.uint8, device=dev)
        dev_index, stream = build.launch_args(staged)
        rc = lib.khipu_keccak256_ragged(staged.data_ptr() + 8 * k,
                                        staged.data_ptr(), got.data_ptr(), k,
                                        0, dev_index, stream)
        check(rc == 0, f"K1r launch failed: cudaError {rc}")
        raw = got.cpu().numpy().tobytes()
        for j, i in enumerate(idxs):
            out[i] = raw[32 * j : 32 * j + 32]
    return out


def hold_class(torch, device_mirror, mirror_cuda, cm, ncols, rng) -> tuple:
    """K3 and K4 against their plain versions on the first ``ncols``
    columns of one mirror class (the whole class where ``ncols`` is
    None), at the class's own shape: padded rows of a generic class, or
    unpadded rows with the pad fused for an exact class. K3's digests
    must equal the plain version's and the class's claims; K4 must count
    0 on the claims and exactly 5 with one word of 5 claims bent, as the
    plain version does. Returns the worst absolute difference of each."""
    n = cm.capacity if ncols is None else min(ncols, cm.capacity)
    label = f"class (nblocks {cm.nblocks}, exact_len {cm.exact_len})"
    sub, csub = cm.resident[:, :n], cm.claimed[:, :n]
    got = torch.empty((8, n), dtype=torch.int32, device=sub.device)
    mirror_cuda.hash_planes(sub, cm.nblocks, cm.nwords, got)
    plain = device_mirror.hash_planes_plain(sub, cm.nblocks, cm.exact_len)
    torch.cuda.synchronize()
    k3_err = int((got.long() - plain.long()).abs().max())
    check(k3_err == 0 and torch.equal(got, plain), f"K3 != plain, {label}")
    check(torch.equal(got, csub), f"K3 digests != the claims, {label}")
    bent = csub.clone()
    bent[rng.integers(0, 8, 5), rng.choice(n, 5, replace=False)] ^= 1
    k4 = [int(mirror_cuda.verify_planes(sub, c, cm.nblocks, cm.nwords).item())
          for c in (csub, bent)]
    p4 = [device_mirror.verify_planes_plain(sub, c, cm.nblocks, cm.exact_len)
          for c in (csub, bent)]
    check(k4 == p4 == [0, 5], f"K4 {k4} != plain {p4}, {label}")
    return k3_err, max(abs(a - b) for a, b in zip(k4, p4))


def negative_controls(mirror, cm, col: int) -> list:
    """``mirror.verify()`` with one claim word of column ``col`` of class
    ``cm`` raised by 1, with one resident word of that column flipped,
    and with both restored: must give [1, 1, 0]."""
    cm.claimed[2, col] += 1
    raised = mirror.verify()
    cm.claimed[2, col] -= 1
    cm.resident[17, col] ^= 0x10
    flipped = mirror.verify()
    cm.resident[17, col] ^= 0x10
    got = [raised, flipped, mirror.verify()]
    check(got == [1, 1, 0], f"negative controls gave {got} in class "
          f"(nblocks {cm.nblocks}, exact_len {cm.exact_len})")
    return got


def hold_mirror(torch, device_mirror, mirror_cuda, mirror, rng) -> dict:
    """``hold_class`` on every class of ``mirror``, whole, and the
    negative controls on a resident row of each. Returns the worst
    errors and each class's controls."""
    errs, controls = [(0, 0)], {}
    for (nb, exact), cm in sorted(mirror._classes.items(),
                                  key=lambda kv: (kv[0][0], kv[0][1] or 0)):
        errs.append(hold_class(torch, device_mirror, mirror_cuda, cm, None,
                               rng))
        col = min(cm.rows.values()) if cm.rows else 0
        controls[f"{nb}/{exact}"] = negative_controls(mirror, cm, col)
    return {"k3_err": max(e[0] for e in errs),
            "k4_err": max(e[1] for e in errs), "controls": controls}


class Launches:
    """The kernels' launch counters: zeroed just before a driven path,
    read just after it."""

    def __init__(self, keccak_cuda, fixpoint_cuda, mirror_cuda,
                 exec_validate_cuda):
        self.fields = (
            ("k1r", keccak_cuda, "RAGGED_LAUNCHES"),
            ("k1f", keccak_cuda, "FIXED_LAUNCHES"),
            ("k5", fixpoint_cuda, "LAUNCHES"),
            ("k3", mirror_cuda, "HASH_LAUNCHES"),
            ("k4", mirror_cuda, "VERIFY_LAUNCHES"),
            ("k6", exec_validate_cuda, "LAUNCHES"),
        )
        self.total = {name: 0 for name, _, _ in self.fields}

    def zero(self) -> None:
        for _, mod, attr in self.fields:
            setattr(mod, attr, 0)

    def read(self, path: str, required) -> dict:
        """This path's counts; each kernel in ``required`` must have
        launched. The counts add to the main paths' totals."""
        got = {name: getattr(mod, attr) for name, mod, attr in self.fields}
        for name in required:
            check(got[name] > 0, f"{name} was not launched on the {path} path")
        for name, n in got.items():
            self.total[name] += n
        return got


NATIVE_ARITH_OPS = ("add", "sub", "mul", "div", "mod", "sdiv", "smod",
                    "exp", "addmod", "mulmod", "signextend", "byte", "shl",
                    "shr", "sar")  # khipu_evm_test_arith's op codes 0..14
RLP_BAD_INPUTS = (b"", b"\x81\x01", b"\x81", b"\xb8\x01a", b"\xb8",
                  b"\xb9\x00\x40" + b"a" * 64, b"\xc1", b"\xc2\x83ab",
                  b"\xf8\x01\x01", b"\x01\x02", b"\xc0\x00",
                  b"\xbf" + b"\xff" * 8)


def edge_words(rng, n: int) -> list:
    """``n`` seeded 256-bit words biased to the edges: random, 64-bit,
    8-bit, near the top, a power of two, a run of ones."""
    mask = (1 << 256) - 1
    kind = rng.integers(6, size=n)
    raw = rng.bytes(32 * n)
    small = rng.integers(256, size=n)
    bits = rng.integers(1, 257, size=n)
    out = []
    for i in range(n):
        k, sm = int(kind[i]), int(small[i])
        out.append(int.from_bytes(raw[32 * i:32 * i + (32 if k == 0 else 8)],
                                  "big") if k < 2 else
                   sm if k == 2 else mask - sm if k == 3 else
                   1 << sm if k == 4 else (1 << int(bits[i])) - 1)
    return out


def rlp_item(rng, depth: int = 0):
    """A seeded RLP item: byte strings at the headers' edges, or a list
    (nested a few levels) of items."""
    if depth < 4 and rng.random() < 0.35:
        return [rlp_item(rng, depth + 1)
                for _ in range(int(rng.integers(0, 7)))]
    n = int(rng.choice([0, 1, 1, 2, 31, 32, 55, 56, 57, 200, 255, 256, 1100]))
    if n == 1 and rng.random() < 0.5:
        return bytes([int(rng.integers(0x80))])  # a byte that is itself
    return rng.bytes(n)


def native_host_phase(np, rng, triples: int, items: int) -> dict:
    """The native host closure on the card's host, against its oracles:
    the EVM core's u256 arithmetic (``khipu_evm_test_arith``) against the
    Python DataWord ops on ``triples`` seeded triples an opcode, and the
    C RLP codec against the pure-Python one on ``items`` seeded items
    (byte-equal) and on malformed inputs (RLPError from both). base.rlp's
    names, and those of a module that imported them by value, must be
    the extension's. Every comparison is exact."""
    from khipu_tpu_torch.base import rlp
    from khipu_tpu_torch.evm import dataword as dw
    from khipu_tpu_torch.evm import native_vm
    from khipu_tpu_torch.native.build import load_rlp_ext
    from khipu_tpu_torch.trie import deferred

    py_ops = (
        lambda a, b, c: (a + b) % dw.MOD, lambda a, b, c: (a - b) % dw.MOD,
        lambda a, b, c: (a * b) % dw.MOD,
        lambda a, b, c: a // b if b else 0, lambda a, b, c: a % b if b else 0,
        lambda a, b, c: dw.sdiv(a, b), lambda a, b, c: dw.smod(a, b),
        lambda a, b, c: pow(a, b, dw.MOD),
        lambda a, b, c: (a + b) % c if c else 0,
        lambda a, b, c: (a * b) % c if c else 0,
        lambda a, b, c: dw.signextend(a, b), lambda a, b, c: dw.byte_at(a, b),
        lambda a, b, c: (b << a) % dw.MOD if a < 256 else 0,
        lambda a, b, c: b >> a if a < 256 else 0,
        lambda a, b, c: dw.sar(a if a < 256 else 256, b),
    )
    t0 = time.perf_counter()
    for op, (name, fn) in enumerate(zip(NATIVE_ARITH_OPS, py_ops)):
        words = edge_words(rng, 3 * triples)
        for i in range(0, 3 * triples, 3):
            a, b, c = words[i:i + 3]
            check(native_vm.test_arith(op, a, b, c) == fn(a, b, c),
                  f"khipu_evm_test_arith {name} != DataWord: "
                  f"a={a:x} b={b:x} c={c:x}")
    arith_s = time.perf_counter() - t0

    def timed(fn, data):
        """``fn`` over ``data`` and its seconds, with the cyclic garbage
        collector off (a collection of this phase's live lists would
        otherwise land in whichever loop allocates next)."""
        gc.collect()
        gc.disable()
        try:
            t = time.perf_counter()
            out = [fn(x) for x in data]
            return out, time.perf_counter() - t
        finally:
            gc.enable()

    ext = load_rlp_ext()
    corpus = [rlp_item(rng) for _ in range(items)]
    enc_c, c_encode_s = timed(rlp.rlp_encode, corpus)
    enc_py, py_encode_s = timed(rlp._py_rlp_encode, corpus)
    check(enc_c == enc_py, "the C RLP encoder != _py_rlp_encode")
    dec_c, c_decode_s = timed(rlp.rlp_decode, enc_c)
    dec_py, py_decode_s = timed(rlp._py_rlp_decode, enc_c)
    check(dec_c == dec_py == corpus, "the C RLP decoder != _py_rlp_decode")
    for bad in RLP_BAD_INPUTS:
        for decode in (rlp.rlp_decode, rlp._py_rlp_decode):
            try:
                decode(bad)
            except rlp.RLPError:
                continue
            raise AssertionError(f"{bad.hex()} decoded without RLPError")
    check(rlp.rlp_encode is ext.encode and rlp.rlp_decode is ext.decode
          and deferred.rlp_encode is ext.encode
          and deferred.rlp_decode is ext.decode,
          "base.rlp's names do not reach the C extension")
    return {"phase": "native_host", "arith_ops": len(py_ops),
            "arith_triples_per_op": triples, "arith_seconds": arith_s,
            "rlp_items": items, "rlp_bytes": sum(map(len, enc_c)),
            "rlp_error_inputs": len(RLP_BAD_INPUTS),
            "rlp_extension": os.path.basename(ext.__file__),
            "host_codec_s": {"c_encode": c_encode_s, "py_encode": py_encode_s,
                             "c_decode": c_decode_s, "py_decode": py_decode_s},
            "host_codec_speedup": {"encode": py_encode_s / c_encode_s,
                                   "decode": py_decode_s / c_decode_s}}


NODE_STORES = ("account_node_storage", "storage_node_storage",
               "evmcode_storage")


@contextmanager
def vm_frames(backend=None):
    """Run every VM frame on ``backend`` (None: the native core, the
    default; "python": the Python VM) and count the frames each backend
    ran into the dict it yields; no frame may run on the other one."""
    from khipu_tpu_torch.evm import dispatch

    before, frames = dict(dispatch.VM_GAUGES), {}
    dispatch.set_backend(backend)
    try:
        yield frames
    finally:
        dispatch.set_backend(None)
    frames.update({k: dispatch.VM_GAUGES[k] - before[k] for k in before},
                  vm_backend=backend or "native")
    other = "native_frames" if backend == "python" else "python_frames"
    check(frames[other] == 0, f"{frames[other]} frames ran on the other VM "
          f"than {frames['vm_backend']}")


def same_chain(a, b, n: int, what: str) -> None:
    """Two replays of one chain into the memory engine: every block's
    root and receipts, and the three node stores, byte-equal."""
    for i in range(1, n + 1):
        check(a.get_header_by_number(i).state_root
              == b.get_header_by_number(i).state_root,
              f"{what}: block {i}'s root")
        check(a.storages.receipts_storage.get(i)
              == b.storages.receipts_storage.get(i),
              f"{what}: block {i}'s receipts")
    for store in NODE_STORES:
        check(getattr(a.storages, store).source._map
              == getattr(b.storages, store).source._map,
              f"{what}: {store} differs")


def replay_phases(args, torch, dev, launches, packed, hold_ragged) -> tuple:
    """Phases 11-13: regular-sync replay, block by block, on the card.
    Returns the largest difference of K1r from its plain version on the
    batches the ERC-20 replay's trie commits hashed, and the transfer and
    ERC-20 chains with their serial stats (``name -> (builder, spec,
    blocks, stats)``) for the windowed phases."""
    from khipu_tpu_torch import workloads
    from khipu_tpu_torch.config import KhipuConfig, SyncConfig
    from khipu_tpu_torch.domain.block import Block, BlockBody
    from khipu_tpu_torch.domain.blockchain import Blockchain
    from khipu_tpu_torch.ledger.schedule import reset_learner
    from khipu_tpu_torch.ops import keccak as keccak_ops
    from khipu_tpu_torch.ops import keccak_cuda, keccak_torch
    from khipu_tpu_torch.storage.storages import Storages
    from khipu_tpu_torch.sync import prefetch
    from khipu_tpu_torch.sync.replay import ReplayDriver

    genesis_file = os.path.join(ROOT, "tests", "fixtures",
                                "mainnet_genesis_alloc.txt.gz")
    serial, chains = {}, {}

    def replay(name, cfg, spec, blocks, source=None, backend=None, **extra):
        """Load ``spec`` on the card, replay ``blocks`` (after a wire round
        trip) with ``device_commit``, gate it and emit its line. With
        ``source`` (the host-built chain) the node stores and receipts
        must equal its own. K5 and K6 must not launch. Every frame runs on
        the native VM, or with ``backend="python"`` on the Python VM."""
        wire = [Block.decode(b.encode()) for b in blocks]
        target = Blockchain(Storages(), cfg)
        launches.zero()
        t0 = time.perf_counter()
        target.load_genesis(spec, on_device=True, device=dev)
        torch.cuda.synchronize()
        genesis_s = time.perf_counter() - t0
        genesis = launches.read(f"{name} genesis", ("k1r",))
        prefetch.flush_sender_cache()
        batches0 = prefetch.PREFETCH_GAUGES["device_batches"]
        launches.zero()
        with vm_frames(backend) as frames:
            stats = ReplayDriver(target, cfg, device_commit=True,
                                 device=dev).replay(wire)
            torch.cuda.synchronize()
        path = launches.read(name, ("k1r",))
        check(path["k5"] == path["k6"] == 0,
              f"{name}: a block-by-block replay launched K5 or K6")
        serial[name] = stats
        senders = prefetch.PREFETCH_GAUGES["device_batches"] - batches0
        with_txs = sum(1 for b in wire if b.body.transactions)
        check(senders == with_txs, f"{name}: {senders} sender batches on the "
              f"card for {with_txs} blocks with transactions")
        check(not with_txs or frames[f"{frames['vm_backend']}_frames"] > 0,
              f"{name}: no frame ran on the {frames['vm_backend']} VM")
        flush = path["k1r"] - senders
        check(flush > 0, f"{name}: no trie commit launched K1r")
        check(stats.blocks == len(wire), f"{name}: replayed {stats.blocks} "
              f"of {len(wire)} blocks")
        head = wire[-1].header
        check(target.best_block_number == head.number
              and target.get_header_by_number(head.number).state_root
              == head.state_root, f"{name}: final state root differs")
        if source is not None:
            for store in NODE_STORES:
                check(getattr(target.storages, store).source._map
                      == getattr(source.storages, store).source._map,
                      f"{name}: {store} != the host-built chain's")
            for n in range(1, head.number + 1):
                check(target.storages.receipts_storage.get(n)
                      == source.storages.receipts_storage.get(n),
                      f"{name}: block {n}'s receipts differ")
        n = stats.blocks
        emit({"phase": name, "blocks": n, "txs": stats.txs, "gas": stats.gas,
              "seconds": stats.seconds, "blocks_per_s": stats.blocks_per_s,
              "tx_per_s": stats.txs / stats.seconds,
              "phases_s": stats.phases, "genesis_accounts": len(spec.alloc),
              "genesis_seconds": genesis_s,
              "genesis_k1r_launches": genesis["k1r"],
              "k1r_launches": path["k1r"], "k1r_flush_launches": flush,
              "k1r_sender_launches": senders,
              "k1r_flush_per_block": flush / n,
              "k1r_sender_per_block": senders / n,
              "parallel_txs": stats.parallel_txs,
              "conflicts": stats.conflicts,
              "parallel_rate": stats.parallel_rate,
              "launches": path, "root": head.state_root.hex(), **frames,
              **extra})
        return target

    def record_commits(cfg, spec, blocks):
        """The message batches the driver thread hashes (the trie
        commits') in a second, untimed replay of ``blocks``: the timed
        replay carries no recorder, and these launches count nowhere."""
        target = Blockchain(Storages(), cfg)
        target.load_genesis(spec, on_device=True, device=dev)
        recorded, hash_batch = [], keccak_ops.keccak256_batch
        driver_thread = threading.get_ident()

        def recording(messages, device=None):
            if threading.get_ident() == driver_thread:
                recorded.append(list(messages))
            return hash_batch(messages, device)

        keccak_ops.keccak256_batch = recording
        try:
            ReplayDriver(target, cfg, device_commit=True, device=dev).replay(
                [Block.decode(b.encode()) for b in blocks])
        finally:
            keccak_ops.keccak256_batch = hash_batch
        return recorded

    b1_cfg = dataclasses.replace(KhipuConfig(),
                                 sync=SyncConfig(parallel_tx=False))
    header = workloads.MAINNET_BLOCK1
    b1_spec = workloads.mainnet_genesis_spec(genesis_file)
    b1 = replay("replay_block1", b1_cfg, b1_spec, [Block(header, BlockBody())])
    check(b1.get_header_by_number(0).hash == workloads.MAINNET_GENESIS_HASH,
          "genesis hash != mainnet's")
    miner = b1.get_account(header.beneficiary, header.state_root)
    check(miner.balance == 5 * 10**18, f"miner holds {miner.balance} wei")
    del b1

    replay_cfg = workloads.replay_config()
    t0 = time.perf_counter()
    builder, spec, blocks = workloads.transfer_chain(
        replay_cfg, args.transfer_blocks, 1)
    replay("replay_transfers", replay_cfg, spec, blocks, builder.blockchain,
           build_seconds=time.perf_counter() - t0)
    chains["replay_transfers"] = (builder, spec, blocks,
                                  serial["replay_transfers"])

    erc20_txs, holders = 200, 256
    t0 = time.perf_counter()
    builder, spec, blocks = workloads.erc20_chain(
        replay_cfg, args.erc20_blocks, erc20_txs, holders)
    build_s = time.perf_counter() - t0
    erc20 = replay(
        "replay_erc20", replay_cfg, spec, blocks, builder.blockchain,
        build_seconds=build_s, holders=holders,
        transfers=args.erc20_blocks * erc20_txs,
        reduced=f"{args.erc20_blocks} synthetic blocks of {erc20_txs} "
        "token transfers after a deploy block, in place of BASELINE #4's "
        "10,000 mainnet blocks (15.50M-15.51M, ~200 tx a block)")
    check(len(blocks) == args.erc20_blocks + 1 and all(
        len(b.body.transactions) == erc20_txs for b in blocks[1:]),
        "replay_erc20 is not 200 transfers a block")
    chains["replay_erc20"] = (builder, spec, blocks, serial["replay_erc20"])
    # the Python-VM oracle: the same chain with every frame on evm/vm.py
    native = serial["replay_erc20"]
    oracle = replay("replay_erc20_python_vm", replay_cfg, spec, blocks,
                    builder.blockchain, backend="python",
                    native_vm={"blocks_per_s": native.blocks_per_s,
                               "execute_s": native.phases["execute"],
                               "seconds": native.seconds})
    same_chain(erc20, oracle, len(blocks), "replay_erc20_python_vm")
    del erc20, oracle
    # K1r vs its plain version, both modes, on every K1R_HOLD_EVERY-th
    # batch of the commits (the plain version's runs are this phase's
    # cost), and K1r timed back to back over every batch
    recorded, k1r_err = record_commits(replay_cfg, spec, blocks), 0
    packs = [packed(msgs) for msgs in recorded]
    held = range(0, len(recorded), K1R_HOLD_EVERY)
    for i in held:
        msgs = recorded[i]
        k1r_err = max(k1r_err, hold_ragged(
            *packs[i], f"replay_erc20 batch {i}",
            {0: msgs[0], len(msgs) - 1: msgs[-1]}))
    rows = [len(m) for m in recorded]
    nbs = [len(m) // 136 + 1 for msgs in recorded for m in msgs]
    back_to_back_ms = cuda_ms(torch, lambda: [
        keccak_cuda.absorb_ragged(*p) for p in packs], 5)
    held_ms = cuda_ms(torch, lambda: [
        keccak_cuda.absorb_ragged(*packs[i]) for i in held], 5)
    _, plain_held_ms = timed_once(torch, lambda: [keccak_torch.absorb_ragged(
        b, torch.from_numpy(o), torch.from_numpy(ln))
        for b, o, ln in (packs[i] for i in held)])
    ops_s = sum(nbs) * SPONGE_OPS_PER_BLOCK / H100_INT32_OPS_PER_S
    bytes_s = sum(p[0].numel() + 40 * len(p[1]) for p in packs) \
        / H100_BYTES_PER_S
    emit({"phase": "k1r_replay_batches", "batches": len(recorded),
          "rows_min": min(rows), "rows_median": sorted(rows)[len(rows) // 2],
          "rows_max": max(rows), "rate_blocks": sum(nbs),
          "modes": ["row", "column"], "max_abs_err": k1r_err,
          "held_batches": len(held), "all_batches_call_ms": back_to_back_ms,
          "held_batches_call_ms": held_ms,
          "held_batches_plain_ms": plain_held_ms,
          "all_batches_bound_ms": max(ops_s, bytes_s) * 1e3,
          "bound_by": "operations" if ops_s >= bytes_s else "bytes"})

    # the optimistic executor: a pre-Byzantium contended chain
    prebyz_cfg = workloads.prebyzantium_config()
    t0 = time.perf_counter()
    builder, spec, blocks = workloads.contended_transfer_chain(
        prebyz_cfg, args.prebyz_blocks, 50)
    build_s = time.perf_counter() - t0
    reset_learner()
    replay("replay_prebyz_optimistic",
           workloads.prebyzantium_config(parallel_tx=True), spec, blocks,
           builder.blockchain, build_seconds=build_s,
           executor="optimistic: the exec pool, the serial merge and its "
           "re-executions; receipts carry intermediate roots")
    stats = serial["replay_prebyz_optimistic"]
    check(stats.conflicts > 0, "replay_prebyz_optimistic: no conflict "
          "re-executed in the merge")
    check(stats.fast_path_txs == stats.residue_txs == 0,
          "replay_prebyz_optimistic: a pre-Byzantium block was scheduled")
    check(all(isinstance(r.post_tx_state, bytes)
              for r in builder.blockchain.get_receipts(1)),
          "replay_prebyz_optimistic: receipts carry no intermediate roots")
    return k1r_err, chains


def k5_at_window(torch, dev, fused, to_resolve, prefix, ext_np, ext_pos,
                 reps: int = 20) -> dict:
    """One recorded replay window through K5 on the card beside its
    plain version at the same shape (the window's rows and its
    resolved-input tile): the digests and final encodings must be equal.
    Returns K5's CUDA-event ms (K5 rewrites the same bytes when run again
    on its own output), the plain version's, and the bound."""
    from khipu_tpu_torch.trie import fixpoint_cuda

    ext = torch.from_numpy(ext_np).to(dev)
    classes, _, total, plan = fused.pack(to_resolve, prefix, dev, ext_pos,
                                         len(ext_np))
    plain = [fused.PackedClass() for _ in classes]
    for p, c in zip(plain, classes):
        p.nb, p.keys, p.base, p.enc = c.nb, c.keys, c.base, c.enc.clone()
    digests = torch.empty((total, 32), dtype=torch.uint8, device=dev)

    def k5():
        fixpoint_cuda.resolve_levels(
            [c.enc for c in classes], [c.base for c in classes], digests,
            ext, plan.d_order, plan.d_level_ptr, plan.d_tptr, plan.d_toff,
            plan.d_tchild, plan.widest)

    k5()
    plain_g, plain_ms = timed_once(torch, lambda: fused.resolve_levels_plain(
        plain, total, ext, plan))
    err = max([int((digests.int() - plain_g.int()).abs().max())]
              + [int((c.enc.int() - p.enc.int()).abs().max())
                 for c, p in zip(classes, plain)])
    check(err == 0, "K5 != plain at a replay window's shape")
    ms = cuda_ms(torch, k5, reps)
    check(torch.equal(digests, plain_g), "K5 relaunch changed a window")
    row_blocks = sum(c.nrows * c.nb for c in classes)
    enc_bytes = sum(c.enc.numel() for c in classes)
    ops_ms = row_blocks * SPONGE_OPS_PER_BLOCK / H100_INT32_OPS_PER_S * 1e3
    # encodings read and written once, 8 index bytes a triple, 8 of order
    # and tptr a row, 32 digest bytes a row, the ext rows read
    bytes_ms = (2 * enc_bytes + 8 * plan.ntriples + 40 * total
                + ext.numel()) / H100_BYTES_PER_S * 1e3
    return {"k5_ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "rows": total, "levels": plan.nlevels, "triples": plan.ntriples,
            "ext_rows": len(ext_np), "max_abs_err": err}


# K6 edge rows: (tx nonce, account nonce, balance, upfront)
_BIG = 2**255 + 12345
K6_EDGES = (
    (2**64 - 1, 2**64 - 1, 1, 1), (2**64 - 1, 2**64 - 2, 1, 1),
    (7, 7, _BIG, _BIG),                                   # balance == upfront
    (1, 1, _BIG + 1, _BIG), (1, 1, _BIG, _BIG + 1),       # limb 7 only
    (1, 1, _BIG + 2**224, _BIG), (1, 1, _BIG, _BIG + 2**224),  # limb 0 only
    (0, 0, 0, 0),                                         # all zero
    (3, 3, 2**256 - 1, 2**256 - 1), (3, 3, 2**256 - 1, 2**256 - 2),
    (3, 3, 2**256 - 2, 2**256 - 1), (3, 3, 2**256 - 1, 0),
)
K6_SIZES = (8, 200, 4096)


def k6_phase(args, torch, np, dev, rng) -> dict:
    """K6 against its plain version (``fused.exec_validate_plain``), byte
    for byte, on the edge rows and at 8, 200, 4,096 and ``--k6-rows``
    rows of seeded random limbs (the edge rows on top; nonces equal in
    70 % of the rows, balance == upfront in 30 %, a shared prefix of
    limbs in 30 %). CUDA-event medians, the bound max(81 B a row over
    the memory rate, the launch floor), and ``fused_exec_validate``'s
    whole call (pack, upload, K6, mask back) at 200 rows. Returns the
    phase's line."""
    from khipu_tpu_torch.trie import exec_validate_cuda, fused

    def rows_of(n):
        w = rng.integers(0, 2**32, (n, 20), dtype=np.uint32)
        same_nonce = rng.random(n) < 0.7
        w[same_nonce, 2:4] = w[same_nonce, 0:2]
        pick = rng.random(n)
        equal = pick < 0.3
        w[equal, 12:20] = w[equal, 4:12]
        prefix = (pick >= 0.3) & (pick < 0.6)
        cut = rng.integers(1, 8, n)
        for j in range(8):
            share = prefix & (cut > j)
            w[share, 12 + j] = w[share, 4 + j]
        edges = fused.pack_exec_rows(*[list(c) for c in zip(*K6_EDGES)])
        k = min(n, len(edges))
        w[:k] = edges[:k]
        return torch.from_numpy(w.view(np.int32)).to(dev)

    tiny = torch.zeros(1, dtype=torch.int32, device=dev)
    floor_ms = cuda_ms_median(torch, lambda: tiny.add_(1), 101)
    err, sizes = 0, {}
    edge_rows = rows_of(len(K6_EDGES))
    for n in (len(K6_EDGES),) + K6_SIZES + (args.k6_rows,):
        rows = edge_rows if n == len(K6_EDGES) else rows_of(n)
        got = exec_validate_cuda.validate_rows(rows)
        plain = fused.exec_validate_plain(rows)
        torch.cuda.synchronize()
        err = max(err, int((got.int() - plain.int()).abs().max()))
        check(torch.equal(got, plain), f"K6 != plain at {n} rows")
        if n == len(K6_EDGES):
            want = [int(t == a and b >= u) for t, a, b, u in K6_EDGES]
            check(got.cpu().tolist() == want, "K6 != the edge rows' oracle")
            continue
        bytes_ms = 81 * n / H100_BYTES_PER_S * 1e3
        sizes[n] = {
            "ms": cuda_ms_median(torch, lambda: exec_validate_cuda.validate_rows(
                rows), 51),
            "plain_ms": cuda_ms_median(torch, lambda: fused.exec_validate_plain(
                rows), 11),
            "bytes_ms": bytes_ms, "bound_ms": max(bytes_ms, floor_ms),
            "valid": int(got.sum())}
    cols = [[int(x) for x in c] for c in zip(*[
        (i % 9, i % 9 if i % 5 else i % 7, 10**18 + i, 10**18)
        for i in range(200)])]
    fused.fused_exec_validate(*cols, device=dev)
    t0 = time.perf_counter()
    for _ in range(50):
        fused.fused_exec_validate(*cols, device=dev)
    call_ms = (time.perf_counter() - t0) / 50 * 1e3
    return {"phase": "k6", "edge_rows": len(K6_EDGES), "sizes": sizes,
            "launch_floor_ms": floor_ms, "call_ms_200": call_ms,
            "max_abs_err": err, "bound_by": "bytes"}


class _Sink:
    def __init__(self):
        self.nodes = {}

    def update(self, removes, upserts):
        self.nodes.update(upserts)


def reachable(storages, root):
    """verify_reachable's walk with hashes checked, keeping the nodes it
    reaches: (report, (account, storage, code))."""
    from khipu_tpu_torch.storage.compactor import compact

    sinks = [_Sink() for _ in range(3)]
    report = compact(storages.account_node_storage,
                     storages.storage_node_storage,
                     storages.evmcode_storage, root, *sinks,
                     verify_hashes=True)
    return report, tuple(s.nodes for s in sinks)


def windowed_phases(args, torch, dev, launches, chains,
                    k1f_hashes_per_s=None) -> tuple:
    """Phases 14-16: the windowed, pipelined replay on the card —
    ``ReplayDriver(..., device_commit=True)`` at ``commit_window_blocks``
    16 (the transfer chain) and 8 (the ERC-20 chain, and that chain over
    a genesis with 100,000 more accounts), with every other sync setting
    at its default (pipeline depth 2, the mirror commit, the journal, no
    adaptive controller). Each is held against the port's own windowed
    replay of the same chain on ``device="cpu"`` (the plain K5 and a CPU
    mirror). Returns, per phase, K5 at its windows' shapes beside its
    plain version."""
    from khipu_tpu_torch import workloads
    from khipu_tpu_torch.domain.block import Block
    from khipu_tpu_torch.domain.blockchain import Blockchain
    from khipu_tpu_torch.ledger import batch_call, batch_exec
    from khipu_tpu_torch.ledger.schedule import EXEC_GAUGES, reset_learner
    from khipu_tpu_torch.ledger.window import WINDOW_GAUGES
    from khipu_tpu_torch.storage.device_mirror import MIRROR_GAUGES
    from khipu_tpu_torch.storage.storages import Storages
    from khipu_tpu_torch.sync import prefetch
    from khipu_tpu_torch.sync.adaptive import probe_backend
    from khipu_tpu_torch.sync.replay import PIPELINE_GAUGES, ReplayDriver
    from khipu_tpu_torch.trie import deferred, fused

    def gauge_deltas(before):
        return {k: EXEC_GAUGES[k] - before[k] for k in EXEC_GAUGES
                if k != "max_batch_width"}

    def lanes(stats, gauges):
        """Where a replay's transactions ran: the scheduled executor's
        residue, checked calls and vectorized calls and transfers, and
        the optimistic merge's counts."""
        return {"residue": stats.residue_txs,
                "checked_calls": gauges["checked_call_txs"],
                "vector_calls": gauges["vector_call_txs"],
                "vector_transfers": stats.fast_path_txs
                - gauges["vector_call_txs"],
                "parallel": stats.parallel_txs, "conflicts": stats.conflicts,
                "mispredictions": stats.mispredictions,
                "fallbacks": gauges["fallbacks"],
                "batches": gauges["batches"]}

    def cpu_reference(spec, blocks, window, cfg=None):
        """The port's windowed replay on the CPU (serial execution unless
        ``cfg`` says otherwise), every window through the plain K5;
        records each window's fixpoint input. Returns the chain, the
        reachable nodes, the recorded windows, the replay's stats and
        its execute-stage gauge deltas."""
        cfg = cfg or workloads.replay_config(commit_window_blocks=window)
        target = Blockchain(Storages(), cfg)
        target.load_genesis(spec)
        recorded, submit = [], fused.fused_submit

        def recording(to_resolve, deps, prefix, device=None, depth=None,
                      ext=None, admit_live=None, span_tags=None):
            job = submit(to_resolve, deps, prefix, device, depth, ext,
                         admit_live, span_tags)
            # the window's ExtRows tile is filled by the scan
            recorded.append((to_resolve, ext.tile("cpu").numpy().copy(),
                             dict(ext.pos)))
            return job

        fused.fused_submit = recording
        reset_learner()
        gauges = dict(EXEC_GAUGES)
        try:
            stats = ReplayDriver(target, cfg, device_commit=True,
                                 device="cpu").replay(
                [Block.decode(b.encode()) for b in blocks])
        finally:
            fused.fused_submit = submit
        root = blocks[-1].header.state_root
        report, nodes = reachable(target.storages, root)
        check(report.missing == 0 and report.corrupt == 0,
              f"CPU windowed replay: {report}")
        return target, nodes, recorded, stats, gauge_deltas(gauges)

    def card_run(name, spec, blocks, window, source, ref, cfg=None,
                 nodes=None, backend=None, storages=Storages, keep=None):
        """``blocks`` replayed windowed on the card at ``cfg`` (serial
        execution at ``window`` by default), gated against ``ref`` (the
        CPU replay's chain) and ``nodes`` (the reachable nodes it must
        give, by default ``name``'s CPU reference's). Every frame runs on
        the native VM, or with ``backend="python"`` on the Python VM; the
        chain goes into ``storages()``. ``keep`` receives the chain and
        its reachable nodes."""
        cfg = cfg or workloads.replay_config(commit_window_blocks=window)
        wire = [Block.decode(b.encode()) for b in blocks]
        target = Blockchain(storages(), cfg)
        launches.zero()
        t0 = time.perf_counter()
        target.load_genesis(spec, on_device=True, device=dev)
        torch.cuda.synchronize()
        genesis_s = time.perf_counter() - t0
        genesis = launches.read(f"{name} genesis", ("k1r",))
        prefetch.flush_sender_cache()
        before = {"batches": prefetch.PREFETCH_GAUGES["device_batches"],
                  **{k: WINDOW_GAUGES[k] for k in WINDOW_GAUGES},
                  "deaths": PIPELINE_GAUGES["collector_deaths"],
                  "unspilled": MIRROR_GAUGES["unspilled_evictions"]}
        driver = ReplayDriver(target, cfg, device_commit=True, device=dev)
        reset_learner()
        gauges = dict(EXEC_GAUGES)
        launches.zero()
        with vm_frames(backend) as frames:
            stats = driver.replay(wire)
            torch.cuda.synchronize()
        exec_gauges = gauge_deltas(gauges)
        mirror = driver._mirror
        bad = mirror.verify()
        device_w = WINDOW_GAUGES["device_windows"] - before["device_windows"]
        host_w = WINDOW_GAUGES["host_windows"] - before["host_windows"]
        path = launches.read(name, ("k1r", "k5", "k4"))
        senders = prefetch.PREFETCH_GAUGES["device_batches"] - before["batches"]
        deaths = PIPELINE_GAUGES["collector_deaths"] - before["deaths"]
        windows = -(-len(wire) // window)
        with_txs = sum(1 for b in wire if b.body.transactions)
        check(deaths == 0, f"{name}: {deaths} collector deaths")
        check(bad == 0, f"{name}: mirror verify found {bad}")
        check(stats.blocks == len(wire), f"{name}: replayed {stats.blocks}")
        check(driver.adaptive is None and host_w == 0
              and device_w == windows, f"{name}: {device_w} device + "
              f"{host_w} host windows of {windows}")
        check(path["k5"] == device_w, f"{name}: K5 launched {path['k5']} "
              f"times for {device_w} device windows")
        check(senders == with_txs and path["k1r"] == senders,
              f"{name}: K1r launched {path['k1r']} times for {senders} "
              f"sender batches ({with_txs} blocks with transactions): a "
              "trie commit launched K1r")
        check(target.storages.window_journal.pending() == [],
              f"{name}: journal intents pending after the drain")
        for n, b in enumerate(wire, start=1):
            got = target.get_header_by_number(n)
            check(got is not None and got.state_root == b.header.state_root,
                  f"{name}: block {n}'s root")
            check(target.storages.receipts_storage.get(n)
                  == ref.storages.receipts_storage.get(n)
                  == source.storages.receipts_storage.get(n),
                  f"{name}: block {n}'s receipts differ")
        head = wire[-1].header.state_root
        check(target.best_block_number == wire[-1].number,
              f"{name}: best block")
        report, got_nodes = reachable(target.storages, head)
        check(report.missing == 0 and report.corrupt == 0,
              f"{name}: verify_reachable {report}")
        check(got_nodes == (nodes or ref_nodes[name]), f"{name}: reachable "
              "nodes != the CPU windowed replay's")
        check("erc20" not in name
              or frames[f"{frames['vm_backend']}_frames"] > 0,
              f"{name}: no contract frame ran on the {frames['vm_backend']} "
              "VM")
        if keep is not None:
            keep.update(chain=target, nodes=got_nodes)
        return {"blocks": stats.blocks, "txs": stats.txs,
                "seconds": stats.seconds, "blocks_per_s": stats.blocks_per_s,
                "tx_per_s": stats.txs / stats.seconds,
                "phases_s": stats.phases,
                "execute_s": stats.phases["execute"],
                "lanes": lanes(stats, exec_gauges),
                "parallel_rate": stats.parallel_rate,
                "pipeline_occupancy": stats.pipeline_occupancy,
                "driver_stall_s": PIPELINE_GAUGES["driver_stall_s"],
                "pipeline_depth": PIPELINE_GAUGES["depth"],
                "windows": windows, "device_windows": device_w,
                "host_windows": host_w,
                "k5_launches_per_window": path["k5"] / windows,
                "k1r_launches": path["k1r"], "k1r_sender_batches": senders,
                "launches": path, "k6_launches": path["k6"],
                "genesis_seconds": genesis_s,
                "genesis_k1r_launches": genesis["k1r"],
                "mirror_resident_rows": mirror.resident_count,
                "mirror_classes": sorted(nb for nb, _ in mirror._classes),
                "unspilled_evictions": MIRROR_GAUGES["unspilled_evictions"]
                - before["unspilled"],
                "persist_bytes_per_s": stats.persist_bytes_per_sec,
                "root": head.hex(), **frames}

    erc20_txs, holders = 200, 256
    t0 = time.perf_counter()
    builder_100k, spec_100k, blocks_100k = workloads.erc20_chain(
        workloads.replay_config(), args.erc20_100k_blocks, erc20_txs, holders,
        extra_alloc=workloads.bulk_alloc(args.accounts))
    build_100k_s = time.perf_counter() - t0
    phases = (
        ("replay_transfers_w16", 16, chains["replay_transfers"]),
        ("replay_erc20_w8", 8, chains["replay_erc20"]),
        ("replay_erc20_100k_w8", 8,
         (builder_100k, spec_100k, blocks_100k, None)),
    )
    ref_nodes, k5_out, lines = {}, {}, {}
    for name, window, (builder, spec, blocks, serial_stats) in phases:
        t0 = time.perf_counter()
        ref, ref_nodes[name], recorded, _, _ = cpu_reference(spec, blocks,
                                                             window)
        cpu_s = time.perf_counter() - t0
        first = None
        if not k5_out:
            # the process's first windowed replay pays one-time costs on
            # its stage threads: it runs once before the measured run,
            # gated alike, and the line gives both
            first = card_run(name, spec, blocks, window, builder.blockchain,
                             ref)
        kept = {}
        run = card_run(name, spec, blocks, window, builder.blockchain, ref,
                       keep=kept)
        if name == "replay_erc20_w8":
            erc20_w8 = (spec, blocks, builder, ref, kept)
        shapes = [k5_at_window(torch, dev, fused, tr,
                               deferred._PLACEHOLDER_PREFIX, tile, pos)
                  for tr, tile, pos in recorded]
        k5_out[name] = {
            "windows": len(shapes),
            "k5_ms": [w["k5_ms"] for w in shapes],
            "plain_ms": [w["plain_ms"] for w in shapes],
            "bound_ms": [w["bound_ms"] for w in shapes],
            "bound_by": sorted({w["bound_by"] for w in shapes}),
            "rows": [w["rows"] for w in shapes],
            "levels": [w["levels"] for w in shapes],
            "ext_rows": [w["ext_rows"] for w in shapes],
            "max_abs_err": max(w["max_abs_err"] for w in shapes)}
        line = {"phase": name, "window": window, **run,
                "cpu_reference_seconds": cpu_s, "k5_windows": k5_out[name]}
        if first is not None:
            line["first_run"] = {k: first[k] for k in
                                 ("seconds", "blocks_per_s", "phases_s")}
        if serial_stats is not None:
            line["serial_blocks_per_s"] = serial_stats.blocks_per_s
            line["serial_tx_per_s"] = serial_stats.txs / serial_stats.seconds
        else:
            line.update(
                genesis_accounts=len(spec.alloc), build_seconds=build_100k_s,
                reduced=f"a deploy and {args.erc20_100k_blocks} synthetic "
                f"blocks of {erc20_txs} token transfers over "
                f"{args.accounts:,} bulk accounts, in place of BASELINE "
                "#4's 10,000 mainnet blocks (15.50M-15.51M) over mainnet "
                "state")
        emit(line)
        lines[name] = line
        del ref, recorded, kept

    # the same chain with the observability plane on, then the cost
    # model's calibration
    emit(traced_phase(torch, dev, card_run, erc20_w8,
                      lines["replay_erc20_w8"], ref_nodes["replay_erc20_w8"],
                      k1f_hashes_per_s))

    # the Python-VM oracle: replay_erc20_w8's chain again with every frame
    # on evm/vm.py; roots, receipts and reachable nodes equal the native
    # run's (the measured one above, ``mem``)
    name = "replay_erc20_w8"
    spec, blocks, builder, ref, mem = erc20_w8
    native = {k: lines[name][k] for k in ("blocks_per_s", "execute_s",
                                          "seconds")}
    py = {}
    run = card_run(f"{name}_python_vm", spec, blocks, 8, builder.blockchain,
                   ref, nodes=ref_nodes[name], backend="python", keep=py)
    for i in range(1, len(blocks) + 1):
        check(py["chain"].get_header_by_number(i).state_root
              == mem["chain"].get_header_by_number(i).state_root
              and py["chain"].storages.receipts_storage.get(i)
              == mem["chain"].storages.receipts_storage.get(i),
              f"{name}_python_vm: block {i}'s root or receipts != native")
    check(py["nodes"] == mem["nodes"], f"{name}_python_vm: reachable nodes "
          "!= the native VM run's")
    emit({"phase": f"{name}_python_vm", "window": 8, **run,
          "native_vm": native})
    del py

    # durability: the same chain into the native append-log engine, then
    # stopped and reopened in this process
    data_dir = tempfile.mkdtemp(prefix="khipu_durable_")
    durable = {}
    try:
        run = card_run(f"{name}_durable", spec, blocks, 8,
                       builder.blockchain, ref, nodes=ref_nodes[name],
                       storages=lambda: Storages("native", data_dir),
                       keep=durable)
        durable["chain"].storages.stop()
        del durable
        t0 = time.perf_counter()
        reopened = Blockchain(Storages("native", data_dir),
                              workloads.replay_config(commit_window_blocks=8))
        reopen_s = time.perf_counter() - t0
        head = blocks[-1].header
        report, nodes = reachable(reopened.storages, head.state_root)
        check(report.missing == 0 and report.corrupt == 0
              and nodes == mem["nodes"], f"{name}_durable: the reopened "
              f"store's reachable nodes != the memory engine's ({report})")
        for i in range(len(blocks) + 1):
            for store in ("block_header_storage", "block_body_storage",
                          "receipts_storage"):
                got = getattr(reopened.storages, store).get(i)
                check((got is not None or i == 0) and got == getattr(
                    mem["chain"].storages, store).get(i),
                    f"{name}_durable: block {i}'s {store} after reopening")
        check(reopened.best_block_number == head.number,
              f"{name}_durable: best block {reopened.best_block_number}")
        check(reopened.storages.window_journal.pending() == [],
              f"{name}_durable: journal intents pending after reopening")
        data_bytes = sum(os.path.getsize(os.path.join(data_dir, f))
                         for f in os.listdir(data_dir))
        reopened.storages.stop()
        emit({"phase": f"{name}_durable", "window": 8, "engine": "native",
              **run, "reopen_seconds": reopen_s, "data_bytes": data_bytes,
              "memory_engine": native,
              # the persist stage's rate with every topic flushed to the
              # OS before each window's commit mark and after each block
              "native_persist_mb_per_s": run["persist_bytes_per_s"] / 1e6,
              "memory_persist_mb_per_s":
                  lines[name]["persist_bytes_per_s"] / 1e6})
        del reopened
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
    # the uninterrupted windowed run the recovery and kesque phases are
    # held to; ``card_run`` replays it again into another engine there
    w8 = {"spec": spec, "blocks": blocks, "mem": mem, "txs": erc20_txs,
          "holders": holders, "builder": builder, "ref": ref,
          "card_run": card_run,
          "persist_bytes_per_s": {
              "memory": lines[name]["persist_bytes_per_s"],
              "native": run["persist_bytes_per_s"]},
          "blocks_per_s": {"memory": lines[name]["blocks_per_s"],
                           "native": run["blocks_per_s"]},
          # the chain live_sync_erc20_100k and serve_erc20_100k_w8 serve,
          # and its unloaded windowed import's rate
          "chain_100k": (builder_100k, spec_100k, blocks_100k),
          "blocks_per_s_100k": lines["replay_erc20_100k_w8"]["blocks_per_s"],
          # its CPU windowed import's reachable nodes, which
          # bridge_cluster_100k_w8's primary must hold
          "nodes_100k": ref_nodes["replay_erc20_100k_w8"]}
    del ref, erc20_w8

    # parallel and scheduled execution (the default parallel_tx and
    # scheduled_tx), beside the serial-execution lines above
    for name, window, serial_name, (builder, spec, blocks, _) in (
        ("replay_erc20_par_w8", 8, "replay_erc20_w8",
         chains["replay_erc20"]),
        ("replay_erc20_100k_par_w8", 8, "replay_erc20_100k_w8",
         (builder_100k, spec_100k, blocks_100k, None)),
    ):
        cfg = workloads.replay_config(parallel_tx=True,
                                      commit_window_blocks=window)
        t0 = time.perf_counter()
        ref, par_nodes, _, ref_stats, ref_gauges = cpu_reference(
            spec, blocks, window, cfg)
        cpu_s = time.perf_counter() - t0
        check(par_nodes == ref_nodes[serial_name], f"{name}: the CPU "
              "parallel replay's nodes != the CPU serial replay's")
        run = card_run(name, spec, blocks, window, builder.blockchain, ref,
                       cfg=cfg, nodes=ref_nodes[serial_name])
        want = lanes(ref_stats, ref_gauges)
        check(run["lanes"] == want, f"{name}: lanes {run['lanes']} != the "
              f"CPU parallel replay's {want}")
        check(run["lanes"]["mispredictions"] == 0 and run["lanes"]["parallel"]
              > 0, f"{name}: lanes {run['lanes']}")
        check(run["k6_launches"] == 0, f"{name}: K6 launched with "
              "exec_device off")
        serial = lines[serial_name]
        emit({"phase": name, "window": window, **run,
              "cpu_reference_seconds": cpu_s,
              "cpu_lanes": want,
              "serial_execution": {k: serial[k] for k in (
                  "blocks_per_s", "tx_per_s", "execute_s", "seconds")}})
        del ref

    # the fast lane with the row validation on the card (K6). The
    # adaptive probe's verdict is reported, not obeyed: it is unstable on
    # this card, so the phase runs with the probe off
    probe = probe_backend(workloads.replay_config().sync.adaptive_d2d_margin,
                          dev)
    emit({"phase": "exec_probe", "device_ok": probe.device_ok,
          "d2d_bytes_per_s": probe.d2d_bytes_per_s,
          "memcpy_bytes_per_s": probe.memcpy_bytes_per_s})
    name, window = "replay_transfers_par_w16", 16
    t0 = time.perf_counter()
    builder, spec, blocks = workloads.contended_transfer_chain(
        workloads.replay_config(), args.par_transfer_blocks, 200)
    build_s = time.perf_counter() - t0
    ref, nodes, _, ref_stats, ref_gauges = cpu_reference(
        spec, blocks, window, workloads.replay_config(
            parallel_tx=True, commit_window_blocks=window))
    batches = {"fast": 0, "call": 0}
    real = batch_exec.execute_fast_batch, batch_call.execute_call_batch

    def counted(kind, fn):
        def run(*a, **k):
            batches[kind] += 1
            return fn(*a, **k)
        return run

    batch_exec.execute_fast_batch = counted("fast", real[0])
    batch_call.execute_call_batch = counted("call", real[1])
    try:
        run = card_run(name, spec, blocks, window, builder.blockchain, ref,
                       cfg=workloads.replay_config(
                           parallel_tx=True, commit_window_blocks=window,
                           exec_device=True, adaptive_probe=False),
                       nodes=nodes)
    finally:
        batch_exec.execute_fast_batch, batch_call.execute_call_batch = real
    want = lanes(ref_stats, ref_gauges)
    check(run["lanes"] == want, f"{name}: lanes {run['lanes']} != the CPU "
          f"replay's {want}")
    check(run["k6_launches"] == batches["fast"] + batches["call"] > 0,
          f"{name}: K6 launched {run['k6_launches']} times for {batches} "
          "batches")
    emit({"phase": name, "window": window, **run, "build_seconds": build_s,
          "executor_batches": batches, "exec_device": True,
          "adaptive_probe": False, "cpu_lanes": want,
          "chain": f"{args.par_transfer_blocks} blocks of 200 transfers "
          "from 200 senders, 20 % paying 4 hot recipients, the rest fresh "
          "addresses"})
    del ref
    return k5_out, w8


STAGE_THREADS = {"window.pack": "window-seal",
                 "window.collect": "window-collect",
                 "window.persist": "window-persist",
                 "window.save": "window-save"}


def traced_phase(torch, dev, card_run, erc20_w8, untraced, ref_nodes,
                 k1f_hashes_per_s) -> dict:
    """traced_replay_erc20_w8: replay_erc20_w8's chain (17 blocks, 3,201
    transactions, window 8, device commit) with the tracer, the movement
    ledger and the journey board on (``ObservabilityConfig``), held to
    the untraced run's gates and chain (``erc20_w8``'s kept run), then
    the plane's own gates: every block's lifecycle, the stage spans on
    the stage threads under their window's seal, no nesting violation;
    ``seal.upload`` bytes equal to the tensors the seal stage uploaded
    and ``mirror.get`` bytes to the reads, counted apart from the
    ledger; a window report for every block; every transaction's
    journey ingress -> seal -> journal.intent -> durable; a Chrome trace
    that loads back with one flow pair a stage span; a verdict for every
    seal sub-phase of every window. Then ``calibrate_floors``."""
    from khipu_tpu_torch import workloads
    from khipu_tpu_torch.config import ObservabilityConfig
    from khipu_tpu_torch.observability import (
        costmodel,
        export,
        recorder,
        trace,
    )
    from khipu_tpu_torch.observability.journey import JOURNEY
    from khipu_tpu_torch.observability.profiler import D2H, H2D, LEDGER
    from khipu_tpu_torch.storage import device_mirror
    from khipu_tpu_torch.trie import fused

    name = "traced_replay_erc20_w8"
    spec, blocks, builder, ref, mem = erc20_w8
    # the pinned ring holds every journey that outlives the slow-tail
    # budget (a window's transactions wait a window and more for their
    # durable page)
    cfg = dataclasses.replace(
        workloads.replay_config(commit_window_blocks=8),
        observability=ObservabilityConfig(
            enabled=True, ledger_enabled=True, journey_enabled=True,
            journey_pinned_capacity=4096))
    tracer = trace.tracer
    tracer.reset()
    LEDGER.reset()
    JOURNEY.reset()
    # the seal stage's uploads and the mirror's row reads, counted apart
    # from the ledger while it is on
    uploaded, gets = [], []
    real_upload, real_fetch = (fused.upload_packed,
                               device_mirror._ClassMirror.fetch_row)

    def nbytes(t):
        return t.numel() * t.element_size()

    def counting_upload(classes, plan, device):
        real_upload(classes, plan, device)
        if LEDGER.enabled:
            uploaded.append(
                sum(nbytes(c.enc) for c in classes)
                + sum(nbytes(c.aidx) for c in classes if c.aidx is not None)
                + sum(nbytes(t) for t in (plan.d_order, plan.d_level_ptr,
                                          plan.d_tptr, plan.d_toff,
                                          plan.d_tchild)))

    def counting_fetch(self, key):
        got = real_fetch(self, key)
        if got is not None and LEDGER.enabled:
            gets.append(4 * self.nwords)
        return got

    fused.upload_packed = counting_upload
    device_mirror._ClassMirror.fetch_row = counting_fetch
    kept = {}
    try:
        run = card_run(name, spec, blocks, 8, builder.blockchain, ref,
                       cfg=cfg, nodes=ref_nodes, keep=kept)
    finally:
        fused.upload_packed = real_upload
        device_mirror._ClassMirror.fetch_row = real_fetch
        tracer.disable()
        LEDGER.disable()
        JOURNEY.disable()
    t0 = time.perf_counter()
    # the replay is unchanged: the untraced run's chain, block by block
    chain, base = kept["chain"], mem["chain"]
    for n in range(1, len(blocks) + 1):
        check(chain.get_header_by_number(n).state_root
              == base.get_header_by_number(n).state_root
              and chain.storages.receipts_storage.get(n)
              == base.storages.receipts_storage.get(n),
              f"{name}: block {n}'s root or receipts != the untraced run's")
    check(kept["nodes"] == mem["nodes"], f"{name}: reachable nodes != the "
          "untraced run's")
    spans = tracer.snapshot()
    check(tracer.dropped == 0, f"{name}: the span ring dropped "
          f"{tracer.dropped}")
    by_id = {sp.sid: sp for sp in spans}
    # lifecycle: every block, every required phase, the stage phases on
    # their stage threads under their window's seal
    for n in range(1, len(blocks) + 1):
        rec = recorder.lifecycle(spans, n)
        missing = [p for p in recorder.REQUIRED_PHASES
                   + ("window.pack", "fused.dispatch")
                   if p not in rec["phases"]]
        check(rec["complete"] and not missing,
              f"{name}: block {n}'s lifecycle lacks {missing}")
    stage_spans = [sp for sp in spans if sp.name in STAGE_THREADS]
    windows = sorted({sp.tags["block_lo"] for sp in stage_spans})
    check(len(stage_spans) == 4 * len(windows) == 4 * run["windows"],
          f"{name}: {len(stage_spans)} stage spans for {run['windows']} "
          "windows")
    for sp in stage_spans:
        parent = by_id.get(sp.parent)
        check(sp.thread_name == STAGE_THREADS[sp.name]
              and parent is not None and parent.name == "window.seal"
              and parent.tid != sp.tid
              and parent.tags["block_lo"] == sp.tags["block_lo"],
              f"{name}: {sp.name} of window {sp.tags['block_lo']} on "
              f"{sp.thread_name}, parent {parent}")
    bad_nesting = recorder.nesting_violations(spans)
    check(bad_nesting == [], f"{name}: nesting {bad_nesting[:3]}")
    # the ledger
    events = LEDGER.events()
    check(LEDGER.dropped == 0, f"{name}: the ledger dropped "
          f"{LEDGER.dropped}")
    totals = LEDGER.totals(events, include_host=True)
    up_ledger = totals.get(("seal.upload", H2D), {}).get("bytes", 0)
    check(up_ledger == sum(uploaded) > 0 and totals[("seal.upload", H2D)][
        "count"] == len(uploaded) == run["device_windows"],
          f"{name}: seal.upload H2D {up_ledger} B in the ledger, "
          f"{sum(uploaded)} B in {len(uploaded)} uploads counted apart")
    get_ledger = totals.get(("mirror.get", D2H), {}).get("bytes", 0)
    check(get_ledger == sum(gets), f"{name}: mirror.get D2H {get_ledger} B "
          f"in the ledger, {len(gets)} reads of {sum(gets)} B counted apart")
    reports = {n: recorder.window_report(n, spans)
               for n in range(1, len(blocks) + 1)}
    check(all(r["found"] for r in reports.values()),
          f"{name}: no window report for blocks "
          f"{[n for n, r in reports.items() if not r['found']]}")
    # journeys: every transaction, the serial executor's edge order
    want_edges = ["ingress", "seal", "journal.intent", "durable"]
    txs = [stx.hash for b in blocks for stx in b.body.transactions]
    wrong = [h.hex() for h in txs
             if JOURNEY.get(h) is None
             or [e[1] for e in JOURNEY.get(h).events] != want_edges]
    check(not wrong and len(txs) == run["txs"], f"{name}: {len(wrong)} of "
          f"{len(txs)} journeys are not {want_edges}")
    durable_ms = sorted(JOURNEY.latencies_ms("durable"))
    # the Chrome trace: it loads back, one flow pair a stage span
    with tempfile.TemporaryDirectory() as tmp:
        path = export.dump_chrome_trace(os.path.join(tmp, "trace.json"),
                                        spans)
        trace_bytes = os.path.getsize(path)
        with open(path) as f:
            doc = json.load(f)
    flows = {}
    for ev in doc["traceEvents"]:
        if ev["ph"] in ("s", "f") and ev["name"].startswith("window.seal→"):
            flows.setdefault(ev["name"].split("→", 1)[1], []).append(ev["ph"])
    for stage in STAGE_THREADS:
        n_stage = sum(1 for sp in stage_spans if sp.name == stage)
        check(sorted(flows.get(stage, [])) == ["f"] * n_stage
              + ["s"] * n_stage, f"{name}: {stage} flows {flows.get(stage)}"
              f" for {n_stage} spans")
    # the cost model: a verdict for every seal sub-phase of every window
    verdicts = {}
    for lo in windows:
        costs = costmodel.window_costs(lo, spans)
        rows = costs.get("subphases", {})
        check(costs["found"] and {"seal.pack", "seal.dispatch_build",
                                  "seal.upload", "seal.rootcheck",
                                  "seal.journal"} <= set(rows)
              and all(r["bound"] in ("bytes-bound", "dispatch-bound",
                                     "compute-bound", "fixed-overhead")
                      for r in rows.values()),
              f"{name}: window {lo}'s costs {costs}")
        verdicts[lo] = {k: {"bound": r["bound"],
                            "achieved_s": r["achieved_s"],
                            "attainable_s": r["attainable_s"]}
                        for k, r in rows.items()}
    gates_s = time.perf_counter() - t0
    upload_sizes = [ev.nbytes for ev in events
                    if ev.site == "seal.upload" and ev.direction == H2D]
    floors = calibrate_floors(torch, dev, max(upload_sizes),
                              k1f_hashes_per_s)
    by_site = {f"{site} {d}": {"bytes": v["bytes"], "count": v["count"],
                               "seconds": v["seconds"]}
               for (site, d), v in sorted(totals.items())}
    line = {"phase": name, "window": 8, **run,
            "untraced_blocks_per_s": untraced["blocks_per_s"],
            "traced_over_untraced": run["blocks_per_s"]
            / untraced["blocks_per_s"],
            "spans": len(spans), "stage_spans": len(stage_spans),
            "transfer_events": len(events), "ledger": by_site,
            "seal_upload_bytes": sum(uploaded),
            "mirror_get_reads": len(gets),
            "journeys": len(txs),
            "durable_ms_p50_p99": [durable_ms[len(durable_ms) // 2],
                                   durable_ms[int(0.99 * (len(durable_ms)
                                                          - 1))]],
            "phase_breakdown_s": recorder.phase_breakdown(spans),
            "seal_decomposition": recorder.seal_decomposition(spans),
            "occupancy_from_spans": recorder.occupancy(spans),
            "chrome_trace_bytes": trace_bytes,
            "chrome_trace_events": len(doc["traceEvents"]),
            "window_costs": verdicts, "gates_seconds": gates_s,
            "floors": floors, "card": card_line()}
    tracer.reset()
    LEDGER.reset()
    JOURNEY.reset()
    return line


def calibrate_floors(torch, dev, upload_bytes: int,
                     k1f_hashes_per_s) -> dict:
    """The cost model's floors on this card: the median blocking 32 B
    device->host round trip (200 reps), the pinned host->device rate at
    ``upload_bytes`` (the largest window upload of the traced replay;
    CUDA events, median of 20), K1f's kernel-only hash rate at 1M x 576
    B rows (phase 2's profiler time) and the op rate of the bounds."""
    x = torch.zeros(8, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    x.cpu()
    rtt = []
    for _ in range(200):
        t0 = time.perf_counter()
        x.cpu()
        rtt.append(time.perf_counter() - t0)
    host = torch.empty(upload_bytes, dtype=torch.uint8, pin_memory=True)
    card = torch.empty(upload_bytes, dtype=torch.uint8, device=dev)
    card.copy_(host, non_blocking=True)
    torch.cuda.synchronize()
    times = []
    for _ in range(20):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        card.copy_(host, non_blocking=True)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    del host, card
    return {"dispatch_floor_s": sorted(rtt)[len(rtt) // 2],
            "h2d_bytes_per_s": upload_bytes / sorted(times)[len(times) // 2],
            "h2d_probe_bytes": upload_bytes,
            "kernel_hashes_per_s": k1f_hashes_per_s,
            "element_ops_per_s": H100_INT32_OPS_PER_S,
            "element_ops_per_block": SPONGE_OPS_PER_BLOCK}


def ethash_phase() -> dict:
    """ethash_block1: the epoch-0 Ethash cache at its spec size, then
    mainnet block 1's header validated against the mainnet genesis
    header with the seal check on (``check_pow`` at the epoch's dataset
    size); nonce + 1 and one flipped mix byte must each be refused."""
    from khipu_tpu_torch import workloads
    from khipu_tpu_torch.base.keccak import keccak256
    from khipu_tpu_torch.config import KhipuConfig
    from khipu_tpu_torch.consensus import ethash
    from khipu_tpu_torch.domain.blockchain import Blockchain
    from khipu_tpu_torch.domain.difficulty import calc_difficulty
    from khipu_tpu_torch.storage.storages import Storages
    from khipu_tpu_torch.validators.validators import (
        BlockHeaderValidator,
        HeaderValidationError,
    )

    cfg = KhipuConfig()
    header = workloads.MAINNET_BLOCK1
    epoch = header.number // ethash.EPOCH_LENGTH
    t0 = time.perf_counter()
    cache = ethash.EthashCache(epoch)
    cache_s = time.perf_counter() - t0
    check(cache.n_rows * ethash.HASH_BYTES == ethash.cache_size(epoch)
          == 16_776_896, f"epoch cache holds {cache.n_rows} rows")
    full = ethash.dataset_size(epoch)
    checks_ms = []

    def seal_ok(h):
        t = time.perf_counter()
        ok = ethash.check_pow(cache, keccak256(h.encode_without_nonce()),
                              h.mix_hash, int.from_bytes(h.nonce, "big"),
                              h.difficulty, full)
        checks_ms.append((time.perf_counter() - t) * 1e3)
        return ok

    genesis = Blockchain(Storages(), cfg).load_genesis(
        workloads.mainnet_genesis_spec(os.path.join(
            ROOT, "tests", "fixtures", "mainnet_genesis_alloc.txt.gz")))
    check(genesis.hash == workloads.MAINNET_GENESIS_HASH,
          "genesis hash != mainnet's")
    validator = BlockHeaderValidator(
        cfg.blockchain, seal_check=seal_ok,
        difficulty_fn=lambda h, p: calc_difficulty(h.unix_timestamp, p,
                                                   cfg.blockchain))
    validator.validate(header, genesis.header)
    nonce = int.from_bytes(header.nonce, "big")
    tampered = {
        "nonce_plus_1": dataclasses.replace(
            header, nonce=(nonce + 1).to_bytes(8, "big")),
        "mix_byte_flipped": dataclasses.replace(
            header, mix_hash=bytes([header.mix_hash[0] ^ 1])
            + header.mix_hash[1:]),
    }
    for what, bad in tampered.items():
        try:
            validator.validate(bad, genesis.header)
        except HeaderValidationError:
            continue
        raise AssertionError(f"ethash_block1: a seal with {what} passed")
    return {"phase": "ethash_block1", "epoch": epoch,
            "cache_bytes": cache.n_rows * ethash.HASH_BYTES,
            "dataset_bytes": full, "cache_build_seconds": cache_s,
            "check_ms": checks_ms[0], "rejected_check_ms": checks_ms[1:],
            "rejected": sorted(tampered), "nonce": header.nonce.hex(),
            "block": header.number, "host_only": True}


# hits of each seam in the first window of the ERC-20 chain at window 8
# (a deploy block and 7 transfer blocks), so that ``after`` kills the
# second window: one a window for the stage and fused seams, one a block
# at collector.save (after 11: block 12 saved, 13-16 not) and 4 block
# puts a block (header, body, receipts, total difficulty: after 33 dies
# on block 9's body). One seam a recovery branch (cut from eleven to pay
# for parallel_mesh; tests/test_torch_chaos.py kills every seam on the
# CPU), each with the report it produced on the card (best before and
# after, rolled back, repaired, blocks removed) and the fields gated; the
# first two are not gated: how far the first window got when the second
# died is a race (a CPU run saw 0 -> 0, 3, 0, 0 at collector.seal)
#   collector.seal     the window's intent only: 8 -> 8, 2, 0, 0
#   fused.collect      dead while K5's digests copy back to the host:
#                      8 -> 8, 2, 0, 0
#   storage.block.put  a torn block (block 9's header without its body):
#                      8 -> 8, 2, 0, 1 (gated: 1 removed)
#   collector.save     whole blocks 9-12 saved, no mark: 12 -> 8, 2, 0, 4
#                      (gated: 4 removed)
#   collector.commit   every block saved, no commit mark: 16 -> 16, 1, 1,
#                      0 (gated: 1 repaired)
# The fused.dispatch raise below stops a replay before K5 launches.
RECOVER_SEAMS = (("collector.seal", 1, {}), ("fused.collect", 1, {}),
                 ("storage.block.put", 33, {"blocks_removed": 1}),
                 ("collector.save", 11, {"blocks_removed": 4}),
                 ("collector.commit", 1, {"repaired": 1}))


def recovery_helpers(args, torch, dev, launches, w8):
    """The windowed ERC-20 chain's runs and gates on the card, shared by
    the recovery and kesque phases: its wire blocks decoded anew for each
    run, its config, a genesis load, a driver, a gated windowed replay, a
    seam kill, a gated ``recover`` and the check against the
    uninterrupted run."""
    from khipu_tpu_torch import workloads
    from khipu_tpu_torch.chaos import (
        FaultPlan,
        FaultRule,
        InjectedDeath,
        InjectedFault,
        active,
        quiet_deaths,
    )
    from khipu_tpu_torch.domain.block import Block
    from khipu_tpu_torch.domain.blockchain import Blockchain
    from khipu_tpu_torch.ledger.window import WINDOW_GAUGES
    from khipu_tpu_torch.sync import prefetch
    from khipu_tpu_torch.sync.replay import CollectorDied, ReplayDriver

    window = 8
    spec, mem = w8["spec"], w8["mem"]
    top = w8["blocks"][-1].number

    def fresh(blocks):
        """The blocks after a wire round trip, decoded anew for each run
        (no sender memo carried over from an earlier run)."""
        return [Block.decode(b.encode()) for b in blocks]

    wire = fresh(w8["blocks"])

    def config(**sync):
        return workloads.replay_config(commit_window_blocks=window, **sync)

    def load(name, storages, cfg):
        bc = Blockchain(storages, cfg)
        launches.zero()
        bc.load_genesis(spec, on_device=True, device=dev)
        torch.cuda.synchronize()
        launches.read(f"{name} genesis", ("k1r",))
        return bc

    def driver(bc, cfg):
        return ReplayDriver(bc, cfg, device_commit=True, device=dev)

    def windowed(name, drv, blocks):
        """Replay ``blocks`` windowed on the card: every window through
        K5, none on the host, K1r only for sender batches."""
        before = {k: WINDOW_GAUGES[k] for k in WINDOW_GAUGES}
        batches0 = prefetch.PREFETCH_GAUGES["device_batches"]
        prefetch.flush_sender_cache()
        launches.zero()
        t0 = time.perf_counter()
        stats = drv.replay(blocks)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        path = launches.read(name, ("k5",) if blocks else ())
        device_w = WINDOW_GAUGES["device_windows"] - before["device_windows"]
        host_w = WINDOW_GAUGES["host_windows"] - before["host_windows"]
        senders = prefetch.PREFETCH_GAUGES["device_batches"] - batches0
        check(host_w == 0 and device_w == -(-len(blocks) // window),
              f"{name}: {device_w} device and {host_w} host windows for "
              f"{len(blocks)} blocks")
        check(path["k5"] == device_w, f"{name}: K5 launched {path['k5']} "
              f"times for {device_w} device windows")
        check(path["k1r"] == senders, f"{name}: K1r launched {path['k1r']} "
              f"times for {senders} sender batches")
        return {"blocks": stats.blocks, "seconds": seconds,
                "blocks_per_s": stats.blocks / seconds if seconds else 0.0,
                "device_windows": device_w, "host_windows": host_w,
                "launches": path}

    def same_as_uninterrupted(name, bc, drv):
        """Roots, receipts and reachable nodes equal the uninterrupted
        windowed run's; nothing pending; the mirror verifies (K4)."""
        check(bc.best_block_number == top, f"{name}: best block "
              f"{bc.best_block_number}")
        for b in wire:
            got = bc.get_header_by_number(b.number)
            check(got is not None and got.hash == b.hash,
                  f"{name}: block {b.number}")
            check(bc.storages.receipts_storage.get(b.number)
                  == mem["chain"].storages.receipts_storage.get(b.number),
                  f"{name}: block {b.number}'s receipts")
        report, nodes = reachable(bc.storages, wire[-1].header.state_root)
        check(report.missing == 0 and report.corrupt == 0
              and nodes == mem["nodes"], f"{name}: reachable nodes != the "
              f"uninterrupted run's ({report})")
        check(bc.storages.window_journal.pending() == [],
              f"{name}: journal intents pending")
        launches.zero()
        bad = drv._mirror.verify()
        torch.cuda.synchronize()
        launches.read(f"{name} mirror verify", ("k4",))
        check(bad == 0, f"{name}: mirror verify found {bad}")

    def kill(name, bc, cfg, site, after, kind="die"):
        """The windowed replay with a ``kind`` fault at ``site``'s hit
        after+1; returns the exception that stopped it (None: it
        finished)."""
        plan = FaultPlan(seed=args.seed, rules=[FaultRule(
            site, kind, after=after, times=1)])
        launches.zero()
        raised = None
        with active(plan), quiet_deaths():
            try:
                driver(bc, cfg).replay(fresh(wire))
            except (CollectorDied, InjectedDeath, InjectedFault) as e:
                raised = e
        torch.cuda.synchronize()
        path = launches.read(f"{name} killed", ())
        check([s for (s, _, _, _) in plan.fired] == [site],
              f"{name}: fired {plan.fired}")
        return raised, path

    def settle(name, bc, cfg):
        t0 = time.perf_counter()
        report = driver(bc, cfg).recover()
        recover_s = time.perf_counter() - t0
        best = bc.best_block_number
        check(bc.storages.window_journal.pending() == [],
              f"{name}: journal intents pending after recover")
        check(best == report.best_after and best % window == 0
              and best <= 2 * window, f"{name}: best block {best} after "
              "recover is not a window's top at or below the dead window's")
        return report, recover_s

    return SimpleNamespace(window=window, top=top, wire=wire, fresh=fresh,
                           config=config, load=load, driver=driver,
                           windowed=windowed, kill=kill, settle=settle,
                           same_as_uninterrupted=same_as_uninterrupted)


def recovery_phases(args, torch, dev, launches, w8, rec, base) -> None:
    """recover_erc20_w8, recover_durable and reorg_erc20: kills of the
    windowed ERC-20 replay at every seam of its path, recovered by a
    fresh driver and resumed on the card; the same into the native
    engine, reopened; and journaled chain switches to a heavier branch,
    per block and windowed, with a kill at each reorg seam."""
    from khipu_tpu_torch import workloads
    from khipu_tpu_torch.chaos import (
        FaultPlan,
        FaultRule,
        InjectedDeath,
        InjectedFault,
        active,
        quiet_deaths,
    )
    from khipu_tpu_torch.domain.blockchain import Blockchain
    from khipu_tpu_torch.ledger.window import WINDOW_GAUGES
    from khipu_tpu_torch.storage.storages import Storages
    from khipu_tpu_torch.sync import prefetch
    from khipu_tpu_torch.sync.journal import recover
    from khipu_tpu_torch.sync.reorg import ReorgManager
    from khipu_tpu_torch.sync.replay import (
        PIPELINE_GAUGES,
        CollectorDied,
        ReplayDriver,
    )
    from khipu_tpu_torch.txpool import PendingTransactionsPool

    window, spec, mem, top = rec.window, w8["spec"], w8["mem"], rec.top
    wire, fresh, config, load = rec.wire, rec.fresh, rec.config, rec.load
    driver, windowed, kill, settle = (rec.driver, rec.windowed, rec.kill,
                                      rec.settle)
    same_as_uninterrupted = rec.same_as_uninterrupted

    # recover_erc20_w8: each seam kills the second window ---------------
    cfg = config(degrade_on_collector_death=False)
    lines = []
    for site, after, expect in RECOVER_SEAMS:
        name = f"recover_erc20_w8 {site}"
        bc = load(name, Storages(), cfg)
        raised, killed_path = kill(name, bc, cfg, site, after)
        check(isinstance(raised, CollectorDied), f"{name}: the replay "
              f"was stopped by {raised!r}")
        best_before = bc.storages.app_state.best_block_number
        report, recover_s = settle(name, bc, cfg)
        got = {k: getattr(report, k) for k in expect}
        check(got == expect, f"{name}: recover reported {got}, not "
              f"{expect}")
        drv = driver(bc, cfg)
        resumed = windowed(name, drv, fresh(wire[bc.best_block_number:]))
        same_as_uninterrupted(name, bc, drv)
        line = {"phase": "recover_erc20_w8", "seam": site, "after": after,
                "stopped_by": type(raised).__name__,
                "best_before": best_before, "best_after": report.best_after,
                "scanned": report.scanned, "repaired": report.repaired,
                "rolled_back": report.rolled_back,
                "blocks_removed": report.blocks_removed,
                "recover_seconds": recover_s,
                "resume_blocks": resumed["blocks"],
                "resume_seconds": resumed["seconds"],
                "resume_blocks_per_s": resumed["blocks_per_s"],
                "resume_device_windows": resumed["device_windows"],
                "resume_host_windows": resumed["host_windows"],
                "killed_run_launches": killed_path,
                "launches": resumed["launches"]}
        emit(line)
        lines.append(line)
        del bc, drv
    # the default posture: a dead stage degrades the driver to
    # synchronous commits (still on the card) and the replay finishes
    name = "recover_erc20_w8 degrade"
    cfg_degrade = config()
    check(cfg_degrade.sync.degrade_on_collector_death, "degrade is off")
    bc = load(name, Storages(), cfg_degrade)
    deaths0 = PIPELINE_GAUGES["collector_deaths"]
    fallback0 = PIPELINE_GAUGES["sync_fallback_windows"]
    plan = FaultPlan(seed=args.seed, rules=[FaultRule(
        "collector.collect", "die", after=1, times=1)])
    drv = driver(bc, cfg_degrade)
    with active(plan), quiet_deaths():
        run = windowed(name, drv, fresh(wire))
    check(PIPELINE_GAUGES["collector_deaths"] == deaths0 + 1
          and run["blocks"] == top, f"{name}: {run['blocks']} blocks, "
          f"{PIPELINE_GAUGES['collector_deaths'] - deaths0} deaths")
    same_as_uninterrupted(name, bc, drv)
    emit({"phase": "recover_erc20_w8", "seam": "collector.collect",
          "after": 1, "degrade": True, **run,
          "sync_fallback_windows": PIPELINE_GAUGES["sync_fallback_windows"]
          - fallback0})
    emit({"phase": "recover_erc20_w8", "seams": [ln["seam"] for ln in lines],
          "degrade_run": True, "chain": f"a deploy and {top - 1} blocks of "
          f"{w8['txs']} ERC-20 transfers, window 8"})
    del bc, drv
    # a device error at the second window's dispatch, at the default
    # degrade setting: the replay stops with the fault and hashes no
    # window on the host; recover settles the torn window and a fresh
    # driver resumes on the card
    name = "recover_erc20_w8 fused.dispatch raise"
    bc = load(name, Storages(), cfg_degrade)
    host0 = WINDOW_GAUGES["host_windows"]
    raised, killed_path = kill(name, bc, cfg_degrade, "fused.dispatch", 1,
                               kind="raise")
    check(isinstance(raised, InjectedFault), f"{name}: the replay was "
          f"stopped by {raised!r}")
    check(WINDOW_GAUGES["host_windows"] == host0, f"{name}: "
          f"{WINDOW_GAUGES['host_windows'] - host0} windows on the host")
    pending = len(bc.storages.window_journal.pending())
    check(pending > 0, f"{name}: no intent pending after the fault")
    best_before = bc.storages.app_state.best_block_number
    report, recover_s = settle(name, bc, cfg_degrade)
    check(report.rolled_back >= 1, f"{name}: rolled back "
          f"{report.rolled_back} windows")
    drv = driver(bc, cfg_degrade)
    resumed = windowed(name, drv, fresh(wire[bc.best_block_number:]))
    same_as_uninterrupted(name, bc, drv)
    emit({"phase": "recover_erc20_w8", "seam": "fused.dispatch",
          "kind": "raise", "after": 1, "degrade": True,
          "stopped_by": type(raised).__name__, "pending": pending,
          "best_before": best_before, "best_after": report.best_after,
          "scanned": report.scanned, "repaired": report.repaired,
          "rolled_back": report.rolled_back, "recover_seconds": recover_s,
          "resume_blocks": resumed["blocks"],
          "resume_blocks_per_s": resumed["blocks_per_s"],
          "resume_device_windows": resumed["device_windows"],
          "resume_host_windows": resumed["host_windows"],
          "killed_run_launches": killed_path,
          "launches": resumed["launches"]})
    del bc, drv

    # recover_durable: the same kill into the native engine, reopened ---
    name = "recover_durable"
    data_dir = tempfile.mkdtemp(prefix="khipu_recover_")
    try:
        storages = Storages("native", data_dir)
        bc = load(name, storages, cfg)
        raised, _ = kill(name, bc, cfg, "collector.save", 11)
        check(isinstance(raised, CollectorDied), f"{name}: {raised!r}")
        best_before = bc.storages.app_state.best_block_number
        storages.stop()
        del bc, storages
        t0 = time.perf_counter()
        bc = Blockchain(Storages("native", data_dir), cfg)
        reopen_s = time.perf_counter() - t0
        report, recover_s = settle(name, bc, cfg)
        drv = driver(bc, cfg)
        resumed = windowed(name, drv, fresh(wire[bc.best_block_number:]))
        same_as_uninterrupted(name, bc, drv)
        for i in range(top + 1):
            for store in ("block_header_storage", "block_body_storage",
                          "receipts_storage"):
                check(getattr(bc.storages, store).get(i) == getattr(
                    mem["chain"].storages, store).get(i),
                    f"{name}: block {i}'s {store} != the memory run's")
        bc.storages.stop()
        data_bytes = sum(os.path.getsize(os.path.join(data_dir, f))
                         for f in os.listdir(data_dir))
        emit({"phase": name, "engine": "native", "seam": "collector.save",
              "after": 11, "best_before": best_before,
              "best_after": report.best_after, "scanned": report.scanned,
              "repaired": report.repaired,
              "rolled_back": report.rolled_back,
              "reopen_seconds": reopen_s, "recover_seconds": recover_s,
              "resume_blocks": resumed["blocks"],
              "resume_blocks_per_s": resumed["blocks_per_s"],
              "data_bytes": data_bytes, "launches": resumed["launches"]})
        del bc, drv
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)

    # reorg_erc20: switches to a heavier branch -------------------------
    check([b.hash for b in base] == [b.hash for b in wire],
          "the recovery chain is not replay_erc20's")
    cfg = config()
    old_tip = (top, wire[-1].hash, wire[-1].header.state_root)
    for depth, branch in ((2, 3), (8, 12)):
        ancestor = top - depth
        name = f"reorg_erc20 depth {depth}"
        t0 = time.perf_counter()
        fork_builder, _, fork = workloads.erc20_fork_chain(
            workloads.replay_config(), ancestor, branch, w8["txs"],
            w8["holders"])
        build_s = time.perf_counter() - t0
        fork = fresh(fork)
        new_top = fork[-1].number
        new_tip = (new_top, fork[-1].hash, fork[-1].header.state_root)
        fork_nodes = reachable(fork_builder.blockchain.storages,
                               fork[-1].header.state_root)[1]
        # the port's CPU run of the same switch: the recycled count
        t0 = time.perf_counter()
        cpu_bc = Blockchain(Storages(), cfg)
        cpu_bc.load_genesis(spec)
        ReplayDriver(cpu_bc, workloads.replay_config(),
                     device="cpu").replay(fresh(wire))
        cpu_pool = PendingTransactionsPool()
        cpu_mgr = ReorgManager(cpu_bc, cfg, txpool=cpu_pool, driver=ReplayDriver(
            cpu_bc, cfg, device_commit=True, device="cpu"))
        cpu_mgr.switch(ancestor, fresh(fork[ancestor:]))
        cpu_s = time.perf_counter() - t0
        check(tip_of(cpu_bc) == new_tip, f"{name}: the CPU switch's tip")
        # on the card
        bc = load(name, Storages(), cfg)
        drv = driver(bc, cfg)
        windowed(f"{name} base", drv, fresh(wire))
        pool = PendingTransactionsPool()
        mgr = ReorgManager(bc, cfg, driver=drv, txpool=pool)
        before = {k: WINDOW_GAUGES[k] for k in WINDOW_GAUGES}
        batches0 = prefetch.PREFETCH_GAUGES["device_batches"]
        with span_totals() as totals:
            launches.zero()
            t0 = time.perf_counter()
            adopted = mgr.switch(ancestor, fresh(fork[ancestor:]))
            torch.cuda.synchronize()
            switch_s = time.perf_counter() - t0
        spans = {k: v[1] for k, v in totals.items()
                 if k.startswith("reorg.")}
        windowed_adopt = branch >= window
        path = launches.read(name, ("k5",) if windowed_adopt else ("k1r",))
        device_w = WINDOW_GAUGES["device_windows"] - before["device_windows"]
        host_w = WINDOW_GAUGES["host_windows"] - before["host_windows"]
        check(adopted == branch and tip_of(bc) == new_tip,
              f"{name}: landed at {tip_of(bc)[0]}")
        check(host_w == 0 and path["k5"] == device_w
              == (-(-branch // window) if windowed_adopt else 0),
              f"{name}: K5 {path['k5']}, {device_w} device and {host_w} "
              "host windows")
        # every block executed serially (the rebuilt ancestor state, and
        # a short branch's adoption) commits at least one level on K1r
        senders = prefetch.PREFETCH_GAUGES["device_batches"] - batches0
        flush = path["k1r"] - senders
        serial_blocks = mgr.regenerated_blocks + (0 if windowed_adopt
                                                  else branch)
        check(flush >= serial_blocks, f"{name}: K1r launched {path['k1r']} "
              f"({senders} sender batches) for {serial_blocks} serial blocks")
        for b in fork:
            got = bc.get_header_by_number(b.number)
            check(got is not None and got.hash == b.hash,
                  f"{name}: block {b.number} != the fork's")
            check(bc.storages.receipts_storage.get(b.number)
                  == fork_builder.blockchain.storages.receipts_storage.get(
                      b.number), f"{name}: block {b.number}'s receipts")
        report, nodes = reachable(bc.storages, new_tip[2])
        check(report.missing == 0 and report.corrupt == 0
              and nodes == fork_nodes, f"{name}: reachable nodes != the "
              "host-built fork's")
        check(mgr.recycled_txs == cpu_mgr.recycled_txs > 0
              and [t.hash for t in pool.pending()]
              == [t.hash for t in cpu_pool.pending()],
              f"{name}: recycled {mgr.recycled_txs}, the CPU run "
              f"{cpu_mgr.recycled_txs}")
        check(bc.storages.window_journal.pending() == [],
              f"{name}: journal intents pending")
        launches.zero()
        bad = drv._mirror.verify()
        torch.cuda.synchronize()
        launches.read(f"{name} mirror verify", ("k4",))
        check(bad == 0, f"{name}: mirror verify found {bad}")
        emit({"phase": "reorg_erc20", "depth": depth, "ancestor": ancestor,
              "adopted": branch, "adoption": "windowed (K5)"
              if windowed_adopt else "block by block (K1r)",
              "switch_seconds": switch_s,
              "rollback_seconds": spans.get("reorg.rollback"),
              "adopt_seconds": spans.get("reorg.adopt"),
              "regenerated_blocks": mgr.regenerated_blocks,
              "regenerate_seconds": spans.get("reorg.regenerate"),
              "orphaned_blocks": mgr.orphaned_blocks,
              "recycled_txs": mgr.recycled_txs,
              "cpu_recycled_txs": cpu_mgr.recycled_txs,
              "pool_size": len(pool), "device_windows": device_w,
              "host_windows": host_w, "k1r_flush_launches": flush,
              "k1r_sender_launches": senders, "launches": path,
              "fork_build_seconds": build_s, "cpu_switch_seconds": cpu_s})
        del bc, drv, mgr, cpu_bc, cpu_mgr
    # a kill at each reorg seam of the depth-8 switch, then recover: the
    # node lands on exactly the old chain or exactly the new one, with no
    # block record above its tip, and a roll-forward re-executes the
    # staged branch through K1r on the card
    fork_receipts = fork_builder.blockchain.storages.receipts_storage
    for site, after in (("reorg.intent", 0), ("reorg.rollback", 2),
                        ("reorg.adopt", 0), ("reorg.finalize", 0)):
        name = f"reorg_erc20 {site}"
        bc = load(name, Storages(), cfg)
        drv = driver(bc, cfg)
        windowed(f"{name} base", drv, fresh(wire))
        mgr = ReorgManager(bc, cfg, driver=drv,
                           txpool=PendingTransactionsPool())
        plan = FaultPlan(seed=args.seed, rules=[FaultRule(
            site, "die", after=after, times=1)])
        host0 = WINDOW_GAUGES["host_windows"]
        launches.zero()
        died = False
        with active(plan):
            try:
                mgr.switch(ancestor, fresh(fork[ancestor:]))
            except InjectedDeath:
                died = True
        torch.cuda.synchronize()
        killed_path = launches.read(f"{name} killed", ())
        check(died and [s for (s, _, _, _) in plan.fired] == [site],
              f"{name}: fired {plan.fired}")
        batches0 = prefetch.PREFETCH_GAUGES["device_batches"]
        launches.zero()
        t0 = time.perf_counter()
        report = recover(bc, config=cfg, device=dev)
        torch.cuda.synchronize()
        recover_s = time.perf_counter() - t0
        rolled_forward = any("rolled forward" in a for a in report.actions)
        path = launches.read(name, ("k1r",) if rolled_forward else ())
        senders = prefetch.PREFETCH_GAUGES["device_batches"] - batches0
        flush = path["k1r"] - senders
        host_w = WINDOW_GAUGES["host_windows"] - host0
        check(host_w == 0, f"{name}: {host_w} windows on the host")
        check(path["k5"] == 0, f"{name}: recover launched K5")
        if rolled_forward:
            check(flush >= branch, f"{name}: K1r launched {path['k1r']} "
                  f"times ({senders} sender batches) to re-execute "
                  f"{branch} blocks")
        else:
            check(path["k1r"] == 0, f"{name}: recover launched K1r "
                  f"{path['k1r']} times without re-executing a block")
        landed = tip_of(bc)
        check(landed in (old_tip, new_tip), f"{name}: landed on neither "
              f"chain ({landed[0]})")
        check(not rolled_forward or landed == new_tip,
              f"{name}: rolled forward to {landed[0]}")
        for n in range(landed[0] + 1, max(top, new_top) + 2):
            check(bc.get_header_by_number(n) is None
                  and bc.storages.block_body_storage.get(n) is None
                  and bc.storages.receipts_storage.get(n) is None,
                  f"{name}: a block record above the landed tip at #{n}")
        if landed == old_tip:
            same_as_uninterrupted(name, bc, drv)
        else:
            for b in fork:
                got = bc.get_header_by_number(b.number)
                check(got is not None and got.hash == b.hash,
                      f"{name}: block {b.number} != the fork's")
                check(bc.storages.receipts_storage.get(b.number)
                      == fork_receipts.get(b.number),
                      f"{name}: block {b.number}'s receipts")
            walk, nodes = reachable(bc.storages, new_tip[2])
            check(walk.missing == 0 and walk.corrupt == 0
                  and nodes == fork_nodes, f"{name}: reachable nodes != "
                  f"the host-built fork's ({walk})")
            check(bc.storages.window_journal.pending() == [],
                  f"{name}: journal intents pending")
        emit({"phase": "reorg_erc20", "depth": 8, "seam": site,
              "after": after, "landed": "old" if landed == old_tip
              else "new", "best": landed[0],
              "rolled_forward": rolled_forward,
              "reorgs_completed": report.reorgs_completed,
              "reorgs_abandoned": report.reorgs_abandoned,
              "blocks_removed": report.blocks_removed,
              "recover_seconds": recover_s, "host_windows": host_w,
              "k1r_flush_launches": flush, "k1r_sender_launches": senders,
              "killed_run_launches": killed_path, "launches": path})
        del bc, drv, mgr


# The kesque kills of recover_kesque: (seam, hits before the death, the
# thread whose hits count, segment bytes or None for the default). At
# window 8 on the ERC-20 chain the persist stage appends window 1's
# account spill in 9 chunks of 4 KiB, its storage spill in 13 and its
# code in 1: its 28th hit is window 2's account spill, 5 chunks in (a
# frame torn mid-write). At 16 KiB segments its rolls in window 1 are 7,
# so the 8th is window 2's first. The index death is in the checkpoint
# the block source runs once window 1 is saved, at its 6th sidecar.
KESQUE_KILLS = (("kesque.append", 27, "window-persist", None),
                ("kesque.roll", 7, "window-persist", 16 << 10),
                ("kesque.index", 5, None, None))


def kesque_phases(args, torch, dev, launches, w8, rec, fs100k) -> None:
    """replay_erc20_w8_kesque, recover_kesque, compact_kesque and
    segment_ingest_100k: the windowed ERC-20 replay into
    ``Storages("kesque", tmp)`` on the card, read back after a fast open
    and after a full index rebuild; the same replay killed at each kesque
    seam, reopened from its files, recovered and resumed; the replayed
    store compacted under four reader threads; and the 100k fast-sync
    snapshot streamed segment by segment into a fresh kesque store."""
    import glob

    import numpy as np

    from khipu_tpu_torch.base.keccak import keccak256
    from khipu_tpu_torch.chaos import (
        FaultPlan,
        FaultRule,
        InjectedDeath,
        InjectedFault,
        active,
        quiet_deaths,
    )
    from khipu_tpu_torch.domain.blockchain import Blockchain
    from khipu_tpu_torch.native.keccak import keccak256_batch
    from khipu_tpu_torch.storage import kesque, segment
    from khipu_tpu_torch.storage.compactor import verify_reachable
    from khipu_tpu_torch.storage.storages import Storages
    from khipu_tpu_torch.sync.fast_sync import segment_snapshot_ingest
    from khipu_tpu_torch.sync.replay import CollectorDied

    spec, blocks, mem = w8["spec"], w8["blocks"], w8["mem"]
    top, head = blocks[-1].number, blocks[-1].header
    cfg = rec.config()
    reachable_nodes = [(i, k, v) for i, nodes in enumerate(mem["nodes"])
                       for k, v in nodes.items()]

    def node_sources(storages):
        return [getattr(storages, s).source for s in NODE_STORES]

    def small_segments(storages, nbytes):
        for store in storages.kesque_engine._stores.values():
            store.segment_bytes = nbytes

    def disk_bytes(d):
        return sum(os.path.getsize(p) for p in glob.glob(
            os.path.join(d, "kesque", "*", "*")))

    def read_back(name, bc):
        """The reopened store serves the memory run's chain: reachable
        nodes, every header, body and receipt, the best block, and no
        journal intent pending."""
        report, nodes = reachable(bc.storages, head.state_root)
        check(report.missing == 0 and report.corrupt == 0
              and nodes == mem["nodes"], f"{name}: reachable nodes != the "
              f"memory engine's ({report})")
        for i in range(top + 1):
            for store in ("block_header_storage", "block_body_storage",
                          "receipts_storage"):
                got = getattr(bc.storages, store).get(i)
                check((got is not None or i == 0) and got == getattr(
                    mem["chain"].storages, store).get(i),
                    f"{name}: block {i}'s {store}")
        check(bc.best_block_number == top, f"{name}: best block "
              f"{bc.best_block_number}")
        check(bc.storages.window_journal.pending() == [],
              f"{name}: journal intents pending")

    class OnThread(FaultPlan):
        """A plan that counts and fires its seams on one thread's hits
        only (``thread`` None: every thread's): four stage threads append
        at once, and only one of them has a hit count fixed by the data."""

        def __init__(self, thread, **kw):
            super().__init__(**kw)
            self.thread = thread

        def fire(self, site, value=None):
            if (self.thread is not None
                    and threading.current_thread().name != self.thread):
                return value
            return super().fire(site, value)

    def reopen(name, d, seg_bytes=None):
        t0 = time.perf_counter()
        storages = Storages("kesque", d)
        bc = Blockchain(storages, cfg)
        seconds = time.perf_counter() - t0
        if seg_bytes:
            small_segments(storages, seg_bytes)
        return bc, seconds

    tmp = tempfile.mkdtemp(prefix="khipu_kesque_")
    try:
        # replay_erc20_w8_kesque --------------------------------------
        name = "replay_erc20_w8_kesque"
        d = os.path.join(tmp, "replay")
        kept = {}
        run = w8["card_run"](name, spec, blocks, 8, w8["builder"].blockchain,
                             w8["ref"], nodes=mem["nodes"],
                             storages=lambda: Storages("kesque", d),
                             keep=kept)
        storages = kept["chain"].storages
        engine = storages.kesque_engine
        sources = node_sources(storages)
        rng = np.random.default_rng([args.seed, 10])
        picks = rng.integers(0, len(reachable_nodes), 10_000)
        stores = list(engine._stores.values())
        disk0 = sum(st.disk_read_bytes for st in stores)
        served0 = sum(st.value_bytes_returned for st in stores)
        t0 = time.perf_counter()
        for i in picks:
            src, key, value = reachable_nodes[int(i)]
            check(sources[src].get(key) == value,
                  f"{name}: a point read != the memory engine's node")
        reads_s = time.perf_counter() - t0
        read_amp = ((sum(st.disk_read_bytes for st in stores) - disk0)
                    / (sum(st.value_bytes_returned for st in stores)
                       - served0))
        segments = sum(len(rows) for rows in engine.segment_stats().values())
        on_disk = disk_bytes(d)
        storages.stop()
        del kept, storages, engine, sources, stores
        bc, fast_s = reopen(f"{name} reopen", d)
        check(not any(st.rebuilt_index or st.torn_bytes for st in
                      bc.storages.kesque_engine._stores.values())
              and bc.storages.storage_repair_report() == [],
              f"{name}: the reopen with sidecars repaired or rebuilt")
        read_back(f"{name} reopen", bc)
        bc.storages.stop()
        sidecars = glob.glob(os.path.join(d, "kesque", "*", "*.kidx"))
        check(len(sidecars) == len(kesque.NODE_TOPICS) + 8,
              f"{name}: {len(sidecars)} sidecars after stop")
        for path in sidecars:
            os.unlink(path)
        bc, rebuild_s = reopen(f"{name} rebuild", d)
        rebuilt = bc.storages.kesque_engine._stores.values()
        check(all(st.rebuilt_index for st in rebuilt),
              f"{name}: a store opened without its sidecar was not rebuilt")
        read_back(f"{name} rebuild", bc)
        rebuilt_records = sum(st.count for st in rebuilt)
        emit({"phase": name, "window": 8, "engine": "kesque", **run,
              "persist_bytes_per_s_by_engine": {
                  "kesque": run["persist_bytes_per_s"],
                  **w8["persist_bytes_per_s"]},
              "blocks_per_s_by_engine": {"kesque": run["blocks_per_s"],
                                         **w8["blocks_per_s"]},
              "disk_bytes": on_disk, "segments": segments,
              "segment_bytes": kesque.DEFAULT_SEGMENT_BYTES,
              "point_reads": len(picks), "point_read_seconds": reads_s,
              "read_amplification": read_amp,
              "reopen_sidecar_seconds": fast_s,
              "reopen_rebuild_seconds": rebuild_s,
              "rebuilt_records": rebuilt_records,
              "repair_lines": len(bc.storages.storage_repair_report())})
        replayed, replayed_dir = bc, d

        # recover_kesque ------------------------------------------------
        cfg_kill = rec.config(degrade_on_collector_death=False)
        for site, after, thread, seg_bytes in KESQUE_KILLS:
            name = f"recover_kesque {site}"
            d = os.path.join(tmp, site)
            storages = Storages("kesque", d)
            bc = rec.load(name, storages, cfg_kill)
            if seg_bytes:
                small_segments(storages, seg_bytes)
            plan = OnThread(thread, seed=args.seed, rules=[FaultRule(
                site, "die", after=after, times=1)])

            def source():
                """The wire blocks; for the index seam, a checkpoint of
                every sidecar once window 1 is saved (bounded wait), run
                by the thread that pulls the blocks."""
                yield from rec.fresh(rec.wire[:12])
                if site == "kesque.index":
                    deadline = time.monotonic() + 120
                    while storages.app_state.best_block_number < 8:
                        check(time.monotonic() < deadline,
                              f"{name}: window 1 was not saved in time")
                        time.sleep(0.005)
                    storages.kesque_engine.checkpoint()
                yield from rec.fresh(rec.wire[12:])

            launches.zero()
            raised = None
            with active(plan), quiet_deaths():
                try:
                    rec.driver(bc, cfg_kill).replay(source())
                except (CollectorDied, InjectedDeath) as e:
                    raised = e
            torch.cuda.synchronize()
            killed_path = launches.read(f"{name} killed", ())
            check(raised is not None and [f[0] for f in plan.fired] == [site],
                  f"{name}: fired {plan.fired}, stopped by {raised!r}")
            best_before = storages.app_state.best_block_number
            # process death: the files are closed unflushed, no sidecar
            # is written
            for store in storages.kesque_engine._stores.values():
                for seg in store._segments.values():
                    seg.close()
            del bc, storages
            bc, reopen_s = reopen(name, d, seg_bytes)
            engine = bc.storages.kesque_engine
            torn = {t: st.torn_bytes for t, st in engine._stores.items()
                    if st.torn_bytes}
            rebuilt = sorted(t for t, st in engine._stores.items()
                             if st.rebuilt_index)
            report, recover_s = rec.settle(name, bc, cfg_kill)
            lines = [a for a in report.actions if a.startswith("storage: ")]
            for topic, nbytes in torn.items():
                check(f"storage: kesque[{topic}]: torn segment tail "
                      f"truncated ({nbytes} bytes scanned back)" in lines,
                      f"{name}: no storage: line for {topic}'s torn tail")
            check(site != "kesque.append" or torn.get("account", 0) > 0,
                  f"{name}: the account spill was not torn mid-frame")
            drv = rec.driver(bc, cfg)
            resumed = rec.windowed(name, drv,
                                   rec.fresh(rec.wire[bc.best_block_number:]))
            rec.same_as_uninterrupted(name, bc, drv)
            bc.storages.stop()
            line = {"phase": "recover_kesque", "seam": site, "after": after,
                    "thread": thread or "any",
                    "stopped_by": type(raised).__name__,
                    "best_before": best_before,
                    "best_after": report.best_after,
                    "scanned": report.scanned, "repaired": report.repaired,
                    "rolled_back": report.rolled_back,
                    "torn_bytes": sum(torn.values()), "torn_topics": torn,
                    "rebuilt_topics": rebuilt, "storage_lines": len(lines),
                    "reopen_seconds": reopen_s,
                    "recover_ms": recover_s * 1e3,
                    "resume_blocks": resumed["blocks"],
                    "resume_blocks_per_s": resumed["blocks_per_s"],
                    "resume_device_windows": resumed["device_windows"],
                    "killed_run_launches": killed_path,
                    "launches": resumed["launches"]}
            if seg_bytes:
                line["reduced"] = (f"segment_bytes {seg_bytes} (default "
                                   f"{kesque.DEFAULT_SEGMENT_BYTES}) so that "
                                   "a window's spill rolls segments")
            emit(line)
            del bc, drv, engine

        # compact_kesque ------------------------------------------------
        name = "compact_kesque"
        storages = replayed.storages
        engine = storages.kesque_engine
        sources = node_sources(storages)
        root = head.state_root

        def totals(stats):
            rows = [r for t in kesque.NODE_TOPICS for r in stats.get(t, [])]
            return {"segments": len(rows),
                    "live_bytes": sum(r["live_bytes"] for r in rows),
                    "garbage_bytes": sum(r["garbage_bytes"] for r in rows)}

        def all_equal():
            return all(sources[i].get(k) == v for i, k, v in reachable_nodes)

        raised = None
        with active(FaultPlan(seed=args.seed, rules=[FaultRule(
                "kesque.compact", "raise", times=1)])):
            try:
                engine.compact(root)
            except InjectedFault as e:
                raised = e
        check(raised is not None and engine.compactions == 0 and all_equal(),
              f"{name}: the store after a kesque.compact raise")
        before = totals(engine.segment_stats())
        stop, wrong, reads = threading.Event(), [], [0] * 4

        def reader(j):
            while not stop.is_set():
                for i, k, v in reachable_nodes:
                    if sources[i].get(k) != v:
                        wrong.append(k)
                    reads[j] += 1

        threads = [threading.Thread(target=reader, args=(j,), daemon=True)
                   for j in range(4)]
        for t in threads:
            t.start()
        t0 = time.perf_counter()
        try:
            report = engine.compact(root)
        finally:
            compact_s = time.perf_counter() - t0
            stop.set()
            for t in threads:
                t.join(timeout=60)
        check(not any(t.is_alive() for t in threads), f"{name}: a reader "
              "thread did not stop")
        check(not wrong and sum(reads) > 0, f"{name}: {len(wrong)} of "
              f"{sum(reads)} concurrent reads were wrong")
        check(report.reclaimed_bytes > 0 and report.missing == 0
              and report.corrupt == 0
              and report.total == len(reachable_nodes), f"{name}: {report}")
        after = totals(engine.segment_stats())
        walk = verify_reachable(storages.account_node_storage,
                                storages.storage_node_storage,
                                storages.evmcode_storage, root,
                                verify_hashes=True)
        check(walk.missing == 0 and walk.corrupt == 0, f"{name}: {walk}")
        storages.stop()
        del replayed, storages, engine, sources
        bc, reopen_s = reopen(name, replayed_dir)
        walk = verify_reachable(bc.storages.account_node_storage,
                                bc.storages.storage_node_storage,
                                bc.storages.evmcode_storage, root,
                                verify_hashes=True)
        check(walk.missing == 0 and walk.corrupt == 0
              and bc.storages.storage_repair_report() == [],
              f"{name}: after reopening: {walk}")
        read_back(f"{name} reopen", bc)
        bc.storages.stop()
        emit({"phase": name, "seconds": compact_s,
              "reclaimed_bytes": report.reclaimed_bytes,
              "copied_nodes": report.total, "before": before,
              "after": after, "concurrent_reads": sum(reads),
              "reader_threads": len(threads),
              "disk_bytes_after": disk_bytes(replayed_dir),
              "reopen_seconds": reopen_s, "raise_then_compact": True})
        del bc

        # segment_ingest_100k -------------------------------------------
        name = "segment_ingest_100k"
        root, snapshot = fs100k["root"], fs100k["stores"]
        n_nodes = sum(len(s) for s in snapshot)
        src = kesque.KesqueEngine(os.path.join(tmp, "ingest_src"),
                                  segment_bytes=128 << 10)
        t0 = time.perf_counter()
        for topic, nodes in zip(kesque.NODE_TOPICS, snapshot):
            src.store(topic).append_batch([], nodes)
        source_s = time.perf_counter() - t0
        manifest = src.list_segments()
        target = Storages("kesque", os.path.join(tmp, "ingest_dst"))
        with span_totals() as totals:
            launches.zero()
            t0 = time.perf_counter()
            report = segment_snapshot_ingest(
                target, src.list_segments, src.read_chunk,
                target_root=root, workers=4, chunk_bytes=1 << 20)
            ingest_s = time.perf_counter() - t0
        path = launches.read(name, ())
        stream_s = totals["fastsync.segment_ingest"][1]
        check(report.records == n_nodes and report.corrupt_frames == 0
              and report.segments == len(manifest), f"{name}: {report}")
        check(report.missing == 0 and report.corrupt_nodes == 0
              and report.verified_nodes == n_nodes
              and target.app_state.fast_sync_done, f"{name}: the walk "
              f"after ingest: {report}")
        for store, nodes in zip(node_sources(target), snapshot):
            check(store.count == len(nodes), f"{name}: a target store holds "
                  f"{store.count} of {len(nodes)} nodes")
        target.stop()
        # one flipped byte in a shipped chunk: a frame that fails its CRC
        # ends the chunk's scan; a frame whose tag is bent (its CRC made
        # anew) is counted corrupt; neither record lands under any key
        raw, _, _ = src.read_chunk("account", manifest[0][1], 0, 1 << 20)
        frames, _ = segment.scan_frames(raw)
        mid = len(frames) // 2
        off, payload = frames[mid]
        want_key = keccak256(payload[1:])
        bent = bytearray(raw)
        bent[off + segment.FRAME_HEADER + len(payload) // 2] ^= 0x01
        retagged = (raw[:off] + segment.frame(b"\x4f" + payload[1:])
                    + raw[off + segment.FRAME_HEADER + len(payload):])
        flipped = {}
        for label, chunk, want in (("crc", bytes(bent), (mid, 0)),
                                   ("tag", retagged, (len(frames) - 1, 1))):
            eng = kesque.KesqueEngine(os.path.join(tmp, f"flip_{label}"))
            got = eng.ingest_chunk("account", chunk)
            check(got == want and eng.store("account").get(want_key) is None
                  and all(keccak256(eng.store("account").get(k)) == k
                          for k in eng.store("account").keys()),
                  f"{name}: a chunk with a flipped {label} byte gave {got}, "
                  f"want {want}")
            flipped[label] = {"records": got[0], "corrupt": got[1]}
            eng.stop()
        src.stop()
        # the admission hash's GIL: one thread against four on the
        # snapshot's values
        values = [v for nodes in snapshot for v in nodes.values()]
        t0 = time.perf_counter()
        keccak256_batch(values)
        one_s = time.perf_counter() - t0
        parts = [values[j::4] for j in range(4)]
        pool = [threading.Thread(target=keccak256_batch, args=(p,))
                for p in parts]
        t0 = time.perf_counter()
        for t in pool:
            t.start()
        for t in pool:
            t.join()
        four_s = time.perf_counter() - t0
        sync_s = fs100k["seconds"]
        emit({"phase": name, "nodes": n_nodes, "segments": len(manifest),
              "segment_bytes": 128 << 10, "chunk_bytes": 1 << 20,
              "workers": 4, "records": report.records,
              "bytes": report.bytes, "source_append_seconds": source_s,
              "seconds": ingest_s, "stream_seconds": stream_s,
              "stream_mb_per_s": report.bytes / stream_s / 1e6,
              "walk_seconds": ingest_s - stream_s,
              "fast_sync_seconds": sync_s,
              "fast_sync_over_ingest": sync_s / ingest_s,
              "targets": "segment ingest: Storages('kesque') on disk, the "
              "host batch hash; fast_sync: memory Storages with a "
              "DeviceNodeMirror, K1r content checks and a K4 verify",
              "corrupt_frames": report.corrupt_frames,
              "walk_missing": report.missing,
              "walk_corrupt": report.corrupt_nodes, "flipped_byte": flipped,
              "batch_hash_one_thread_s": one_s,
              "batch_hash_four_threads_s": four_s, "launches": path})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


LIVE_SYNC_SERVERS = 3  # one of them never answers GetNodeData
LIVE_SYNC_PIVOT_OFFSET = 16
LIVE_SYNC_WINDOW = 8
LIVE_SYNC_BATCH = 16


def live_sync_phase(args, torch, dev, launches, chain100k) -> dict:
    """live_sync_erc20_100k: a fresh node brought up over RLPx on
    127.0.0.1 from three port nodes serving replay_erc20_100k_w8's chain
    (one never answers GetNodeData): ``FastSyncService(device=None)`` to
    the pivot (median best - 16), ``RegularSyncService(device=None,
    batch_size=16)`` at window 8 to the servers' best (one windowed
    import of two windows), then a block sealed by a server-side
    ``Miner(peer_manager=)`` and pushed over NewBlock, imported block by
    block on the client's reader thread while the pull loop stays idle.
    Gates: the head root and the reachable nodes equal the server's,
    headers, bodies and receipts equal, a peer blacklisted, K1r = the
    content checks + the push's flush levels + the sender batches, K5 =
    2 device windows and no host window, mirror verify 0, no fall-back
    log line."""
    from khipu_tpu_torch import workloads
    from khipu_tpu_torch.base import aes as aes_oracle
    from khipu_tpu_torch.base.secp256k1 import privkey_to_pubkey
    from khipu_tpu_torch.domain.blockchain import Blockchain
    from khipu_tpu_torch.domain.transaction import recover_senders
    from khipu_tpu_torch.ledger.window import WINDOW_GAUGES
    from khipu_tpu_torch.mining import Miner
    from khipu_tpu_torch.native import aes
    from khipu_tpu_torch.network import peer as peer_mod
    from khipu_tpu_torch.network import snappy_codec
    from khipu_tpu_torch.network.host_service import HostService
    from khipu_tpu_torch.network.messages import (
        ETH_OFFSET,
        GET_NODE_DATA,
        Status,
    )
    from khipu_tpu_torch.network.peer import PeerManager
    from khipu_tpu_torch.storage.storages import Storages
    from khipu_tpu_torch.sync import prefetch
    from khipu_tpu_torch.sync.fast_sync_service import FastSyncService
    from khipu_tpu_torch.sync.regular_sync import RegularSyncService
    from khipu_tpu_torch.sync.replay import PIPELINE_GAUGES
    from khipu_tpu_torch.txpool import PendingTransactionsPool

    name = "live_sync_erc20_100k"
    builder, spec, blocks = chain100k
    server_bc = builder.blockchain
    best = blocks[-1].number
    pivot_want = best - LIVE_SYNC_PIVOT_OFFSET
    cfg = workloads.replay_config(
        commit_window_blocks=LIVE_SYNC_WINDOW,
        min_peers_to_choose_pivot=LIVE_SYNC_SERVERS,
        pivot_block_offset=LIVE_SYNC_PIVOT_OFFSET,
        nodes_per_request=100, peer_request_timeout=1.0)

    def status_of(bc):
        def make():
            n = bc.best_block_number
            return Status(63, 1, bc.get_total_difficulty(n) or 0,
                          bc.get_hash_by_number(n), bc.get_hash_by_number(0))
        return make

    # native AES beside the pure-Python oracle, on the host
    data = os.urandom(16 << 20)
    t0 = time.perf_counter()
    aes.ctr_crypt(b"k" * 32, b"\x00" * 16, data)
    aes_mb_s = len(data) / (time.perf_counter() - t0) / 1e6
    t0 = time.perf_counter()
    aes_oracle.ctr_crypt(b"k" * 32, b"\x00" * 16, data[:1 << 16])
    aes_py_mb_s = (1 << 16) / (time.perf_counter() - t0) / 1e6

    # snappy decompress runs in Python on every received frame: time it
    unsnap = {"calls": 0, "seconds": 0.0, "bytes": 0}
    real_decompress = snappy_codec.decompress

    def timed_decompress(payload, *a, **k):
        t = time.perf_counter()
        out = real_decompress(payload, *a, **k)
        unsnap["seconds"] += time.perf_counter() - t
        unsnap["calls"] += 1
        unsnap["bytes"] += len(out)
        return out

    managers = []
    servers = []
    logs = []
    peer_mod.snappy_codec.decompress = timed_decompress
    try:
        for i in range(LIVE_SYNC_SERVERS):
            priv = (0x5E7E0 + i).to_bytes(32, "big")
            m = PeerManager(priv, f"khipu-tpu-torch/server{i}",
                            status_of(server_bc))
            managers.append(m)
            HostService(server_bc).install(m)
            if i == LIVE_SYNC_SERVERS - 1:
                # takes every GetNodeData and never answers
                m.handlers[ETH_OFFSET + GET_NODE_DATA] = lambda body: None
            servers.append((m, m.listen(), privkey_to_pubkey(priv)))

        client_bc = Blockchain(Storages(), cfg)
        launches.zero()
        t0 = time.perf_counter()
        client_bc.load_genesis(spec, on_device=True, device=dev)
        torch.cuda.synchronize()
        genesis_s = time.perf_counter() - t0
        genesis = launches.read(f"{name} genesis", ("k1r",))
        client = PeerManager((0xC11E47).to_bytes(32, "big"),
                             "khipu-tpu-torch/client", status_of(client_bc))
        managers.append(client)
        wire = {"up": 0, "down": 0}
        handshake_ms = []
        for _, port, pub in servers:
            t0 = time.perf_counter()
            peer = client.connect("127.0.0.1", port, pub, timeout=10.0)
            handshake_ms.append((time.perf_counter() - t0) * 1e3)
            codec = peer.codec
            write, read = codec.write_frame, codec.read_frame

            def counted_write(frame, _write=write):
                out = _write(frame)
                wire["up"] += len(out)
                return out

            def counted_read(size, ct_mac, _read=read):
                wire["down"] += 32 + len(ct_mac)
                return _read(size, ct_mac)

            codec.write_frame, codec.read_frame = counted_write, counted_read

        # fast sync: pivot, state download (content checks: K1r), backfill
        svc = FastSyncService(client_bc, cfg, client, log=logs.append)
        split = {"pivot": 0.0, "backfill": 0.0}

        def timed(key, fn):
            def run(*a, **k):
                t = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    split[key] += time.perf_counter() - t
            return run

        pivots = []
        choose = svc.choose_pivot

        def choose_and_keep():
            pivots.append(choose())
            return pivots[-1]

        svc.choose_pivot = timed("pivot", choose_and_keep)
        svc._backfill_blocks = timed("backfill", svc._backfill_blocks)
        with span_totals() as totals:
            launches.zero()
            t0 = time.perf_counter()
            state = svc.run()
            torch.cuda.synchronize()
            fast_s = time.perf_counter() - t0
            fast = launches.read(f"{name} fast sync", ("k1r",))
        verify_calls = totals["fastsync.verify"][0]
        pivot = pivots[-1].number
        check(pivot == pivot_want, f"{name}: pivot {pivot} != {pivot_want}")
        check(fast["k1r"] == verify_calls and fast["k5"] == fast["k4"] == 0,
              f"{name}: fast sync launched {fast} for {verify_calls} "
              "content checks")
        check(svc.pool.blacklisted >= 1
              and client.blacklist.is_blacklisted(servers[-1][2]),
              f"{name}: the stalling server was not blacklisted")
        check(client_bc.best_block_number == pivot,
              f"{name}: best {client_bc.best_block_number} after fast sync")
        for n in range(1, pivot + 1):
            for store in ("block_header_storage", "block_body_storage",
                          "receipts_storage"):
                check(getattr(client_bc.storages, store).get(n)
                      == getattr(server_bc.storages, store).get(n),
                      f"{name}: backfilled block {n}'s {store}")
        wire_fast = dict(wire)

        # regular sync: one full batch through the windowed device commit
        sync = RegularSyncService(client_bc, cfg, client,
                                  batch_size=LIVE_SYNC_BATCH,
                                  request_timeout=10.0, log=logs.append)
        prefetch.flush_sender_cache()
        before = {"batches": prefetch.PREFETCH_GAUGES["device_batches"],
                  "device_windows": WINDOW_GAUGES["device_windows"],
                  "host_windows": WINDOW_GAUGES["host_windows"],
                  "deaths": PIPELINE_GAUGES["collector_deaths"]}
        # every block the round hands to the per-block import (a heal,
        # a refused or shorter window): none is wanted here
        per_block, real_healing = [0], sync._import_healing

        def counting_healing(peer, block):
            per_block[0] += 1
            return real_healing(peer, block)

        sync._import_healing = counting_healing
        with span_totals() as totals:
            launches.zero()
            t0 = time.perf_counter()
            sync.run(until=lambda: client_bc.best_block_number >= best,
                     max_seconds=300)
            torch.cuda.synchronize()
            regular_s = time.perf_counter() - t0
            sync._import_healing = real_healing
            reg = launches.read(f"{name} regular sync", ("k5",))
        spans = {k: v[1] for k, v in totals.items()}
        fetch_s = spans.get("sync.fetch.headers", 0.0) + spans.get(
            "sync.fetch.bodies", 0.0)
        device_w = WINDOW_GAUGES["device_windows"] - before["device_windows"]
        host_w = WINDOW_GAUGES["host_windows"] - before["host_windows"]
        senders = prefetch.PREFETCH_GAUGES["device_batches"] - before["batches"]
        windows = (best - pivot) // LIVE_SYNC_WINDOW
        check(PIPELINE_GAUGES["collector_deaths"] == before["deaths"],
              f"{name}: a collector died")
        check(per_block[0] == 0,
              f"{name}: {per_block[0]} blocks imported per block in the "
              "windowed import")
        check(device_w == windows == 2 and host_w == 0 and reg["k5"] == 2,
              f"{name}: K5 {reg['k5']} for {device_w} device + {host_w} "
              "host windows (2 device windows wanted)")
        check(reg["k1r"] == senders,
              f"{name}: K1r launched {reg['k1r']} times in regular sync for "
              f"{senders} sender batches: a trie commit launched K1r")
        launches.zero()
        bad = sync._driver._mirror.verify()
        torch.cuda.synchronize()
        verify = launches.read(f"{name} mirror verify", ("k4",))
        check(bad == 0, f"{name}: mirror verify found {bad}")

        # the push: a server seals the next block and propagates it; the
        # client imports it on a reader thread, K1r a trie level
        sync.install_new_block_handler()
        drv = sync._driver
        levels, push_ms = [0], []
        real_hasher, real_import = drv.hasher, drv._execute_and_insert

        def counting_hasher(msgs):
            if len(msgs):
                levels[0] += 1
            return real_hasher(msgs)

        def timed_import(block, stats):
            t = time.perf_counter()
            real_import(block, stats)
            torch.cuda.synchronize()
            push_ms.append((time.perf_counter() - t) * 1e3)

        drv.hasher, drv._execute_and_insert = counting_hasher, timed_import
        pool = PendingTransactionsPool()
        txs = workloads.erc20_transfers(best - 1, 200, 256)
        recover_senders(txs)
        for stx in txs:
            pool.add(stx)
        miner = Miner(server_bc, workloads.replay_config(), pool,
                      workloads.COINBASE, peer_manager=servers[0][0])
        batches0 = prefetch.PREFETCH_GAUGES["device_batches"]
        launches.zero()
        t0 = time.perf_counter()
        sealed = miner.mine_next()
        seal_s = time.perf_counter() - t0
        deadline = time.monotonic() + 60
        while (client_bc.best_block_number < sealed.number
               and sync._push_error is None and time.monotonic() < deadline
               and not any("rejected" in m for m in logs)):
            time.sleep(0.01)
        torch.cuda.synchronize()
        push = launches.read(f"{name} pushed block", ("k1r",))
        check(sync._push_error is None,
              f"{name}: the pushed import failed: {sync._push_error!r}")
        check(client_bc.best_block_number == sealed.number == best + 1
              and len(sealed.body.transactions) == len(txs),
              f"{name}: the pushed block {sealed.number} did not land "
              f"(best {client_bc.best_block_number})")
        push_senders = prefetch.PREFETCH_GAUGES["device_batches"] - batches0
        check(push["k1r"] == levels[0] + push_senders and levels[0] > 0
              and push["k5"] == 0,
              f"{name}: the push launched {push} for {levels[0]} flush "
              f"levels and {push_senders} sender batches")
        drv.hasher, drv._execute_and_insert = real_hasher, real_import

        head = sealed.header.state_root
        check(client_bc.get_header_by_number(sealed.number).state_root
              == server_bc.get_header_by_number(sealed.number).state_root
              == head, f"{name}: the head root differs from the server's")
        report, nodes = reachable(client_bc.storages, head)
        _, server_nodes = reachable(server_bc.storages, head)
        check(report.missing == 0 and report.corrupt == 0
              and nodes == server_nodes,
              f"{name}: reachable nodes at the head != the server's "
              f"({report})")
        for n in range(pivot + 1, sealed.number + 1):
            check(client_bc.storages.receipts_storage.get(n)
                  == server_bc.storages.receipts_storage.get(n),
                  f"{name}: block {n}'s receipts differ")
        # the port's lines for a heal, a refused batch or block, and a
        # round or push that failed: none is wanted in this phase
        off_path = [m for m in logs if any(w in m for w in (
            "per block", "failed locally", "failed mid-round", "rejected",
            "device error"))]
        check(not off_path, f"{name}: {off_path}")
    finally:
        peer_mod.snappy_codec.decompress = real_decompress
        for m in managers:
            m.stop()
    regular_blocks = best - pivot
    return {
        "phase": name, "card": card_line(),
        "accounts": len(spec.alloc), "servers": LIVE_SYNC_SERVERS,
        "stalling_servers": 1, "blacklisted": svc.pool.blacklisted,
        "pivot": pivot, "best": client_bc.best_block_number,
        "nodes_downloaded": state.downloaded_nodes,
        "fast_sync_seconds": fast_s,
        "fast_sync_split_s": {"pivot": split["pivot"],
                              "state_download": fast_s - split["pivot"]
                              - split["backfill"],
                              "backfill": split["backfill"]},
        "nodes_per_s": state.downloaded_nodes / max(
            fast_s - split["pivot"] - split["backfill"], 1e-9),
        "content_checks": verify_calls,
        "wire_bytes": {"fast_sync": wire_fast, "total": dict(wire)},
        "handshake_ms": handshake_ms,
        "aes_native_mb_per_s": aes_mb_s, "aes_python_mb_per_s": aes_py_mb_s,
        "snappy_decompress": {**unsnap, "mb_per_s": unsnap["bytes"] / max(
            unsnap["seconds"], 1e-9) / 1e6},
        "regular_blocks": regular_blocks, "regular_seconds": regular_s,
        "regular_blocks_per_s": regular_blocks / regular_s,
        "regular_split_s": {"fetch": fetch_s, "import": regular_s - fetch_s},
        "regular_spans_s": spans,
        "windows": windows, "device_windows": device_w, "host_windows": host_w,
        "sender_batches": senders, "per_block_imports": per_block[0],
        "mirror_verify": bad,
        "pushed_block": sealed.number, "pushed_txs": len(sealed.body.transactions),
        "seal_seconds": seal_s, "pushed_import_ms": push_ms,
        "pushed_flush_levels": levels[0], "pushed_sender_batches": push_senders,
        "genesis_seconds": genesis_s,
        "launches": {"genesis": genesis, "fast_sync": fast,
                     "regular_sync": reg, "mirror_verify": verify,
                     "pushed_block": push},
        "reduced": f"the {len(blocks) - 1}-block ERC-20 chain of "
        "replay_erc20_100k_w8 over its genesis of "
        f"{args.accounts:,} bulk accounts, served by three nodes in this "
        "process over loopback, in place of a mainnet peer set",
    }


# serve_erc20_100k_w8's load steps (bench.py --serve's full counts):
# (step, profile, clients, requests a client, seed, total requests/s).
# A and B run open-loop at rates that stretch them over ~4 and ~5 s, so
# that they overlap the import's window publishes and retirements (on
# an H100 80GB HBM3 at 700 W the import took 10.4-15.8 s under load, and
# closed-loop A and B ended in 0.06-0.24 s, inside its first window;
# PERF.md §6); C is the closed-loop overload step
SERVE_STEPS = (("A", "MIXED", 2, 200, 11, 100.0),
               ("B", "MIXED", 4, 250, 22, 200.0),
               ("C", "MIXED", 16, 75, 33, None))
SERVE_HTTP = ("D", "READ_ONLY", 4, 50, 44, None)
SERVE_WINDOW = 8
SERVE_LOG_BLOCKS = 2  # blocks whose token emits the Transfer event
SERVE_FORK_BLOCKS = 3  # the heavier branch over the last two blocks
SERVE_WAIT_S = 300.0


def serve_phase(torch, dev, launches, chain100k, unloaded_bps) -> list:
    """serve_erc20_100k_w8: a port node serving JSON-RPC while it imports
    on the card (``bench.py --serve`` on the port, at its full request
    counts). A ``ServiceBoard`` on the memory engine at
    replay_erc20_100k_w8's genesis (loaded on the card, K1r a level),
    ``start_serving()`` and ``start_rpc(port=0)``; ``ReplayDriver(...,
    device_commit=True, read_view=plane.read_view)`` imports that chain
    and two more blocks calling a token that emits the Transfer event at
    window 8 on a thread (K5 a window, K1r a sender batch, K4 after),
    its last window held until load step B is done; ``ReplicaDriver("r1",
    PrimaryFeed(...))`` tails the primary throughout (K1r a trie level
    a block). The load: ``LoadGenerator`` over ``InProcessTransport``
    with the checker on (nonces of the chain's senders, the coinbase's
    balance), MIXED 2 x 200 and 4 x 250 at open-loop rates that span
    the import's windows, 16 x 75 closed-loop, then READ_ONLY 4 x 50
    over ``HttpTransport``. Each step's line has the blocks the view
    published and retired while it ran, and the store reads that fell
    below best (the save stage inside a window). Then a switch at depth
    2 to the reorg_erc20-style fork (the ancestor inside the last window: its
    state is rebuilt first, K1r): a log filter installed before it must
    return the retracted logs with ``removed: true``, and the replica
    mirrors the switch. Returns the phase's lines."""
    from khipu_tpu_torch import workloads
    from khipu_tpu_torch.config import ServingConfig
    from khipu_tpu_torch.domain.block import Block
    from khipu_tpu_torch.observability.journey import JOURNEY
    from khipu_tpu_torch.serving import loadgen
    from khipu_tpu_torch.serving.admission import classify_method
    from khipu_tpu_torch.serving.replica import PrimaryFeed, ReplicaDriver
    from khipu_tpu_torch.service_board import ServiceBoard
    from khipu_tpu_torch.sync.chain_builder import ChainBuilder
    from khipu_tpu_torch.sync.reorg import ReorgManager
    from khipu_tpu_torch.sync.replay import ReplayDriver

    name = "serve_erc20_100k_w8"
    builder, spec, blocks = chain100k
    server_bc = builder.blockchain
    top = blocks[-1].number
    # the bench's serving posture: a short admission queue and wait
    cfg = dataclasses.replace(
        workloads.replay_config(commit_window_blocks=SERVE_WINDOW),
        serving=ServingConfig(queue_timeout=0.004, max_queue=4))
    # on the source chain's block ``top``: the token tip, then the fork
    t0 = time.perf_counter()
    tip_builder = ChainBuilder.from_head(server_bc, cfg)
    tip_builder.head = server_bc.get_block_by_number(top)
    token, tip = workloads.erc20_log_blocks(tip_builder, top - 1,
                                            SERVE_LOG_BLOCKS, 200, 256)
    fork_builder = ChainBuilder.from_head(server_bc, cfg)
    fork_builder.head = server_bc.get_block_by_number(top)
    fork = [fork_builder.add_block(
        workloads.erc20_transfers(top - 1 + i, 200, 256, forked=True),
        coinbase=workloads.FORK_COINBASE) for i in range(SERVE_FORK_BLOCKS)]
    build_s = time.perf_counter() - t0
    wire = [Block.decode(b.encode()) for b in list(blocks) + tip]
    fork_wire = [Block.decode(b.encode()) for b in fork]
    best = wire[-1].number
    windows = -(-len(wire) // SERVE_WINDOW)
    _, senders = workloads.replay_keys(200, seed_base=501)

    launches.zero()
    JOURNEY.reset()
    JOURNEY.enable(capacity=16_384)
    t0 = time.perf_counter()
    board = ServiceBoard(cfg, genesis=spec, device=dev)
    torch.cuda.synchronize()
    board_s = time.perf_counter() - t0
    replica = None
    try:
        plane = board.start_serving()
        port = board.start_rpc(port=0)
        server = board._rpc_server
        view = plane.read_view
        # counts the store reads that met the save stage inside a window
        # (the committed header below best); read, never gated
        below = {"reads": 0, "below_best": 0}
        below_lock = threading.Lock()
        committed_header = view.committed_header

        def counted_header():
            header = committed_header()
            with below_lock:
                below["reads"] += 1
                if header.number < board.blockchain.best_block_number:
                    below["below_best"] += 1
            return header

        view.committed_header = counted_header
        driver = ReplayDriver(board.blockchain, cfg, device_commit=True,
                              device=dev, read_view=view)
        t0 = time.perf_counter()
        replica = ReplicaDriver("r1", PrimaryFeed(board.blockchain), cfg,
                                spec, device=dev)
        replica_genesis_s = time.perf_counter() - t0
        replica.start()

        b_done = threading.Event()
        sync_done = threading.Event()
        held = {"at": (len(wire) - 1) // SERVE_WINDOW * SERVE_WINDOW,
                "seconds": 0.0}
        outcome = {}

        def source():
            for i, b in enumerate(wire):
                if i == held["at"]:
                    # the last window waits for step B: the import spans
                    # steps A and B
                    t = time.perf_counter()
                    b_done.wait(SERVE_WAIT_S)
                    held["seconds"] = time.perf_counter() - t
                yield b

        def run_import():
            try:
                outcome["stats"] = driver.replay(source())
            except BaseException as e:  # noqa: BLE001 — re-raised below
                outcome["error"] = e
            finally:
                sync_done.set()

        def gen(transport, profile, clients, requests, seed, rate):
            return loadgen.LoadGenerator(
                transport, getattr(loadgen, profile), clients=clients,
                seed=seed, max_requests=requests, rate=rate,
                nonce_addresses=["0x" + a.hex() for a in senders],
                balance_addresses=["0x" + workloads.COINBASE.hex()],
                client_keys=[(0x5E1E_0000 + 1000 * seed + i).to_bytes(
                    32, "big") for i in range(clients)], chain_id=1)

        def step_line(step, profile, clients, requests, rate, report, mid,
                      before, after, reads):
            by_class = {}
            for method, vals in report.latencies.items():
                by_class.setdefault(classify_method(method), []).extend(vals)
            classes = {}
            for cls, vals in sorted(by_class.items()):
                vals.sort()
                classes[cls] = {
                    "requests": len(vals),
                    "p50_ms": vals[len(vals) // 2] * 1e3,
                    "p99_ms": vals[min(len(vals) - 1,
                                       int(0.99 * len(vals)))] * 1e3}
            return {"step": step, "profile": profile, "clients": clients,
                    "requests_per_client": requests,
                    "loop": "open" if rate else "closed", "rate": rate,
                    "requests": report.requests, "ok": report.ok,
                    "shed": report.shed, "errors": report.errors,
                    "violations": len(report.violations),
                    "seconds": report.seconds, "qps": report.qps,
                    "p50_ms": report.p50() * 1e3,
                    "p99_ms": report.p99() * 1e3, "classes": classes,
                    "mid_import": mid,
                    "published_during": after["published"]
                    - before["published"],
                    "retired_during": after["retired"] - before["retired"],
                    "store_reads": reads[0],
                    "store_reads_below_best": reads[1],
                    "replica_lag_blocks": replica.lag_blocks(),
                    "transport_overhead": report.transport_overhead}

        sync_thread = threading.Thread(target=run_import, name="serve-import",
                                       daemon=True)
        t_import = time.perf_counter()
        sync_thread.start()
        steps, reports = [], {}
        inproc = loadgen.InProcessTransport(server)

        def run_step(transport, step, profile, clients, requests, seed,
                     rate):
            before = view.snapshot()
            with below_lock:
                reads = (below["reads"], below["below_best"])
            try:
                report = gen(transport, profile, clients, requests, seed,
                             rate).run()
            finally:
                if step == "B":
                    b_done.set()
            mid = not sync_done.is_set()
            after = view.snapshot()
            with below_lock:
                reads = (below["reads"] - reads[0],
                         below["below_best"] - reads[1])
            reports[step] = report
            steps.append(step_line(step, profile, clients, requests, rate,
                                   report, mid, before, after, reads))

        for step in SERVE_STEPS:
            run_step(inproc, *step)
        b_done.set()
        sync_thread.join(SERVE_WAIT_S)
        import_s = time.perf_counter() - t_import
        check(not sync_thread.is_alive(), f"{name}: the import did not end")
        if "error" in outcome:
            raise outcome["error"]
        stats = outcome["stats"]
        torch.cuda.synchronize()
        snap_import = view.snapshot()
        run_step(loadgen.HttpTransport(f"http://127.0.0.1:{port}"),
                 *SERVE_HTTP)
        mirror_bad = driver._mirror.verify()

        # the replica reaches the head; the switch, with a log filter
        # installed before it
        check(replica.ensure_height(best, SERVE_WAIT_S),
              f"{name}: the replica did not reach block {best}")

        def call(method, *params):
            resp = server.handle({"jsonrpc": "2.0", "id": 1,
                                  "method": method, "params": list(params)})
            check("error" not in resp, f"{name}: {method}: {resp}")
            return resp["result"]

        fid = call("eth_newFilter", {"fromBlock": hex(top + 1),
                                     "address": "0x" + token.hex()})
        delivered = call("eth_getFilterChanges", fid)
        reorg = ReorgManager(board.blockchain, cfg, driver=driver,
                             txpool=board.tx_pool, read_view=view)
        reorg.add_listener(server.service._filter_manager.note_reorg)
        t0 = time.perf_counter()
        reorg.switch(top, fork_wire)
        switch_s = time.perf_counter() - t0
        changes = call("eth_getFilterChanges", fid)
        fork_tip = fork_wire[-1]
        t0 = time.perf_counter()
        deadline = time.monotonic() + SERVE_WAIT_S
        while (replica.blockchain.get_hash_by_number(fork_tip.number)
               != fork_tip.hash and time.monotonic() < deadline):
            time.sleep(0.01)
        mirror_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        path = launches.read(name, ("k1r", "k5", "k4"))
        visible_ms = sorted(JOURNEY.latencies_ms("replica.visible"))
        durable_ms = sorted(JOURNEY.latencies_ms("durable"))
        replica_snap = replica.snapshot()

        # gates ---------------------------------------------------------
        bc, rbc = board.blockchain, replica.blockchain
        for n, b in enumerate(wire[:top] + fork_wire, start=1):
            for who, chain in (("primary", bc), ("replica", rbc)):
                got = chain.get_header_by_number(n)
                check(got is not None and got.hash == b.hash
                      and got.state_root == b.header.state_root,
                      f"{name}: block {n} on the {who}")
        head = fork_tip.header.state_root
        report_p, nodes_p = reachable(bc.storages, head)
        report_r, nodes_r = reachable(rbc.storages, head)
        check(report_p.missing == report_p.corrupt == 0,
              f"{name}: the primary's head state {report_p}")
        check(report_r.missing == report_r.corrupt == 0 and nodes_r == nodes_p,
              f"{name}: the replica's head state {report_r}")
        check(bc.best_block_number == rbc.best_block_number
              == fork_tip.number, f"{name}: heads {bc.best_block_number}"
              f" / {rbc.best_block_number}")
        for step, _, clients, requests, *_ in SERVE_STEPS + (SERVE_HTTP,):
            r = reports[step]
            check(r.violations == [] and r.errors == 0,
                  f"{name}: step {step}: {r.errors} errors, violations "
                  f"{[v.detail for v in r.violations[:3]]}")
            check(r.requests == clients * requests,
                  f"{name}: step {step} sent {r.requests} requests")
        check(steps[1]["mid_import"], f"{name}: step B ran after the import")
        check(any(s["retired_during"] for s in steps[:2]),
              f"{name}: no window retired while step A or B ran")
        check(stats.blocks == len(wire), f"{name}: imported {stats.blocks}")
        check(snap_import["published"] == len(wire)
              and snap_import["retired"] == len(wire)
              and snap_import["invalidated"] == 0,
              f"{name}: read view after the import {snap_import}")
        serving = plane.snapshot()
        shed = sum(c["shed"][k] for cls, c in serving["admission"].items()
                   if isinstance(c, dict) and "shed" in c for k in c["shed"])
        budget = serving["slo"]["errorBudget"]
        check(budget["bad"] == shed, f"{name}: SLO bad {budget['bad']} != "
              f"{shed} sheds")
        check(path["k5"] == windows, f"{name}: K5 launched {path['k5']} times "
              f"for {windows} windows")
        check(mirror_bad == 0, f"{name}: mirror verify found {mirror_bad}")
        retracted = [h for h in changes if h["removed"]]
        check(len(delivered) == 200 * SERVE_LOG_BLOCKS - 1
              and retracted == [dict(h, removed=True) for h in delivered]
              and len(changes) == len(retracted),
              f"{name}: {len(retracted)} of {len(delivered)} delivered logs "
              f"retracted, {len(changes)} changes")
        mirrored = replica_snap["switchesMirrored"]
        check(mirrored == 1, f"{name}: the replica mirrored {mirrored} "
              "switches")

        def pct(vals, q):
            if not vals:
                return None
            return vals[min(len(vals) - 1, int(q * len(vals)))]

        import_bps = stats.blocks / max(import_s - held["seconds"], 1e-9)
        a_p99 = reports["A"].p99()
        c_admitted = sorted(v for m, vals in reports["C"].latencies.items()
                            for v in vals)
        lines = [{"phase": name, "step": s["step"], **s} for s in steps]
        lines.append({
            "phase": name, "blocks": stats.blocks, "windows": windows,
            "txs": stats.txs, "genesis_accounts": len(spec.alloc),
            "board_seconds": board_s,
            "replica_genesis_seconds": replica_genesis_s,
            "build_seconds": build_s, "import_seconds": import_s,
            "import_held_seconds": held["seconds"],
            "import_blocks_per_s": import_bps,
            "unloaded_import_blocks_per_s": unloaded_bps,
            "loaded_over_unloaded": import_bps / unloaded_bps,
            "overload_ratio": (pct(c_admitted, 0.99) / a_p99
                               if a_p99 else None),
            "shed": shed, "slo": budget, "admission": serving["admission"],
            "read_view": snap_import,
            "read_view_after_switch": view.snapshot(),
            "replica": replica_snap,
            "replica_visible_ms": {"samples": len(visible_ms),
                                   "p50": pct(visible_ms, 0.5),
                                   "p99": pct(visible_ms, 0.99)},
            "durable_ms": {"samples": len(durable_ms),
                           "p50": pct(durable_ms, 0.5),
                           "p99": pct(durable_ms, 0.99)},
            "switch": {"ancestor": top, "depth": best - top,
                       "adopted": len(fork_wire), "seconds": switch_s,
                       "regenerated_blocks": reorg.regenerated_blocks,
                       "replica_mirror_seconds": mirror_s,
                       "logs_delivered": len(delivered),
                       "logs_retracted": len(retracted)},
            "pipeline_occupancy": stats.pipeline_occupancy,
            "mirror_verify": mirror_bad, "launches": path,
            "reduced": "replay_erc20_100k_w8's chain (a deploy and 32 "
            "blocks of 200 token transfers over 100,000 bulk accounts) and "
            "two blocks of a Transfer-event token, in place of mainnet "
            "blocks under public RPC traffic"})
        return lines
    finally:
        JOURNEY.disable()
        JOURNEY.reset()
        if replica is not None:
            replica.kill()
        board.shutdown()


# bridge_cluster_100k_w8: the bridge and the sharded node-cache cluster
BRIDGE_WINDOW = 8
BRIDGE_BATCH = 8  # blocks an ExecuteBlocks call: one window each
CLUSTER_SHARDS = 3
CLUSTER_REPLICATION = 2
CLUSTER_VNODES = 64
CLUSTER_READ_BATCH = 2048  # keys a cluster.fetch
CLUSTER_SAMPLE_ACCOUNTS = 500  # bulk accounts walked through the trie
CLUSTER_DEADLINE_S = 120.0  # a bridge call, a thread join, a rebalance
CLUSTER_MOVED_SLACK = 0.1  # |moved copies / all copies - 1/N| at most


def bounded(fn, what: str, timeout: float = CLUSTER_DEADLINE_S):
    """``fn()`` on a worker thread joined under a hard deadline: a
    wedged call fails the phase instead of hanging the script."""
    box = {}

    def work():
        try:
            box["out"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            box["err"] = e

    t = threading.Thread(target=work, daemon=True, name=what)
    t.start()
    t.join(timeout)
    check(not t.is_alive(), f"{what} did not end within {timeout} s")
    if "err" in box:
        raise box["err"]
    return box["out"]


def bridge_cluster_phase(torch, dev, launches, chain100k, nodes_100k,
                         small_chain, unloaded_bps) -> list:
    """bridge_cluster_100k_w8: the bridge and the sharded node-cache
    cluster on the card. (1) A primary ``ServiceBoard`` (memory, window
    8) at replay_erc20_100k_w8's genesis runs ``start_bridge(port=0)``
    (its commits on the card); a ``BridgeClient`` sends the chain in
    ``ExecuteBlocks`` batches of 8 (one window each: K5 one a batch, K1r
    one a sender batch). (2) Two more boards execute replay_erc20's
    first 8 blocks over their bridges at once. (3) Three kesque shard boards
    receive the primary's reachable state through
    ``ShardedNodeClient.replicate`` (replication 2, 64 vnodes). (4) A
    reader board's ``start_cluster`` fetches every node in batches of
    2,048 and walks 500 accounts through
    ``RemoteReadThroughNodeStorage``; midway one shard stops and the
    health prober drops it. (5) ``join_shard`` of a fourth kesque shard
    (the segment ship), then ``retire_shard`` of an original. (6) A
    ``ClusterTelemetry`` scrape and a merged Chrome trace. Returns the
    phase's lines."""
    from khipu_tpu_torch import workloads
    from khipu_tpu_torch.bridge import BridgeClient
    from khipu_tpu_torch.config import ClusterConfig, DbConfig, TelemetryConfig
    from khipu_tpu_torch.domain.account import address_key
    from khipu_tpu_torch.domain.block import Block
    from khipu_tpu_torch.domain.blockchain import GenesisSpec
    from khipu_tpu_torch.ledger.window import WINDOW_GAUGES
    from khipu_tpu_torch.observability import export
    from khipu_tpu_torch.observability.trace import Tracer, use_tracer
    from khipu_tpu_torch.service_board import ServiceBoard
    from khipu_tpu_torch.sync import prefetch
    from khipu_tpu_torch.trie.mpt import MerklePatriciaTrie

    name = "bridge_cluster_100k_w8"
    _, spec, blocks = chain100k
    cfg = workloads.replay_config(commit_window_blocks=BRIDGE_WINDOW)
    wire = [Block.decode(b.encode()) for b in blocks]
    head = wire[-1].header.state_root
    small = GenesisSpec(alloc={b"\x5a" * 20: 1})
    tmp = tempfile.mkdtemp(prefix="khipu_cluster_")
    boards, clients, lines = [], [], []

    def board(config, genesis):
        b = ServiceBoard(config, genesis=genesis, device=dev)
        boards.append(b)
        return b

    def client(endpoint):
        c = BridgeClient(endpoint, deadline=CLUSTER_DEADLINE_S)
        clients.append(c)
        return c

    def kesque_cfg(i):
        return dataclasses.replace(cfg, db=DbConfig(
            engine="kesque", data_dir=os.path.join(tmp, f"shard{i}")))

    def sender_batches():
        return prefetch.PREFETCH_GAUGES["device_batches"]

    try:
        # 1. the chain in ExecuteBlocks batches over the primary's bridge
        launches.zero()
        t0 = time.perf_counter()
        primary = board(cfg, spec)
        torch.cuda.synchronize()
        genesis_s = time.perf_counter() - t0
        genesis = launches.read(f"{name} genesis", ("k1r",))
        port = primary.start_bridge(port=0)
        bridge = client(f"127.0.0.1:{port}")
        prefetch.flush_sender_cache()
        before = {"batches": sender_batches(),
                  "device": WINDOW_GAUGES["device_windows"],
                  "host": WINDOW_GAUGES["host_windows"]}
        batches = [wire[i:i + BRIDGE_BATCH]
                   for i in range(0, len(wire), BRIDGE_BATCH)]
        launches.zero()
        t0 = time.perf_counter()
        answers = []
        for batch in batches:
            answers.extend(bridge.execute_blocks(batch))
        torch.cuda.synchronize()
        exec_s = time.perf_counter() - t0
        path = launches.read(name, ("k1r", "k5"))
        senders = sender_batches() - before["batches"]
        device_w = WINDOW_GAUGES["device_windows"] - before["device"]
        host_w = WINDOW_GAUGES["host_windows"] - before["host"]
        windows = sum(-(-len(b) // BRIDGE_WINDOW) for b in batches)
        check(answers == [(b.number, b.header.state_root) for b in wire],
              f"{name}: an ExecuteBlocks root != its header's")
        check(path["k5"] == windows == device_w and host_w == 0,
              f"{name}: K5 {path['k5']}, {device_w} device + {host_w} host "
              f"windows of {windows}")
        check(path["k1r"] == senders == len(wire),
              f"{name}: K1r {path['k1r']} for {senders} sender batches "
              f"({len(wire)} blocks)")
        check(primary.storages.window_journal.pending() == [],
              f"{name}: journal intents pending")
        report, reached = reachable(primary.storages, head)
        check(report.missing == 0 and report.corrupt == 0
              and reached == nodes_100k, f"{name}: the primary's reachable "
              "nodes != the in-process windowed import's")
        state = {}
        for part in reached:
            state.update(part)
        lines.append({
            "phase": name, "step": "execute_over_bridge",
            "blocks": len(wire), "batches": len(batches),
            "window": BRIDGE_WINDOW, "seconds": exec_s,
            "blocks_per_s": len(wire) / exec_s,
            "in_process_blocks_per_s": unloaded_bps,
            "windows": windows, "device_windows": device_w,
            "host_windows": host_w, "k1r_sender_batches": senders,
            "genesis_seconds": genesis_s, "genesis_launches": genesis,
            "reachable_nodes": len(state), "launches": path,
            "card": card_line()})

        # 2. two shards' ExecuteBlocks at once, once
        # one batch of the small chain each (one window)
        s_spec, s_blocks = small_chain
        s_wire = [Block.decode(b.encode()) for b in s_blocks[:BRIDGE_BATCH]]
        pair = [board(cfg, s_spec) for _ in range(2)]
        pair_clients = [client(f"127.0.0.1:{b.start_bridge(port=0)}")
                        for b in pair]
        prefetch.flush_sender_cache()
        before = sender_batches()
        launches.zero()
        t0 = time.perf_counter()
        outs = [None, None]

        def run(i):
            outs[i] = pair_clients[i].execute_blocks(s_wire)

        threads = [threading.Thread(target=run, args=(i,), daemon=True)
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(CLUSTER_DEADLINE_S)
        check(not any(t.is_alive() for t in threads),
              f"{name}: a concurrent ExecuteBlocks did not return")
        torch.cuda.synchronize()
        pair_s = time.perf_counter() - t0
        pair_path = launches.read(f"{name} concurrent", ("k1r", "k5"))
        want = [(b.number, b.header.state_root) for b in s_wire]
        s_windows = -(-len(s_wire) // BRIDGE_WINDOW)
        check(outs == [want, want], f"{name}: a concurrent batch's roots")
        check(pair_path["k5"] == 2 * s_windows, f"{name}: K5 "
              f"{pair_path['k5']} for two shards of {s_windows} windows")
        check(pair_path["k1r"] == sender_batches() - before,
              f"{name}: K1r {pair_path['k1r']} != the sender batches")
        check(all(b.blockchain.best_block_number == len(s_wire)
                  for b in pair), f"{name}: a concurrent shard's best")
        lines.append({"phase": name, "step": "two_shards_at_once",
                      "blocks_each": len(s_wire), "seconds": pair_s,
                      "windows_each": s_windows, "launches": pair_path})
        for b in pair:
            b.shutdown()
            boards.remove(b)

        # 3. three kesque shards receive the primary's state
        shards = [board(kesque_cfg(i), small) for i in range(CLUSTER_SHARDS)]
        eps = [f"127.0.0.1:{b.start_bridge(port=0)}" for b in shards]
        ccfg = dataclasses.replace(
            cfg,
            cluster=ClusterConfig(
                endpoints=tuple(eps), replication=CLUSTER_REPLICATION,
                vnodes=CLUSTER_VNODES, max_retries=1, backoff_base=0.01,
                rpc_deadline=CLUSTER_DEADLINE_S, probe_interval=3600.0,
                down_after=2, up_after=1),
            telemetry=TelemetryConfig(enabled=True, scrape_interval=3600.0,
                                      watchdog=False))
        reader = board(ccfg, small)
        t0 = time.perf_counter()
        cluster = reader.start_cluster()
        placed = bounded(lambda: cluster.replicate(state),
                         f"{name}: replicate")
        replicate_s = time.perf_counter() - t0
        check(placed == CLUSTER_REPLICATION * len(state),
              f"{name}: {placed} placements of {len(state)} nodes")
        lines.append({"phase": name, "step": "replicate",
                      "nodes": len(state), "placements": placed,
                      "seconds": replicate_s,
                      "nodes_per_s": len(state) / replicate_s,
                      "replication": CLUSTER_REPLICATION,
                      "vnodes": CLUSTER_VNODES, "shards": len(eps)})

        # 4. every node read through the cluster; one shard stops midway
        keys = sorted(state)
        dead = eps[1]
        mon = reader._cluster_health
        got, probes, t0 = {}, 0, time.perf_counter()
        failovers_before_drop = 0
        for i in range(0, len(keys), CLUSTER_READ_BATCH):
            if i >= len(keys) // 2 and dead in cluster.ring.members:
                shards[1].bridge.stop()
                # reads go on before the verdict: failovers
                got.update(cluster.fetch(keys[i:i + CLUSTER_READ_BATCH]))
                failovers_before_drop = sum(
                    m.failovers for m in cluster.metrics.values())
                while dead in cluster.ring.members:
                    check(probes < ccfg.cluster.down_after,
                          f"{name}: {dead} still in the ring after "
                          f"{probes} probes")
                    mon.probe_once()
                    probes += 1
                continue
            got.update(cluster.fetch(keys[i:i + CLUSTER_READ_BATCH]))
        read_s = time.perf_counter() - t0
        check(got == state, f"{name}: {len(state) - len(got)} nodes missing "
              "or different through the cluster")
        snap = cluster.metrics_snapshot()
        check(snap["unreachable"] == 0, f"{name}: unreachable keys")
        # sampled accounts through the read-through wrappers
        t0 = time.perf_counter()
        trie = MerklePatriciaTrie(reader.storages.account_node_storage,
                                  root_hash=head)
        ref = MerklePatriciaTrie(primary.storages.account_node_storage,
                                 root_hash=head)
        addrs = list(workloads.bulk_alloc(CLUSTER_SAMPLE_ACCOUNTS))
        for a in addrs:
            k = address_key(a)
            check(trie.get(k) == ref.get(k), f"{name}: account {a.hex()} "
                  "through the cluster != the primary's")
        walk_s = time.perf_counter() - t0
        dead_m = snap["shards"][dead]
        lines.append({
            "phase": name, "step": "read_through_cluster",
            "nodes": len(got), "seconds": read_s,
            "nodes_per_s": len(got) / read_s, "batch": CLUSTER_READ_BATCH,
            "stopped": dead, "probes_to_drop": probes,
            "failovers_before_drop": failovers_before_drop,
            "failovers": sum(s["failovers"] for s in snap["shards"].values()),
            "dead_failures": dead_m["failures"],
            "dead_breaker": dead_m["breakerState"],
            "breakers_open": sum(1 for s in snap["shards"].values()
                                 if s["breakerState"] != "closed"),
            "accounts_walked": len(addrs), "walk_seconds": walk_s,
            "healed": reader.storages.account_node_storage.healed,
            "members": list(cluster.ring.members)})

        # 5. a fourth kesque shard joins (the segment ship); an original
        # retires
        shipped = {"bytes": 0, "pages": 0}
        stream, pages = cluster.stream_segments, cluster.stream_node_data

        def counted(*a, **kw):
            raw, nxt, done = stream(*a, **kw)
            shipped["bytes"] += len(raw)
            return raw, nxt, done

        def paged(*a, **kw):
            shipped["pages"] += 1
            return pages(*a, **kw)

        cluster.stream_segments = counted
        cluster.stream_node_data = paged
        e0 = cluster.ring.epoch
        t_boot = time.perf_counter()
        joiner_board = board(kesque_cfg(CLUSTER_SHARDS), small)
        joiner = f"127.0.0.1:{joiner_board.start_bridge(port=0)}"
        t0 = time.perf_counter()
        join_keys = bounded(lambda: reader.join_shard(joiner),
                            f"{name}: join_shard")
        join_s = time.perf_counter() - t0
        boot_to_serving = time.perf_counter() - t_boot
        rb = reader.rebalancer
        join_frac = rb.last_moved_fraction
        n_join = len(cluster.ring.members)
        check(cluster.ring.epoch == e0 + 1 and joiner in cluster.ring.members,
              f"{name}: the join's epoch {cluster.ring.epoch} (from {e0})")
        check(rb.segment_chunks > 0 and shipped["bytes"] > 0
              and shipped["pages"] == 0, f"{name}: the join did not go "
              "by the segment ship alone")
        check(abs(join_frac / CLUSTER_REPLICATION - 1 / n_join)
              <= CLUSTER_MOVED_SLACK, f"{name}: the join moved "
              f"{join_frac:.3f} of the keyspace at {n_join} members")
        retiree = eps[0]
        n_before = len(cluster.ring.members)
        t0 = time.perf_counter()
        retire_keys = bounded(lambda: reader.retire_shard(retiree),
                              f"{name}: retire_shard")
        retire_s = time.perf_counter() - t0
        retire_frac = rb.last_moved_fraction
        check(cluster.ring.epoch == e0 + 2
              and retiree not in cluster.ring.members,
              f"{name}: the retire's epoch {cluster.ring.epoch}")
        check(shipped["pages"] == 0, f"{name}: the retire fell back to "
              "StreamNodeData pages")
        check(abs(retire_frac / CLUSTER_REPLICATION - 1 / n_before)
              <= CLUSTER_MOVED_SLACK, f"{name}: the retire moved "
              f"{retire_frac:.3f} of the keyspace from {n_before} members")
        t0 = time.perf_counter()
        again = {}
        for i in range(0, len(keys), CLUSTER_READ_BATCH):
            again.update(cluster.fetch(keys[i:i + CLUSTER_READ_BATCH]))
        reread_s = time.perf_counter() - t0
        check(again == state, f"{name}: a key no longer fetches bit-exact "
              "after the join and the retire")
        share = [k for k in keys if joiner in cluster.ring.replicas_for(k)]
        direct = client(joiner)
        served = {}
        for i in range(0, len(share), CLUSTER_READ_BATCH):
            served.update(direct.get_node_data(share[i:i + CLUSTER_READ_BATCH]))
        check(served == {k: state[k] for k in share},
              f"{name}: the joiner does not serve its share")
        lines.append({
            "phase": name, "step": "join_retire",
            "join_keys_streamed": join_keys, "join_seconds": join_s,
            "boot_to_serving_seconds": boot_to_serving,
            "join_moved_fraction": join_frac, "members_after_join": n_join,
            "segment_chunks": rb.segment_chunks,
            "bytes_shipped": shipped["bytes"],
            "retire_keys_streamed": retire_keys,
            "retire_seconds": retire_s,
            "retire_moved_fraction": retire_frac,
            "epoch": cluster.ring.epoch, "joiner_share": len(share),
            "reread_seconds": reread_s,
            "members": list(cluster.ring.members)})

        # 6. the federation's scrape and the merged trace
        live = list(cluster.ring.members)
        tel = reader.start_telemetry(endpoints=live + [dead])
        # the shards serve this process's registry, which gains the
        # federation's own families at its first scrape: judge the second
        tel.scrape_once()
        scraped = tel.scrape_once()
        fams = tel.merged_families()
        per_shard = {ep: sorted(n for n, (_, _, samples) in fams.items()
                                if any(lb.get("shard") == ep
                                       for lb, _ in samples))
                     for ep in live + [dead]}
        check(scraped == len(live) and all(per_shard[ep] for ep in live)
              and len({tuple(per_shard[ep]) for ep in live}) == 1,
              f"{name}: not one family set per live shard: " + str(
                  [sorted(set(per_shard[ep]) ^ set(per_shard[live[0]]))
                   for ep in live]))
        health = tel.health_scores()
        threshold = ccfg.telemetry.health_threshold
        check(health[dead].score < threshold, f"{name}: the stopped shard's "
              f"health {health[dead].score} >= {threshold}")
        driver = Tracer()
        driver.enable()
        for b in shards + [joiner_board]:
            b.tracer.enable()
        with use_tracer(driver):
            cluster.fetch(keys[:CLUSTER_READ_BATCH])
            for ep in live:
                cluster.ping(ep)
        rings = cluster.collect_traces(probe_samples=3)
        out_dir = os.path.join(ROOT, "chiprun_out")
        os.makedirs(out_dir, exist_ok=True)
        trace_path = os.path.join(out_dir, f"{name}_trace.json")
        export.dump_merged_chrome_trace(trace_path, rings, driver.snapshot(),
                                        tracer_=driver)
        with open(trace_path) as f:
            events = json.load(f)["traceEvents"]
        calls = {s.token: (export._us(s.t0, driver), export._us(s.t1, driver))
                 for s in driver.snapshot() if s.name == "bridge.call"}
        nested = 0
        for e in events:
            rp = e.get("args", {}).get("remote_parent")
            if (e.get("pid", 1) > 1 and e["name"].startswith("bridge.serve.")
                    and rp is not None):
                c0, c1 = calls[rp]
                check(c0 - 1e-3 <= e["ts"]
                      and e["ts"] + e.get("dur", 0) <= c1 + 1e-3,
                      f"{name}: {e['name']} outside its bridge.call")
                nested += 1
        check(nested > 0 and len(rings) == len(live),
              f"{name}: {nested} serve spans nested, {len(rings)} rings")
        lines.append({
            "phase": name, "step": "telemetry_trace",
            "scraped": scraped, "families_per_shard": len(per_shard[live[0]]),
            "health": {ep: round(h.score, 4) for ep, h in health.items()},
            "health_threshold": threshold, "pressure": tel.pressure(),
            "trace": os.path.relpath(trace_path, ROOT),
            "shard_rings": len(rings), "serve_spans_nested": nested,
            "card": card_line()})
    finally:
        for c in clients:
            c.close()
        for b in boards:
            b.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    return lines


# world 2: two gloo ranks sharing the one card (NCCL refuses a card
# twice), at a smaller depth; the window is world 1's
MESH_WORLD2 = ("--backend", "gloo", "--devices", "cuda:0,cuda:0",
               "--rows", str(1 << 20), "--accounts", "10000")
MESH_TIMEOUT_S = 420.0
MESH_WINDOW = "fused_window_16x400"


def run_mesh(nproc: int, args) -> tuple:
    """``torchrun --standalone --nproc-per-node=<nproc> -m
    khipu_tpu_torch.parallel <args>`` in a session of its own: rank 0's
    step lines by step, and the wall seconds. Every process of the
    session is killed if it outlives ``MESH_TIMEOUT_S``."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={nproc}", "-m", "khipu_tpu_torch.parallel",
           *args]
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=MESH_TIMEOUT_S)
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"parallel_mesh world {nproc} exited "
          f"{proc.returncode}:\n{err[-4000:]}")
    lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    check(bool(lines) and lines[-1].get("ok") is True
          and lines[-1].get("world") == nproc,
          f"parallel_mesh world {nproc}: no ok line")
    return {ln["step"]: ln for ln in lines[:-1]}, seconds


def parallel_mesh_phase(launches) -> list:
    """31: the multi-card path over ``torch.distributed``, world 1 on
    NCCL at full width and world 2 as gloo ranks on the one card; the
    ranks' launches add to the main paths' totals. Returns the two
    lines."""
    lines, worlds = [], {}
    for nproc, args in ((1, ()), (2, MESH_WORLD2)):
        steps, wall = run_mesh(nproc, args)
        worlds[nproc] = steps
        check(list(steps) == ["commit", "fixed_sharded", "level_all_gather",
                              "snapshot_verify", "bulk_build",
                              "fused_session48",
                              f"fused_bulk_dag_{steps['bulk_build']['accounts']}",
                              MESH_WINDOW],
              f"parallel_mesh world {nproc}: steps {list(steps)}")
        # every rank checked the others' records, the one-card path, the
        # oracle and its launches and collectives a step
        # (``parallel.__main__.check_records``); here what one run
        # cannot see: K5 once a level at world 1, and the totals
        for st in steps.values():
            for got in st["launches"]:
                for k in ("k1f", "k1r", "k5"):
                    launches.total[k] += got[k]
        bulk = steps["bulk_build"]
        fused_steps = {n: st for n, st in steps.items()
                       if n.startswith("fused_")}
        if nproc == 1:
            for name, st in fused_steps.items():
                k5 = [g["k5"] for g in st["launches"]]
                check(k5 == [st["levels"]], f"parallel_mesh {name}: K5 "
                      f"{k5} != its {st['levels']} levels at world 1")
        line = {
            "phase": "parallel_mesh", "world": nproc,
            "backend": steps["commit"]["backend"],
            "rows": steps["fixed_sharded"]["rows"],
            "length": steps["fixed_sharded"]["length"],
            "accounts": bulk["accounts"], "bulk_nodes": bulk["nodes"],
            "bulk_root": bulk["root"], "wall_seconds": wall,
            "one_card_claims_seconds":
                steps["fixed_sharded"]["one_card_seconds"],
            "steps": {n: {"seconds": max(st["seconds"]),
                          "setup_seconds": st["setup_seconds"],
                          "launches": st["launches"],
                          "collectives": st["collectives"]}
                      for n, st in steps.items()},
            "fused": {n: {k: st[k] for k in ("nodes", "levels", "k5_levels",
                                             "loop_ms", "gather_ms")}
                      for n, st in fused_steps.items()},
            "reduced": "world 1 at BASELINE #5's and #3's widths; world 2 "
            "cut to 1,048,576 rows and 10,000 accounts (two ranks on one "
            "card: gloo), the window as world 1's",
        }
        if nproc == 1:
            line["gather_share_of_level_loop"] = {
                n: f["gather_ms"] / f["loop_ms"]
                for n, f in line["fused"].items()}
        lines.append(line)
    w1, w2 = worlds[1], worlds[2]
    check(w2["fixed_sharded"]["table_sha"] == w1["fixed_sharded"]["prefix_sha"]
          and w2["level_all_gather"]["equal_one_card"],
          "parallel_mesh: world 2's rows != world 1's first 1,048,576")
    for name in ("fused_session48", MESH_WINDOW):
        check(w2[name]["mapping_sha"] == w1[name]["mapping_sha"],
              f"parallel_mesh: world 2's {name} != world 1's")
    return lines


def tip_of(bc):
    best = bc.best_block_number
    h = bc.get_header_by_number(best)
    return best, h.hash, h.state_root


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--messages", type=int, default=1 << 20)
    ap.add_argument("--accounts", type=int, default=100_000)
    ap.add_argument("--blocks", type=int, default=16)
    ap.add_argument("--writes", type=int, default=400)
    ap.add_argument("--new-accounts", type=int, default=20)
    ap.add_argument("--edge-rows", type=int, default=4097)
    ap.add_argument("--mirror-rows", type=int, default=10_485_760)
    # 32 / 16 / 16: depths cut from 128 / 32 / 32 to keep the script,
    # serve_erc20_100k_w8 and bridge_cluster_100k_w8 included, near
    # 600 s (the 100k chain's 16 blocks still give live sync its pivot
    # at 1 and two windows above it)
    ap.add_argument("--transfer-blocks", type=int, default=32)
    ap.add_argument("--erc20-blocks", type=int, default=16)
    ap.add_argument("--erc20-100k-blocks", type=int, default=16)
    ap.add_argument("--par-transfer-blocks", type=int, default=32)
    ap.add_argument("--prebyz-blocks", type=int, default=16)
    ap.add_argument("--k6-rows", type=int, default=1 << 20)
    ap.add_argument("--arith-triples", type=int, default=10_000)
    ap.add_argument("--rlp-items", type=int, default=20_000)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    from khipu_tpu_torch import workloads
    from khipu_tpu_torch.base.keccak import keccak256_py
    from khipu_tpu_torch.base.rlp import rlp_encode_int
    from khipu_tpu_torch.domain.account import Account, address_key
    from khipu_tpu_torch.native import build as native_build
    from khipu_tpu_torch.observability.recorder import compile_log
    from khipu_tpu_torch.ops import build, keccak_cuda, keccak_torch
    from khipu_tpu_torch.ops.keccak import keccak256_batch, keccak256_device_fixed
    from khipu_tpu_torch.state import load_reference_nodes
    from khipu_tpu_torch.storage import device_mirror, mirror_cuda
    from khipu_tpu_torch.storage.compactor import verify_reachable
    from khipu_tpu_torch.storage.datasource import MemoryKeyValueDataSource
    from khipu_tpu_torch.storage.device_mirror import DeviceNodeMirror
    from khipu_tpu_torch.storage.storages import Storages
    from khipu_tpu_torch.sync.fast_sync import FastSyncStateStorage, StateSyncer
    from khipu_tpu_torch.trie import (
        bulk,
        deferred,
        exec_validate_cuda,
        fixpoint_cuda,
        fused,
    )
    from khipu_tpu_torch.trie.mpt import MerklePatriciaTrie

    print(card_line(), flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    plain_hasher = lambda msgs: keccak_torch.keccak256_batch_plain(msgs, dev)  # noqa: E731
    launches = Launches(keccak_cuda, fixpoint_cuda, mirror_cuda,
                        exec_validate_cuda)

    # 1. build: nvcc for the kernels while g++ builds the host library and
    # gcc the RLP extension ----------------------------------------------
    def timed(fn):
        t = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t

    with ThreadPoolExecutor(2) as pool:
        host_job = pool.submit(timed, native_build.load_library)
        ext_job = pool.submit(timed, native_build.load_rlp_ext)
        t0 = time.perf_counter()
        build.load()
        kernels_s = time.perf_counter() - t0
        host_lib, host_s = host_job.result()
        rlp_ext, ext_s = ext_job.result()
    check(host_lib is native_build.load_library() and all(
        hasattr(host_lib, f) for f in ("khipu_ecdsa_recover_batch",
                                       "khipu_evm_call", "kstore_open")),
        "the host library did not load")
    emit({"phase": "build", "seconds": kernels_s,
          "sources": [str(p.relative_to(ROOT)) for p in build.sources()],
          "ptxas": ptxas_by_kernel(build.BUILD_LOG),
          "host_library": os.path.basename(host_lib._name),
          "host_sources": [str(p.relative_to(ROOT))
                           for p in native_build.sources()],
          "host_seconds": host_s,
          "rlp_extension": os.path.basename(rlp_ext.__file__),
          "rlp_extension_seconds": ext_s})
    # 1b. the native host closure against its oracles
    host = native_host_phase(np, np.random.default_rng([args.seed, 8]),
                             args.arith_triples, args.rlp_items)
    host["builds"] = [
        {"kind": kind, "output": label, "seconds": sec}
        for kind, label, sec in (
            (e["kind"], e["signature"], e.get("compile_s"))
            for e in compile_log.snapshot()["events"])
        if label.startswith(("libkhipu_host_", "khipu_rlp_ext_"))]
    emit(host)

    # 2. K1r against its plain version and the scalar oracle -------------
    def packed(msgs):
        blob, offsets, lengths = keccak_torch.pack_ragged(msgs)
        return torch.from_numpy(blob).to(dev), offsets, lengths

    def hold_ragged(blob, offsets, lengths, label, oracle) -> int:
        """K1r in each mode == ``absorb_ragged`` on the card, and == the
        scalar oracle on the rows ``oracle`` maps to their messages."""
        plain = keccak_torch.absorb_ragged(blob, torch.from_numpy(offsets),
                                           torch.from_numpy(lengths))
        err = 0
        for mode in ("row", "column"):
            got = keccak_cuda.absorb_ragged(blob, offsets, lengths, mode=mode)
            torch.cuda.synchronize()
            err = max(err, int((got.int() - plain.int()).abs().max()))
            check(torch.equal(got, plain), f"K1r {mode} != plain ({label})")
            rows = {i: got[i].cpu().numpy().tobytes() for i in oracle}
            check(all(rows[i] == keccak256_py(m) for i, m in oracle.items()),
                  f"K1r {mode} != scalar oracle ({label})")
        return err

    edge_msgs = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                 for n in K1R_EDGES]
    k1r_err = hold_ragged(*packed(edge_msgs), "edges",
                          dict(enumerate(edge_msgs)))
    lens = rng.integers(0, 600, 5000)
    lens[::250] = 2048
    mixed = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
             for n in lens]
    k1r_err = max(k1r_err, hold_ragged(
        *packed(mixed), "mixed", {i: mixed[i] for i in range(0, 5000, 97)}))
    got = keccak256_batch(mixed, device=dev)
    check(got == plain_hasher(mixed), "keccak256_batch != plain (mixed)")
    check(all(got[i] == keccak256_py(mixed[i]) for i in range(0, 5000, 97)),
          "keccak256_batch != scalar oracle (mixed)")

    n_msg, length = args.messages, 576
    nblocks = length // 136 + 1
    data = torch.randint(0, 256, (n_msg, length), dtype=torch.uint8,
                         device=dev, generator=gen)
    flat = data.view(-1)
    big_offsets = np.arange(n_msg, dtype=np.int32) * length
    big_lengths = np.full(n_msg, length, np.int32)
    oracle = {i: data[i].cpu().numpy().tobytes()
              for i in (0, 1, n_msg // 2, n_msg - 1)}
    k1r_err = max(k1r_err, hold_ragged(flat, big_offsets, big_lengths,
                                       "1M x 576", oracle))
    k1f_out = keccak_cuda.absorb_fixed(data)
    big = {m: keccak_cuda.absorb_ragged(flat, big_offsets, big_lengths,
                                        mode=m) for m in ("row", "column")}
    torch.cuda.synchronize()
    check(all(torch.equal(o, k1f_out) for o in big.values()),
          "K1r != K1f at 1M x 576")
    # kernel-only times in turns: each mode of K1r beside K1f on the rows
    big_runs = {
        "row": (lambda: keccak_cuda.absorb_ragged(
            flat, big_offsets, big_lengths, big["row"], mode="row"),
            "ragged", 10),
        "column": (lambda: keccak_cuda.absorb_ragged(
            flat, big_offsets, big_lengths, big["column"], mode="column"),
            "ragged", 3),
        "k1f": (lambda: keccak_cuda.absorb_fixed(data, k1f_out), "fixed", 10),
    }
    big_us = {m: [] for m in big_runs}
    for rnd in range(3):
        for m in list(big_runs)[rnd:] + list(big_runs)[:rnd]:
            fn, match, reps = big_runs[m]
            big_us[m].append(kernel_us(torch, fn, reps, match)[1])
    big_ms = {m: sorted(t)[1] / 1e3 for m, t in big_us.items()}
    _, big_plain_ms = timed_once(torch, lambda: keccak_torch.absorb_ragged(
        flat, torch.from_numpy(big_offsets), torch.from_numpy(big_lengths)))
    # bytes: the rows, 8 header bytes and 32 digest bytes a row
    big_bound, big_bound_by = sponge_bound_ms(
        n_msg, nblocks, n_msg * (length + 8 + 32))
    del big, k1f_out

    # fast sync's 100-row batches: both modes and the per-class design
    batch100 = {}
    for shape, nbs in BATCH100.items():
        msgs = [rng.integers(0, 256, 136 * nb - 1 - int(rng.integers(0, 100)),
                             dtype=np.uint8).tobytes() for nb in nbs]
        blob, offsets, lengths = packed(msgs)
        k1r_err = max(k1r_err, hold_ragged(blob, offsets, lengths, shape,
                                           dict(enumerate(msgs))))
        out = torch.empty((len(msgs), 32), dtype=torch.uint8, device=dev)
        check(per_class_rows(torch, np, build, keccak_torch, msgs, dev)
              == [keccak256_py(m) for m in msgs],
              f"per-class design != scalar oracle ({shape})")
        runs = {
            "column": lambda: keccak_cuda.absorb_ragged(
                blob, offsets, lengths, out, mode="column"),
            "row": lambda: keccak_cuda.absorb_ragged(
                blob, offsets, lengths, out, mode="row"),
            "per_class": lambda: per_class_rows(
                torch, np, build, keccak_torch, msgs, dev),
        }
        kernel = {m: [] for m in runs}
        for rnd in range(3):
            for m in list(runs)[rnd:] + list(runs)[:rnd]:
                per_run, us = kernel_us(torch, runs[m], 200, "ragged")
                kernel[m].append(per_run * us)
        row = {f"{m}_kernel_us": sorted(t)[1] for m, t in kernel.items()}
        for m, fn in runs.items():
            row[f"{m}_call_us"] = cuda_ms(torch, fn, 200) * 1e3
        # host time a batch, digests back on the host: the content
        # check's path (keccak256_batch) and the design it replaced
        for m, fn in (("batch", lambda: keccak256_batch(msgs, dev)),
                      ("per_class", runs["per_class"])):
            fn()
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            row[f"{m}_host_us"] = (time.perf_counter() - t0) / 200 * 1e6
        row["plain_us"] = cuda_ms(torch, lambda: keccak_torch.absorb_ragged(
            blob, torch.from_numpy(offsets), torch.from_numpy(lengths)), 2) * 1e3
        ops_s = sum(nbs) * SPONGE_OPS_PER_BLOCK / H100_INT32_OPS_PER_S
        bytes_s = (blob.numel() + 40 * len(msgs)) / H100_BYTES_PER_S
        row.update({"bound_us": max(ops_s, bytes_s) * 1e6,
                    "bound_by": "operations" if ops_s >= bytes_s else "bytes",
                    "latency_floor_us": max(nbs) * PERM_CHAIN_S * 1e6,
                    "rate_blocks": sum(nbs),
                    "per_class_launches": len(set(nbs))})
        batch100[shape] = row
    emit({"phase": "k1r", "modes": ["row", "column"],
          "column_max_rows": keccak_cuda.COLUMN_MAX_ROWS,
          "edge_lengths": list(K1R_EDGES), "mixed_batch": len(mixed),
          "messages": n_msg, "bytes": length, "kernel_ms_1Mx576": big_ms,
          "row_vs_k1f": big_ms["row"] / big_ms["k1f"],
          "plain_ms_1Mx576": big_plain_ms, "bound_ms_1Mx576": big_bound,
          "bound_by_1Mx576": big_bound_by, "batch100": batch100,
          "max_abs_err": k1r_err})

    # 2b. K1f against K1r and the plain version ----------------------------
    k1f_out = keccak256_device_fixed(data, device=dev)
    k1r_out = keccak_cuda.absorb_ragged(flat, big_offsets, big_lengths,
                                        mode="row")
    k1f_plain, k1f_plain_ms = timed_once(
        torch, lambda: keccak_torch.absorb_fixed(data))
    check(torch.equal(k1f_out, k1r_out), "K1f != K1r over the same rows")
    k1f_err = int((k1f_out.int() - k1f_plain.int()).abs().max())
    check(k1f_err == 0, "K1f != plain at 1M x 576")
    words_out = keccak256_device_fixed(data.view(torch.int32), device=dev)
    check(torch.equal(words_out, k1f_out), "K1f words input != bytes input")
    k1f_ms = cuda_ms(torch, lambda: keccak_cuda.absorb_fixed(data, k1f_out), 10)
    k1f_bound, k1f_bound_by = sponge_bound_ms(n_msg, nblocks,
                                              n_msg * (length + 32))
    del data, flat, k1f_out, k1r_out, k1f_plain, words_out
    for edge in K1F_EDGES:
        rows = torch.randint(0, 256, (args.edge_rows, edge), dtype=torch.uint8,
                             device=dev, generator=gen)
        got = keccak_cuda.absorb_fixed(rows)
        check(torch.equal(got, keccak_torch.absorb_fixed(rows)),
              f"K1f != plain at L={edge}")
        sample = rng.choice(args.edge_rows, size=min(64, args.edge_rows),
                            replace=False)
        got_h, rows_h = got.cpu().numpy(), rows.cpu().numpy()
        check(all(got_h[i].tobytes() == keccak256_py(rows_h[i].tobytes())
                  for i in sample), f"K1f != scalar oracle at L={edge}")
    emit({"phase": "k1f", "messages": n_msg, "bytes": length,
          "k1f_ms": k1f_ms, "plain_ms": k1f_plain_ms, "bound_ms": k1f_bound,
          "hashes_per_s": n_msg / (k1f_ms / 1e3), "max_abs_err": k1f_err,
          "edge_lengths": list(K1F_EDGES), "edge_rows": args.edge_rows})

    # 3. K5 against its plain version on the card ------------------------
    session = deferred.DeferredMPT(load_reference_nodes({}))
    for i in range(3000):
        session = session.put(
            address_key(b"phase3" + i.to_bytes(14, "big")),
            Account(i, 10**18 + int(rng.integers(0, 10**9))).encode(),
        )
        if i % 500 == 499:  # six roots that share subtrees
            session.force_hashed_root()
    to_resolve, deps, _ = deferred.resolution_inputs(session)
    _, truth = deferred.finalize(session, plain_hasher, return_mapping=True)
    leaves = fused.topo_levels(deps)[0]
    moved = set(leaves[::2])
    ext_keys = sorted(moved) + [None]
    ext_np = np.stack([np.frombuffer(truth[k] if k else bytes(32), np.uint8)
                       for k in ext_keys])
    ext_pos = {k: i for i, k in enumerate(ext_keys) if k is not None}
    ext = torch.from_numpy(ext_np).to(dev)
    tr = {ph: e for ph, e in to_resolve.items() if ph not in moved}
    dp = {ph: [c for c in deps[ph] if c not in moved] for ph in tr}
    live = set(sorted(tr)[::3])
    prefix = deferred._PLACEHOLDER_PREFIX
    job = fused.fused_submit(tr, dp, prefix, device=dev, ext=(ext, ext_pos),
                             admit_live=live)
    levels = fused.FUSED_GAUGES["last_levels"]
    classes, _, total, plan = fused.pack(tr, prefix, dev, ext_pos,
                                         len(ext_keys), live)
    plain_g = fused.resolve_levels_plain(classes, total, ext, plan)
    check(job.collect() == {ph: truth[ph] for ph in tr},
          "K5 digests != the level loop's")
    inner = plan.tchild[plan.tchild < total]
    max_parents = int(np.bincount(inner).max())
    check(max_parents > 1, "no child with several parents in phase 3")
    check(int((plan.tchild >= total).sum()) > 0, "no ext child in phase 3")
    k5_err = int((job.digests.int() - plain_g.int()).abs().max())
    check(k5_err == 0 and torch.equal(job.digests, plain_g),
          "K5 digests != plain")
    tiles = {t[0]: t for t in job.admit_tiles}
    for c, enc in zip(classes, job.encs):
        k5_err = max(k5_err, int((enc.int() - c.enc.int()).abs().max()))
        check(torch.equal(enc, c.enc), f"K5 final encodings != plain "
              f"(class {c.nb})")
        if c.aidx is not None:
            _, _, enc_g, claim_g, _ = tiles[c.nb]
            check(torch.equal(enc_g, c.enc.index_select(0, c.aidx)),
                  f"admit encodings != plain (class {c.nb})")
            check(torch.equal(claim_g, plain_g.index_select(
                0, c.aidx + c.base)), f"admit digests != plain (class {c.nb})")
    emit({"phase": "fixpoint", "nodes": len(tr), "ext_rows": len(ext_keys),
          "ext_children": int((plan.tchild >= total).sum()),
          "admit": len(live), "levels": levels, "classes": len(classes),
          "triples": plan.ntriples, "max_parents": max_parents,
          "max_abs_err": k5_err})

    # 4-6: the main path, with the launch counts zeroed just before -------
    launches.zero()
    main_t0 = time.perf_counter()

    # 4. mainnet genesis
    t0 = time.perf_counter()
    pairs = workloads.genesis_pairs(
        os.path.join(ROOT, "tests", "fixtures", "mainnet_genesis_alloc.txt.gz"),
        device=dev,
    )
    g_root, g_nodes = bulk.bulk_build(pairs, fused=True, device=dev)
    check(g_root.hex() == GENESIS_ROOT, f"genesis root {g_root.hex()}")
    emit({"phase": "genesis", "accounts": len(pairs), "nodes": len(g_nodes),
          "root": g_root.hex(), "seconds": time.perf_counter() - t0})

    # 5. a fresh 100k-account state trie (BASELINE config #3)
    n_acc = args.accounts
    pairs = workloads.fresh_state_pairs(n_acc, device=dev)
    probe = n_acc // 2 + 1
    check(pairs[probe][0] == address_key(probe.to_bytes(20, "big")),
          "batched address key != address_key")
    stats = {}
    t0 = time.perf_counter()
    s_root, s_nodes = bulk.bulk_build(pairs, fused=True, device=dev,
                                      stats_out=stats)
    bulk_s = time.perf_counter() - t0
    bulk_levels = fused.FUSED_GAUGES["last_levels"]
    t0 = time.perf_counter()
    check((s_root, s_nodes) == bulk.bulk_build(pairs, hasher=plain_hasher),
          "100k bulk build != level loop with the plain hasher")
    emit({"phase": "bulk_100k", "accounts": n_acc, "nodes": len(s_nodes),
          "root": s_root.hex(), "seconds": bulk_s,
          "pack_s": stats["pack_s"], "device_s": stats["device_s"],
          "levels": bulk_levels,
          "plain_level_loop_seconds": time.perf_counter() - t0})

    # 6. a window of blocks in one deferred session over that state
    src = load_reference_nodes(s_nodes)
    sessions = [deferred.DeferredMPT(src, root_hash=s_root) for _ in range(2)]
    blocks = workloads.TransferBlocks(pairs, rng)
    refs = [[], []]
    t0 = time.perf_counter()
    for _ in range(args.blocks):
        writes = blocks.next(args.writes, args.new_accounts)
        for i, s in enumerate(sessions):
            for k, v in writes.items():
                s = s.put(k, v)
            refs[i].append(s.force_hashed_root())
            sessions[i] = s
    apply_s = time.perf_counter() - t0
    with span_totals() as totals:
        t0 = time.perf_counter()
        w_trie, w_map = deferred.finalize(sessions[0], return_mapping=True,
                                          fused=True, device=dev)
        finalize_s = time.perf_counter() - t0
    spans = {k: v[1] for k, v in totals.items()}
    w_nodes, w_levels = (fused.FUSED_GAUGES["last_nodes"],
                         fused.FUSED_GAUGES["last_levels"])
    l_trie, l_map = deferred.finalize(sessions[1], plain_hasher,
                                      return_mapping=True)
    roots = [w_map[r] for r in refs[0]]
    check(roots == [l_map[r] for r in refs[1]],
          "per-block roots != level loop with the plain hasher")
    _, upserts = w_trie.changes()
    check(upserts == l_trie.changes()[1], "persisted node sets differ")
    hashed = keccak_torch.keccak256_batch_plain(list(upserts.values()), dev)
    check(hashed == list(upserts), "a persisted node is not content-addressed")
    emit({"phase": "window", "blocks": args.blocks, "writes": args.writes,
          "apply_seconds": apply_s, "finalize_seconds": finalize_s,
          "nodes": w_nodes, "levels": w_levels,
          "persisted": len(upserts), "root": roots[-1].hex(),
          "finalize_spans_s": spans})

    torch.cuda.synchronize()
    path = launches.read("state_root", ("k1f", "k5"))
    check(path["k5"] == 3, f"K5 launched {path['k5']} times, not once per "
          "fused_submit (genesis, bulk_100k, window)")
    check(path["k1r"] == 0, f"K1r launched {path['k1r']} times on the "
          "state root path")
    main_s = time.perf_counter() - main_t0
    emit({"phase": "main_path", "seconds": main_s,
          "k5_launches": path["k5"], "k1r_launches": path["k1r"],
          "k1f_launches": path["k1f"]})

    # 7. K5 timed at the 100k trie's and the window's shapes --------------
    per_sm, sms = fixpoint_cuda.occupancy(dev)
    w_resolve, w_deps, _ = deferred.resolution_inputs(sessions[0])
    bulk_resolve, _ = bulk.placeholder_dag(bulk.build_levels(pairs)[1])
    empty = torch.zeros((0, 32), dtype=torch.uint8, device=dev)
    k5_shapes = {}
    for shape, resolve in (("bulk_100k", bulk_resolve),
                           ("window_16x400", w_resolve)):
        classes, _, total, plan = fused.pack(resolve, prefix, dev)
        plain = [fused.PackedClass() for _ in classes]
        for p, c in zip(plain, classes):
            p.nb, p.keys, p.base, p.enc = c.nb, c.keys, c.base, c.enc.clone()
        digests = torch.empty((total, 32), dtype=torch.uint8, device=dev)

        def k5():
            fixpoint_cuda.resolve_levels(
                [c.enc for c in classes], [c.base for c in classes], digests,
                empty, plan.d_order, plan.d_level_ptr, plan.d_tptr,
                plan.d_toff, plan.d_tchild, plan.widest)

        k5()
        plain_g, plain_ms = timed_once(
            torch, lambda: fused.resolve_levels_plain(plain, total, empty,
                                                      plan))
        err = max([int((digests.int() - plain_g.int()).abs().max())]
                  + [int((c.enc.int() - p.enc.int()).abs().max())
                     for c, p in zip(classes, plain)])
        check(err == 0, f"K5 != plain at the {shape} shape")
        k5_err = max(k5_err, err)
        # K5 rewrites the same bytes when run again on its own output
        ms = cuda_ms(torch, k5, 20)
        check(torch.equal(digests, plain_g), f"K5 relaunch changed {shape}")
        # the sharded fixpoint's shape (parallel/fused_sharded.py): one
        # one-level launch a rank's share of a level; here each level in
        # two shares, as two ranks split it, then whole as at world 1
        lvl_dig = torch.zeros_like(digests)
        for lvl in range(plan.nlevels):
            lo, hi = int(plan.level_ptr[lvl]), int(plan.level_ptr[lvl + 1])
            for a, b in ((lo, (lo + hi + 1) // 2), ((lo + hi + 1) // 2, hi)):
                fused.resolve_level_rows(classes, total, empty, plan,
                                         lvl_dig, a, b)
        torch.cuda.synchronize()
        err = max(err, int((lvl_dig.int() - plain_g.int()).abs().max()))
        check(torch.equal(lvl_dig, plain_g),
              f"K5 per level (two shares) != plain at the {shape} shape")
        bounds = [torch.tensor(plan.level_ptr[lvl : lvl + 2],
                               dtype=torch.int32).to(dev)
                  for lvl in range(plan.nlevels)]

        def k5_per_level():
            for lvl, b in enumerate(bounds):
                fused.resolve_level_rows(
                    classes, total, empty, plan, lvl_dig,
                    int(plan.level_ptr[lvl]), int(plan.level_ptr[lvl + 1]), b)

        per_level_ms = cuda_ms(torch, k5_per_level, 20)
        check(torch.equal(lvl_dig, plain_g),
              f"K5 per level (whole) != plain at the {shape} shape")
        k5_err = max(k5_err, err)
        ydig = torch.empty_like(digests)
        # each class's padded rows read as messages of one byte under
        # the class width: the same rate blocks a row as K1 hashed
        headers = [torch.from_numpy(np.concatenate([
            np.arange(c.nrows, dtype=np.int32) * c.enc.shape[1],
            np.full(c.nrows, c.enc.shape[1] - 1, np.int32)])).to(dev)
            for c in classes]
        lib = build.load()
        dev_index, stream = build.launch_args(ydig)

        def k1_rounds():
            for _ in range(plan.nlevels):
                for c, h in zip(classes, headers):
                    lib.khipu_keccak256_ragged(
                        c.enc.data_ptr(), h.data_ptr(),
                        ydig[c.base : c.base + c.nrows].data_ptr(), c.nrows,
                        0, dev_index, stream)

        k1_rounds_ms = cuda_ms(torch, k1_rounds, 10)
        row_blocks = sum(c.nrows * c.nb for c in classes)
        enc_bytes = sum(c.enc.numel() for c in classes)
        ops_ms = row_blocks * SPONGE_OPS_PER_BLOCK / H100_INT32_OPS_PER_S * 1e3
        # encodings read and written once, 8 index bytes a triple, 8 of
        # order and tptr a row, 32 digest bytes written a row
        bytes_ms = (2 * enc_bytes + 8 * plan.ntriples + 40 * total) \
            / H100_BYTES_PER_S * 1e3
        k5_shapes[shape] = {
            "k5_ms": ms, "plain_ms": plain_ms, "k1_rounds_ms": k1_rounds_ms,
            "k5_per_level_ms": per_level_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "ops_ms": ops_ms, "bytes_ms": bytes_ms,
            "levels": plan.nlevels, "rows": total, "row_blocks": row_blocks,
            "triples": plan.ntriples, "widest_level": plan.widest,
            "grid_blocks": min(per_sm * sms, -(-plan.widest // 32)),
            "max_abs_err": err}
        del classes, plain, plan, digests, ydig, plain_g
    emit({"phase": "k5", "blocks_per_sm": per_sm, "sms": sms,
          "shapes": k5_shapes})

    # 8. mirror_verify: BASELINE config #5 on one card ---------------------
    aux = np.random.default_rng(args.seed + 1)
    n_rows, node_len = args.mirror_rows, 576
    m_nblocks = node_len // 136 + 1
    rows = torch.randint(0, 256, (n_rows, node_len), dtype=torch.uint8,
                         device=dev, generator=gen)
    with span_totals() as totals:
        launches.zero()
        t0 = time.perf_counter()
        claims = keccak256_device_fixed(rows, device=dev)
        blob = claims.cpu().numpy().tobytes()
        hashes = [blob[i:i + 32] for i in range(0, len(blob), 32)]
        claims_s = time.perf_counter() - t0
        mirror = DeviceNodeMirror(capacity_rows_per_class=n_rows, device=dev)
        mirror.admit_packed(hashes, rows, exact=True)
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t0
    bookkeep_s = totals["mirror.bookkeep"][1]
    bad = mirror.verify()
    path = launches.read("mirror_verify", ("k1f", "k3", "k4"))
    check(bad == 0, f"mirror verify found {bad} mismatches on clean rows")
    check(mirror.resident_count == n_rows, "resident count != rows admitted")
    row0 = rows[0].cpu().numpy().tobytes()
    sample = aux.choice(n_rows, size=min(1024, n_rows), replace=False)
    sampled = rows[torch.from_numpy(sample).to(dev)].cpu().numpy()
    check(all(hashes[i] == keccak256_py(sampled[j].tobytes())
              for j, i in enumerate(sample)),
          "a K1f claim != scalar oracle")
    check(mirror.get(hashes[0]) == row0, "mirror.get != row 0")
    del rows, claims, blob
    cm = mirror._classes[(m_nblocks, node_len)]
    controls = negative_controls(mirror, cm, n_rows // 3)
    ncmp = min(1 << 20, n_rows)
    k3_err, k4_err = hold_class(torch, device_mirror, mirror_cuda, cm, ncmp,
                                aux)
    nwords_in = cm.nwords

    full, cfull = cm.resident, cm.claimed
    k3_out = torch.empty((8, n_rows), dtype=torch.int32, device=dev)
    k3_ms = cuda_ms_median(torch, lambda: mirror_cuda.hash_planes(
        full, m_nblocks, nwords_in, k3_out), 5)
    check(torch.equal(k3_out, cfull), "K3 at full size != the claims")
    del k3_out
    k4_ms = cuda_ms_median(torch, lambda: mirror_cuda.verify_planes(
        full, cfull, m_nblocks, nwords_in), 5)
    k3_plain_ms = cuda_ms_median(torch, lambda: device_mirror.hash_planes_plain(
        full, m_nblocks, node_len), 1, warmup=False)
    k4_plain_ms = cuda_ms_median(torch, lambda: device_mirror.verify_planes_plain(
        full, cfull, m_nblocks, node_len), 1, warmup=False)
    resident_bytes = full.numel() * 4
    claim_bytes = cfull.numel() * 4
    k3_bound, k3_bound_by = sponge_bound_ms(n_rows, m_nblocks,
                                            resident_bytes + claim_bytes)
    k4_bound, k4_bound_by = sponge_bound_ms(n_rows, m_nblocks,
                                            resident_bytes + claim_bytes + 4)
    emit({"phase": "mirror_verify", "rows": n_rows, "bytes": node_len,
          "resident_gb": resident_bytes / 1e9, "claimed_gb": claim_bytes / 1e9,
          "claims_seconds": claims_s, "ingest_seconds": ingest_s,
          "bookkeep_seconds": bookkeep_s,
          "bookkeep_us_per_row": bookkeep_s / n_rows * 1e6,
          "negative_controls": controls,
          "k4_ms_median5": k4_ms, "k4_bound_ms": k4_bound,
          "k4_bound_by": k4_bound_by,
          "k4_ops_ms": n_rows * m_nblocks * SPONGE_OPS_PER_BLOCK
          / H100_INT32_OPS_PER_S * 1e3,
          "k4_bytes_ms": (resident_bytes + claim_bytes) / H100_BYTES_PER_S * 1e3,
          "k3_ms_median5": k3_ms, "k3_plain_ms": k3_plain_ms,
          "k4_plain_ms": k4_plain_ms, "compare_cols": ncmp,
          "launches": path})
    del mirror, cm, full, cfull
    torch.cuda.empty_cache()

    # 9. fast_sync: the 100k-account state with contracts ------------------
    t0 = time.perf_counter()
    src_root, stores = workloads.contract_snapshot(pairs, aux, device=dev)
    src_nodes, st_nodes, code_store = stores
    source_s = time.perf_counter() - t0
    contract = Account.decode(MerklePatriciaTrie(
        load_reference_nodes(src_nodes), root_hash=src_root).get(pairs[0][0]))
    slot1 = MerklePatriciaTrie(load_reference_nodes(st_nodes),
                               root_hash=contract.storage_root).get(
        keccak256_py((1).to_bytes(32, "big")))
    check(slot1 == rlp_encode_int(2) and contract.code_hash in code_store,
          "contract account, slot 1 or code blob not in the snapshot")
    snapshot = sum(len(s) for s in stores)
    peer = workloads.snapshot_fetch(stores)
    fetched = {"calls": 0, "victim": None, "deliveries": 0}

    def fetch(want):
        fetched["calls"] += 1
        out = peer(want)
        if fetched["victim"] is None and fetched["calls"] == 5:
            victim = want[len(want) // 2]
            bent = bytearray(out[victim])
            bent[len(bent) // 2] ^= 0x01
            out[victim] = bytes(bent)
            fetched["victim"] = victim
        if fetched["victim"] in out:
            fetched["deliveries"] += 1
        return out

    target = Storages()
    capacity = -(-snapshot // device_mirror.TILE) * device_mirror.TILE
    sync_mirror = DeviceNodeMirror(capacity_rows_per_class=capacity, device=dev)
    syncer = StateSyncer(target, FastSyncStateStorage(MemoryKeyValueDataSource()),
                         fetch, mirror=sync_mirror, device=dev)
    with span_totals() as totals:
        launches.zero()
        t0 = time.perf_counter()
        state = syncer.start(src_root)
        torch.cuda.synchronize()
        sync_s = time.perf_counter() - t0
        path = launches.read("fast_sync", ("k1r", "k3", "k4"))
    sync_spans = {k: v[1] for k, v in totals.items()}
    verify_calls = totals["fastsync.verify"][0]
    check(path["k1r"] == verify_calls, f"K1r launched {path['k1r']} times "
          f"for {verify_calls} content checks, not once each")
    check(fetched["deliveries"] == 2, "the corrupt node was not retried once")
    for got, want in ((target.account_node_storage, src_nodes),
                      (target.storage_node_storage, st_nodes),
                      (target.evmcode_storage, code_store)):
        check(got.source._map == want, "a synced store != its source")
    check(state.downloaded_nodes == snapshot,
          f"downloaded {state.downloaded_nodes} != snapshot {snapshot}")
    check(sync_mirror.verify() == 0, "mirror verify after sync != 0")
    check(sync_mirror.resident_count == len(src_nodes) + len(st_nodes),
          "mirror does not hold every state and storage node")
    check(sync_mirror.get(src_root) == target.account_node_storage.get(src_root),
          "mirror.get(root) != the store's copy")
    check(target.app_state.fast_sync_done, "fast sync not marked done")
    t0 = time.perf_counter()
    walk = verify_reachable(target.account_node_storage,
                            target.storage_node_storage,
                            target.evmcode_storage, src_root)
    walk_s = time.perf_counter() - t0
    check(walk.missing == 0 and walk.total == snapshot,
          f"verify_reachable: {walk}")
    sync_held = hold_mirror(torch, device_mirror, mirror_cuda, sync_mirror,
                            aux)
    k3_err = max(k3_err, sync_held["k3_err"])
    k4_err = max(k4_err, sync_held["k4_err"])
    emit({"phase": "fast_sync", "accounts": n_acc,
          "contracts": len(code_store),
          "nodes": snapshot, "state_nodes": len(src_nodes),
          "storage_nodes": len(st_nodes), "code_blobs": len(code_store),
          "root": src_root.hex(), "seconds": sync_s,
          "nodes_per_s": snapshot / sync_s, "source_seconds": source_s,
          "fetch_calls": fetched["calls"],
          "mirror_classes": sorted(nb for nb, _ in sync_mirror._classes),
          "verify_span_s": sync_spans.get("fastsync.verify", 0.0),
          "verify_calls": verify_calls,
          "spans_s": sync_spans, "reachable_walk_seconds": walk_s,
          "held_against_plain": sync_held, "launches": path})
    # the snapshot segment_ingest_100k streams, and the time to beat
    fs100k = {"root": src_root, "stores": stores, "seconds": sync_s}
    del sync_mirror, target, syncer

    # 10. window_admit: the window's admit tiles into a mirror ------------
    session = sessions[0]
    live = {ph for ph, rec in session._logs.items()
            if deferred._is_placeholder(ph) and rec[0] > 0}
    launches.zero()
    t0 = time.perf_counter()
    job = fused.fused_submit(w_resolve, w_deps, deferred._PLACEHOLDER_PREFIX,
                             device=dev, admit_live=live)
    mapping = job.collect()
    tiles = job.admit_tiles
    capacity = max(enc.shape[0] for _, _, enc, _, _ in tiles)
    w_mirror = DeviceNodeMirror(capacity_rows_per_class=capacity, device=dev)
    for nb, keys, enc_g, claim_g, lens in tiles:
        w_mirror.admit_device(nb, keys, enc_g, claim_g, lens)
    moved = w_mirror.rekey(mapping)
    bad = w_mirror.verify()
    torch.cuda.synchronize()
    admit_s = time.perf_counter() - t0
    path = launches.read("window_admit", ("k5", "k4"))
    check(mapping == w_map, "admit_live fixpoint mapping != finalize's")
    check(bad == 0, f"window mirror verify found {bad} mismatches")
    check(moved == len(live), f"rekey moved {moved} of {len(live)} rows")
    real = {mapping[ph] for ph in live}
    spilled = w_mirror.spill_rows(list(real))
    check(set(spilled) == real, "spill_rows missed a rekeyed row")
    check(all(upserts.get(k, v) == v for k, v in spilled.items()),
          "spill_rows != the persisted node encodings")
    w_held = hold_mirror(torch, device_mirror, mirror_cuda, w_mirror, aux)
    k3_err = max(k3_err, w_held["k3_err"])
    k4_err = max(k4_err, w_held["k4_err"])
    emit({"phase": "window_admit", "live": len(live), "nodes": len(w_resolve),
          "tiles": sum(enc.shape[0] for _, _, enc, _, _ in tiles)
          // device_mirror.TILE, "classes": [t[0] for t in tiles],
          "rekeyed": moved, "spilled": len(spilled),
          "spilled_persisted": len(real & set(upserts)),
          "persisted": len(upserts), "seconds": admit_s,
          "held_against_plain": w_held, "launches": path})
    del w_mirror, job

    # 10b. K6 against its plain version --------------------------------
    k6 = k6_phase(args, torch, np, dev, rng)
    emit(k6)

    replay_err, chains = replay_phases(args, torch, dev, launches, packed,
                                       hold_ragged)
    k1r_err = max(k1r_err, replay_err)
    k5_replay, w8 = windowed_phases(args, torch, dev, launches, chains,
                                    k1f_hashes_per_s=n_msg
                                    / (big_ms["k1f"] / 1e3))
    k5_err = max(k5_err, max(w["max_abs_err"] for w in k5_replay.values()))
    emit(ethash_phase())
    rec = recovery_helpers(args, torch, dev, launches, w8)
    recovery_phases(args, torch, dev, launches, w8, rec,
                    chains["replay_erc20"][2])
    kesque_phases(args, torch, dev, launches, w8, rec, fs100k)
    chain100k = w8["chain_100k"]
    unloaded_100k = w8["blocks_per_s_100k"]
    nodes_100k = w8["nodes_100k"]
    small_chain = chains["replay_erc20"][1:3]  # (genesis spec, blocks)
    del w8, chains, rec, fs100k
    emit(live_sync_phase(args, torch, dev, launches, chain100k))
    for line in serve_phase(torch, dev, launches, chain100k, unloaded_100k):
        emit(line)
    for line in bridge_cluster_phase(torch, dev, launches, chain100k,
                                     nodes_100k, small_chain, unloaded_100k):
        emit(line)
    del chain100k, nodes_100k, small_chain
    gc.collect()
    torch.cuda.empty_cache()
    for line in parallel_mesh_phase(launches):
        emit(line)

    tot = launches.total
    k1r_main = batch100["100x1+4"]
    k5_window = k5_shapes["window_16x400"]
    emit({"kernels": [
        {"name": "keccak_ragged_k1r", "route": "cuda",
         "source": "khipu_tpu_torch/ops/csrc/keccak.cu",
         "replaces": "khipu_tpu/ops/keccak_pallas.py:41 and :295; per "
         "rank, khipu_tpu/parallel/keccak_sharded.py:159 (XLA)",
         "launches": tot["k1r"], "max_abs_err": k1r_err,
         "launches_note": "fast sync's content checks, each replay's "
         "genesis load and sender batches, the serial replays' trie "
         "commits, the per-block adoption's and the rebuilt ancestor "
         "states' commits (the windowed replays' commits launch K5 "
         "instead); live_sync_erc20_100k: the client's genesis load, "
         "FastSyncService's content checks over the wire, regular sync's "
         "sender batches and the pushed block's per-block import on a "
         "peer's reader thread; serve_erc20_100k_w8: the board's and the "
         "replica's genesis loads, the import's sender batches, the "
         "replica's per-block commits, the switch's rebuilt ancestor and "
         "per-block adoption on both nodes; bridge_cluster_100k_w8: the "
         "boards' genesis loads and the sender batches of every "
         "ExecuteBlocks; parallel_mesh: one a rank a call of the sharded "
         "hasher (the bulk builds' levels, world 1 and both world-2 "
         "ranks)",
         "shape": "100 rows, 1 and 4 rate blocks mixed, column mode",
         "ms": k1r_main["column_kernel_us"] / 1e3,
         "plain_ms": k1r_main["plain_us"] / 1e3,
         "bound_ms": k1r_main["bound_us"] / 1e3,
         "bound_by": k1r_main["bound_by"], "library_ms": None},
        {"name": "keccak_fixed_k1f", "route": "cuda",
         "source": "khipu_tpu_torch/ops/csrc/keccak.cu",
         "replaces": "khipu_tpu/ops/keccak_pallas.py:181; per rank, "
         "khipu_tpu/parallel/keccak_sharded.py:32 (_fixed_digests, XLA)",
         "launches": tot["k1f"], "max_abs_err": k1f_err,
         "launches_note": "the state root path's account keys (genesis, "
         "100k) and mirror_verify's claims; parallel_mesh: one a rank a "
         "sharded fixed hash (commit step 2, keccak256_fixed_sharded 1, "
         "hash_level_all_gather 1, snapshot_verify_sharded 2; world 1 "
         "and both world-2 ranks)",
         "ms": k1f_ms, "plain_ms": k1f_plain_ms, "bound_ms": k1f_bound,
         "bound_by": k1f_bound_by, "library_ms": None},
        {"name": "fixpoint_levels_k5", "route": "cuda",
         "source": "khipu_tpu_torch/trie/csrc/fixpoint.cu",
         "replaces": "khipu_tpu/trie/fused.py:193; a level a rank, "
         "khipu_tpu/parallel/fused_sharded.py:39 (XLA)",
         "launches": tot["k5"], "max_abs_err": k5_err,
         "launches_note": "state root 3, window_admit 1, one a device "
         "window of each windowed replay (the kesque replay among them), "
         "killed run, resume and windowed adoption; live_sync_erc20_100k: "
         "RegularSyncService's windowed import after the fast sync, 2; "
         "serve_erc20_100k_w8: the import under RPC load, one a window; "
         "bridge_cluster_100k_w8: one a window of every ExecuteBlocks "
         "batch, two shards' batches at once among them; parallel_mesh: "
         "one a level a rank's share of the sharded fixpoint reaches "
         "(the session, the bulk DAG and the window; world 1 once a "
         "level)",
         "shape": "window_16x400",
         "ms": k5_window["k5_ms"], "plain_ms": k5_window["plain_ms"],
         "bound_ms": k5_window["bound_ms"], "bound_by": k5_window["bound_by"],
         "library_ms": None,
         "replay_windows": {name: {k: w[k] for k in (
             "k5_ms", "plain_ms", "bound_ms", "rows", "levels")}
             for name, w in k5_replay.items()}},
        {"name": "mirror_hash_k3", "route": "cuda",
         "source": "khipu_tpu_torch/storage/csrc/mirror.cu",
         "replaces": "khipu_tpu/storage/device_mirror.py:80",
         "launches": tot["k3"], "max_abs_err": k3_err,
         "launches_note": "mirror_verify's partial tile, fast sync's "
         "admits; a size class's filler digest is hashed once a process "
         "and card, so live_sync_erc20_100k's mirror, whose classes "
         "earlier phases made, launches none (its regular sync would "
         "launch one a class if run alone); parallel_mesh none (no "
         "mirror)",
         "ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_bound,
         "bound_by": k3_bound_by, "library_ms": None},
        {"name": "mirror_verify_k4", "route": "cuda",
         "source": "khipu_tpu_torch/storage/csrc/mirror.cu",
         "replaces": "khipu_tpu/storage/device_mirror.py:167",
         "launches": tot["k4"], "max_abs_err": k4_err,
         "launches_note": "each mirror verify: mirror_verify, fast sync, "
         "window_admit, every windowed replay's and resume's gate, "
         "live_sync_erc20_100k's mirror after its windowed import, and "
         "serve_erc20_100k_w8's after its import; parallel_mesh none "
         "(its verify is K1f and a compare)",
         "ms": k4_ms, "plain_ms": k4_plain_ms, "bound_ms": k4_bound,
         "bound_by": k4_bound_by, "library_ms": None},
        {"name": "exec_validate_k6", "route": "cuda",
         "source": "khipu_tpu_torch/trie/csrc/exec_validate.cu",
         "replaces": "khipu_tpu/trie/fused.py:721 (_exec_validate_fn, an "
         "XLA program)",
         "launches": tot["k6"], "max_abs_err": k6["max_abs_err"],
         "launches_note": "one a fast batch of replay_transfers_par_w16 "
         "(exec_device on); 0 elsewhere, parallel_mesh among them",
         "shape": "200 rows (a block's transfer batch)",
         "ms": k6["sizes"][200]["ms"], "plain_ms": k6["sizes"][200]["plain_ms"],
         "bound_ms": k6["sizes"][200]["bound_ms"], "bound_by": "bytes",
         "bound_note": "max(81 B a row / 3.35e12 B/s, the launch floor)",
         "library_ms": None},
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
