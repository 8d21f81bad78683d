#!/usr/bin/env python3
"""Drive the khipu_tpu_torch port on one NVIDIA card and check it.

    python3 chip_smoke.py [--seed N]

Builds kernels K1 (Keccak sponge) and K2 (fixpoint substitution) from
the repository's CUDA sources, holds each against its plain PyTorch
version on the card, then drives the state-root pipeline through the
entry points a user calls:

  1. build K1 + K2 with nvcc
  2. K1 vs the plain sponge: rate-class edges, 1,048,576 x 576 B, and a
     mixed-length ``keccak256_batch`` in input order
  3. K1 + K2 fixpoint vs the plain fixpoint on the card: ``fused_submit``
     with a resolved-input (ext) tile and mirror admit rows
  4. mainnet genesis (8,893 accounts): ``bulk_build(fused=True)`` root
     equals geth's
  5. a fresh 100,000-account state trie: ``bulk_build(fused=True)``
     equals the level loop with the plain hasher (root and node dict)
  6. a window of 16 blocks x 400 account writes in one ``DeferredMPT``
     session, ``finalize(fused=True)``: every per-block root and the
     persisted node set equal the level loop with the plain hasher
  7. launch counts of phases 4-6, kernel timings, the result line

Every comparison is exact (bytes). Each phase prints one JSON line; the
first line is the card's name and power limit from nvidia-smi, the line
before the last lists the kernels, and the last line is the result. Any
failure exits non-zero before the result line; without a card the
script exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GENESIS_ROOT = "d7f8974fb5ac78d9ac099b9ad5018bedc2ce0a72dad1827a1709da30580f0544"
EDGES = (0, 1, 31, 32, 135, 136, 137, 271, 272, 543, 544, 576)

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
K1_OPS_PER_BLOCK = 180 * 24 + 34


def emit(obj) -> None:
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


def k1_bound_ms(n_rows: int, nblocks: int) -> tuple:
    ops_s = n_rows * nblocks * K1_OPS_PER_BLOCK / H100_INT32_OPS_PER_S
    bytes_s = n_rows * (nblocks * 136 + 32) / H100_BYTES_PER_S
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s >= bytes_s else "bytes")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--messages", type=int, default=1 << 20)
    ap.add_argument("--accounts", type=int, default=100_000)
    ap.add_argument("--blocks", type=int, default=16)
    ap.add_argument("--writes", type=int, default=400)
    ap.add_argument("--new-accounts", type=int, default=20)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    from khipu_tpu_torch import observability, workloads
    from khipu_tpu_torch.base.keccak import keccak256_py
    from khipu_tpu_torch.domain.account import Account, address_key
    from khipu_tpu_torch.ops import build, keccak_cuda, keccak_torch
    from khipu_tpu_torch.ops.keccak import keccak256_batch
    from khipu_tpu_torch.state import load_reference_nodes
    from khipu_tpu_torch.trie import bulk, deferred, fixpoint_cuda, fused

    print(card_line(), flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    plain_hasher = lambda msgs: keccak_torch.keccak256_batch_plain(msgs, dev)  # noqa: E731

    def plain_hash_rows(enc, out):
        out.copy_(keccak_torch.absorb_padded(enc))
        return out

    # 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    build.load()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": [str(p.relative_to(ROOT)) for p in build.sources()],
          "ptxas": [ln.strip() for entry in build.BUILD_LOG
                    for ln in entry.splitlines() if "registers" in ln]})

    # 2. K1 against the plain sponge --------------------------------------
    edge_msgs = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                 for n in EDGES]
    for nb in sorted({len(m) // 136 + 1 for m in edge_msgs}):
        group = [m for m in edge_msgs if len(m) // 136 + 1 == nb]
        rows = torch.from_numpy(
            keccak_torch.pad_to_words(group, nb).view(np.uint8).copy()
        ).to(dev)
        got = keccak_cuda.absorb_padded(rows)
        check(torch.equal(got, keccak_torch.absorb_padded(rows)),
              f"K1 != plain at {nb} blocks")
        check([got[i].cpu().numpy().tobytes() for i in range(len(group))]
              == [keccak256_py(m) for m in group],
              f"K1 != scalar oracle at {nb} blocks")

    n_msg, length = args.messages, 576
    nblocks = length // 136 + 1
    data = torch.randint(0, 256, (n_msg, length), dtype=torch.uint8,
                         device=dev, generator=gen)
    padded = torch.zeros((n_msg, nblocks * 136), dtype=torch.uint8, device=dev)
    padded[:, :length] = data
    padded[:, length] ^= 0x01
    padded[:, -1] ^= 0x80
    del data
    k1_out = keccak_cuda.absorb_padded(padded)
    plain_out = keccak_torch.absorb_padded(padded)
    torch.cuda.synchronize()
    k1_err = int((k1_out.int() - plain_out.int()).abs().max())
    check(k1_err == 0 and torch.equal(k1_out, plain_out),
          "K1 != plain at 1M x 576")
    for i in (0, 1, n_msg // 2, n_msg - 1):
        check(k1_out[i].cpu().numpy().tobytes()
              == keccak256_py(padded[i, :length].cpu().numpy().tobytes()),
              f"K1 != scalar oracle at row {i}")
    k1_ms = cuda_ms(torch, lambda: keccak_cuda.absorb_padded(padded, k1_out), 10)
    k1_plain_ms = cuda_ms(torch, lambda: keccak_torch.absorb_padded(padded), 2)
    k1_bound, k1_bound_by = k1_bound_ms(n_msg, nblocks)
    del padded, plain_out, k1_out

    lens = rng.integers(0, 600, 5000)
    mixed = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
             for n in lens]
    got = keccak256_batch(mixed, device=dev)
    check(got == plain_hasher(mixed), "keccak256_batch != plain (mixed)")
    check(all(got[i] == keccak256_py(mixed[i]) for i in range(0, 5000, 97)),
          "keccak256_batch != scalar oracle (mixed)")
    emit({"phase": "k1", "messages": n_msg, "bytes": length,
          "k1_ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
          "hashes_per_s": n_msg / (k1_ms / 1e3), "max_abs_err": k1_err,
          "mixed_batch": len(mixed)})

    # 3. K1 + K2 fixpoint against the plain fixpoint on the card ----------
    session = deferred.DeferredMPT(load_reference_nodes({}))
    for i in range(3000):
        session = session.put(
            address_key(b"phase3" + i.to_bytes(14, "big")),
            Account(i, 10**18 + int(rng.integers(0, 10**9))).encode(),
        )
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
    rounds = fused.FUSED_GAUGES["last_rounds"]
    classes, _, total = fused.pack(tr, prefix, dev, ext_pos, len(ext_keys),
                                   live)
    plain_g = fused.run_fixpoint(classes, total, ext, rounds,
                                 hash_rows=plain_hash_rows,
                                 scatter=fused._substitute_plain)
    check(job.collect() == {ph: truth[ph] for ph in tr},
          "fixpoint digests != truth")
    tiles = {t[0]: t for t in job.admit_tiles}
    for c, enc in zip(classes, job.encs):
        real = slice(c.base, c.base + len(c.keys))
        check(torch.equal(job.digests[real], plain_g[real]),
              f"fixpoint digests != plain (class {c.nb})")
        check(torch.equal(enc[: len(c.keys)], c.enc[: len(c.keys)]),
              f"final encodings != plain (class {c.nb})")
        if c.aidx is not None:
            nb, keys, enc_g, claim_g, _ = tiles[c.nb]
            n_live = sum(k is not None for k in keys)
            check(torch.equal(enc_g[:n_live],
                              c.enc.index_select(0, c.aidx)[:n_live]),
                  f"admit encodings != plain (class {c.nb})")
            check(torch.equal(claim_g[:n_live], plain_g.index_select(
                0, c.aidx + c.base)[:n_live]),
                  f"admit digests != plain (class {c.nb})")
    emit({"phase": "fixpoint", "nodes": len(tr), "ext_rows": len(ext_keys),
          "admit": len(live), "rounds": rounds, "classes": len(classes)})

    # 4-6: the main path, with the launch counts zeroed just before -------
    keccak_cuda.LAUNCHES = 0
    fixpoint_cuda.LAUNCHES = 0
    fused.FUSED_GAUGES["unsupported_fallbacks"] = 0
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
    bulk_rounds = fused.FUSED_GAUGES["last_rounds"]
    t0 = time.perf_counter()
    check((s_root, s_nodes) == bulk.bulk_build(pairs, hasher=plain_hasher),
          "100k bulk build != level loop with the plain hasher")
    emit({"phase": "bulk_100k", "accounts": n_acc, "nodes": len(s_nodes),
          "root": s_root.hex(), "seconds": bulk_s,
          "pack_s": stats["pack_s"], "device_s": stats["device_s"],
          "rounds": bulk_rounds,
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
    observability.SPANS.clear()
    observability.enable()
    t0 = time.perf_counter()
    w_trie, w_map = deferred.finalize(sessions[0], return_mapping=True,
                                      fused=True, device=dev)
    finalize_s = time.perf_counter() - t0
    observability.enable(False)
    spans = {}
    for name, sec, _ in observability.SPANS:
        spans[name] = spans.get(name, 0.0) + sec
    w_nodes, w_rounds = (fused.FUSED_GAUGES["last_nodes"],
                         fused.FUSED_GAUGES["last_rounds"])
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
          "nodes": w_nodes, "depth": w_rounds, "rounds": w_rounds,
          "persisted": len(upserts), "root": roots[-1].hex(),
          "finalize_spans_s": spans})

    torch.cuda.synchronize()
    k1_launches, k2_launches = keccak_cuda.LAUNCHES, fixpoint_cuda.LAUNCHES
    fallbacks = fused.FUSED_GAUGES["unsupported_fallbacks"]
    main_s = time.perf_counter() - main_t0

    # 7. K2 timed at the 100k trie's shapes (one round over every class)
    to_resolve, _ = bulk.placeholder_dag(bulk.build_levels(pairs)[1])
    classes, _, total = fused.pack(to_resolve, deferred._PLACEHOLDER_PREFIX,
                                   dev)
    empty = torch.zeros((0, 32), dtype=torch.uint8, device=dev)
    digests = torch.empty((total, 32), dtype=torch.uint8, device=dev)
    for c in classes:
        keccak_cuda.absorb_padded(c.enc, digests[c.base : c.base + c.nrows])
    encs_k = [c.enc.clone() for c in classes]
    encs_p = [c.enc.clone() for c in classes]

    def k2_round(encs=encs_k):
        for c, e in zip(classes, encs):
            fixpoint_cuda.substitute(e, c.rows, c.offs, c.child, digests,
                                     empty, total)

    def plain_round(encs=encs_p):
        for c, e in zip(classes, encs):
            fused._substitute_plain(e, c.rows, c.offs, c.child, digests,
                                    empty, total)

    k2_round()
    plain_round()
    torch.cuda.synchronize()
    k2_err = max(int((a.int() - b.int()).abs().max())
                 for a, b in zip(encs_k, encs_p))
    check(k2_err == 0, "K2 != plain substitution at the 100k shapes")
    k2_ms = cuda_ms(torch, k2_round, 20)
    k2_plain_ms = cuda_ms(torch, plain_round, 20)
    n_subs = sum(c.nsubs for c in classes)
    k2_bound = n_subs * (12 + 32 + 32) / H100_BYTES_PER_S * 1e3

    check(k1_launches > 0, "K1 was not launched on the main path")
    check(k2_launches > 0, "K2 was not launched on the main path")
    check(fallbacks == 0, "a fused finalize fell back to the level loop")
    emit({"phase": "main_path", "seconds": main_s,
          "k1_launches": k1_launches, "k2_launches": k2_launches,
          "unsupported_fallbacks": fallbacks, "k2_triples": n_subs,
          "k2_classes": len(classes)})

    emit({"kernels": [
        {"name": "keccak_sponge_k1", "route": "cuda",
         "source": "khipu_tpu_torch/ops/csrc/keccak.cu",
         "replaces": "khipu_tpu/ops/keccak_pallas.py:41",
         "launches": k1_launches, "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_bound_by, "library_ms": None},
        {"name": "fixpoint_substitute_k2", "route": "cuda",
         "source": "khipu_tpu_torch/trie/csrc/fixpoint.cu",
         "replaces": "khipu_tpu/trie/fused.py:193",
         "launches": k2_launches, "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
         "bound_by": "bytes", "library_ms": None},
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
