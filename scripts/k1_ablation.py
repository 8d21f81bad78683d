#!/usr/bin/env python3
"""K1r against the design it replaced, on fast sync's own batches, and
its two modes across batch sizes, on one NVIDIA card.

    python3 scripts/k1_ablation.py [--seed N] [--rounds R]

1. Records the batches fast sync's content check hashes: chip_smoke's
   fast_sync_100k workload (100,000 accounts, 1,000 contracts) synced by
   ``StateSyncer`` with a hasher that keeps each batch and hashes it with
   ``keccak256_batch``.
2. Replays that sequence, ``--rounds`` times with the order of the
   designs rotated each round, through
     per_class_rows  the design K1r replaced: bucket by rate class, pad
                     each class on the host (``pad_to_words``), and per
                     class one upload (header and padded rows), one
                     row-mode launch and one copy back
     ragged_rows     ``keccak256_batch``'s path with row mode forced: one
                     packed blob and header in one upload, one launch a
                     batch
     ragged_columns  the same in column mode
   and checks every replay's digests against the recorded ones. Reports
   host seconds over the whole sequence (median, least, most of the
   rounds), then each design once under ``torch.profiler``: its kernel
   launches and their device time.
3. Sweeps n x 576 B rows for the mode switch: each mode's kernel time
   (profiler, after a warm-up) beside K1f's on the same rows, in turns.
4. Paces the replay as the sync loop does (a pause between content
   checks, ``--pause-ms``, over the first ``--paced`` batches) and
   reports the host time of the hash calls alone beside the same calls
   back to back: a pause spent asleep (host and card idle) and one spent
   spinning on the host (only the card idle).
5. Column mode against rewrites of its own source, each built as its
   own library under ``khipu_tpu_torch/_build/k1_ablation/``:
     prefetch      the next block's lanes are loaded during this block's
                   permutation, not at the top of their own step
     u64_stores    rho's swap of halves by selects and one 64-bit store
                   a lane, not by two 32-bit stores at swapped addresses
     fewer_loads   chi reads only its own column from the tile (timing
                   only: wrong digests)
     no_shuffle    theta's D from its own column parity (timing only)
   timed with the profiler at 100 rows x 1, 4 and 16 rate blocks in
   rotated rounds; the exact variants must give the plain digests.
   Each variant's registers and spills from ``-Xptxas -v``, and K1r's
   row and column kernels' as built.

Prints the card line, then one JSON line per part. Exits 2 without a
card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWEEP = (100, 1000, 2000, 3000, 4000, 6000, 10_000, 100_000, 1 << 20)
SRC = os.path.join(ROOT, "khipu_tpu_torch", "ops", "csrc", "keccak.cu")

_PREFETCH = (
    "    for (int b = 0; b < warp_nb; ++b) {\n"
    "        if (b < nb) {\n"
    "            uint64_t v[4];\n"
    "            column_block(p, len, nb, b, x, v);\n"
    "#pragma unroll\n"
    "            for (int y = 0; y < 4; ++y) a[y] ^= v[y];\n"
    "        }\n",
    "    uint64_t v[4];\n"
    "    if (nb > 0) column_block(p, len, nb, 0, x, v);\n"
    "    for (int b = 0; b < warp_nb; ++b) {\n"
    "        if (b < nb) {\n"
    "#pragma unroll\n"
    "            for (int y = 0; y < 4; ++y) a[y] ^= v[y];\n"
    "        }\n"
    "        if (b + 1 < nb) column_block(p, len, nb, b + 1, x, v);\n")
_U64 = (
    "        words[t.hi_at[y]] = __funnelshift_l(lo, hi, t.n[y]);\n"
    "        words[t.lo_at[y]] = __funnelshift_l(hi, lo, t.n[y]);\n",
    "        const uint32_t X = __funnelshift_l(lo, hi, t.n[y]);\n"
    "        const uint32_t Y = __funnelshift_l(hi, lo, t.n[y]);\n"
    "        const bool swap = t.hi_at[y] < t.lo_at[y];\n"
    "        *reinterpret_cast<uint2*>(words + (t.hi_at[y] & ~1)) =\n"
    "            make_uint2(swap ? X : Y, swap ? Y : X);\n")
# variant -> (text in keccak.cu, its replacement) pairs
VARIANTS = {
    "k1r": [],
    "prefetch": [_PREFETCH],
    "u64_stores": [_U64],
    "fewer_loads": [
        ("        const uint2 w1 = tile[t.x1 + 5 * y][t.g];\n"
         "        const uint2 w2 = tile[t.x2 + 5 * y][t.g];\n",
         "        const uint2 w1 = w0, w2 = w0;\n")],
    "no_shuffle": [
        ("    const uint64_t cl = __shfl_sync(kColMask, c, t.left);\n"
         "    const uint64_t cr = __shfl_sync(kColMask, c, t.right);\n",
         "    const uint64_t cl = c, cr = c;\n")],
}
EXACT = ("k1r", "prefetch", "u64_stores")


def build_variants(build) -> dict:
    """Each variant's source written and compiled, all nvcc processes
    started together; returns name -> (ctypes library, ptxas lines)."""
    import ctypes
    import subprocess

    out_dir = os.path.join(str(build.BUILD_DIR), "k1_ablation")
    os.makedirs(out_dir, exist_ok=True)
    text = open(SRC).read()
    procs = {}
    for name, subs in VARIANTS.items():
        src = text
        for old, new in subs:
            if old not in src:
                raise SystemExit(f"{name}: {old!r} is not in keccak.cu")
            src = src.replace(old, new)
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(src)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", os.path.dirname(SRC),
             "-shared", "-o", os.path.join(out_dir, f"{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
        lib.khipu_keccak256_ragged.argtypes = [p, p, p, i, i, i, p]
        lib.khipu_keccak256_ragged.restype = i
        libs[name] = (lib, log)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--accounts", type=int, default=100_000)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--paced", type=int, default=300)
    ap.add_argument("--pause-ms", type=float, default=20.0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("k1_ablation: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    from chip_smoke import card_line, kernel_us, per_class_rows, ptxas_by_kernel
    from khipu_tpu_torch import workloads
    from khipu_tpu_torch.ops import build, keccak_cuda, keccak_torch
    from khipu_tpu_torch.ops.keccak import keccak256_batch, stage_ragged
    from khipu_tpu_torch.storage.datasource import MemoryKeyValueDataSource
    from khipu_tpu_torch.storage.storages import Storages
    from khipu_tpu_torch.sync.fast_sync import FastSyncStateStorage, StateSyncer

    print(card_line(), flush=True)
    dev = torch.device("cuda")
    build.load()

    # 1. the batches of a fast sync --------------------------------------
    pairs = workloads.fresh_state_pairs(args.accounts, device=dev)
    src_root, stores = workloads.contract_snapshot(
        pairs, np.random.default_rng(args.seed + 1), device=dev)
    batches, digests = [], []

    def recording(values):
        batches.append(list(values))
        out = keccak256_batch(values, dev)
        digests.append(out)
        return out

    StateSyncer(Storages(), FastSyncStateStorage(MemoryKeyValueDataSource()),
                workloads.snapshot_fetch(stores), hasher=recording,
                device=dev).start(src_root)
    sizes = [len(b) for b in batches]
    classes = [len({len(m) // 136 + 1 for m in b}) for b in batches]
    blocks = [max(len(m) // 136 + 1 for m in b) for b in batches]

    # 2. the designs over that sequence ----------------------------------
    def ragged(mode):
        def run(msgs):
            blob, offsets, lengths = keccak_torch.pack_ragged(msgs)
            blob_d, header_d = stage_ragged(blob, offsets, lengths, dev)
            got = keccak_cuda.absorb_ragged(blob_d, offsets, lengths,
                                            mode=mode, header=header_d)
            raw = got.cpu().numpy().tobytes()
            return [raw[i : i + 32] for i in range(0, len(raw), 32)]
        return run

    designs = {"per_class_rows": lambda msgs: per_class_rows(
                   torch, np, build, keccak_torch, msgs, dev),
               "ragged_rows": ragged("row"),
               "ragged_columns": ragged("column")}
    for name, fn in designs.items():
        if [fn(b) for b in batches] != digests:
            raise SystemExit(f"{name} != keccak256_batch on the recorded batches")
    names = list(designs)
    host = {name: [] for name in names}
    for rnd in range(args.rounds):
        for name in names[rnd % 3:] + names[: rnd % 3]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b in batches:
                designs[name](b)
            host[name].append(time.perf_counter() - t0)
    replay = {}
    for name in names:
        t = sorted(host[name])
        launches, device_us = kernel_us(
            torch, lambda name=name: [designs[name](b) for b in batches], 1,
            "ragged")
        replay[name] = {"host_s_median": t[len(t) // 2], "host_s_min": t[0],
                        "host_s_max": t[-1], "launches": launches,
                        "device_ms": device_us * launches / 1e3,
                        "us_per_launch": device_us}
    print(json.dumps({
        "part": "fast_sync_replay", "batches": len(batches),
        "messages": sum(sizes), "rows_max": max(sizes),
        "rate_classes_mean": sum(classes) / len(classes),
        "batches_by_max_blocks": {str(k): blocks.count(k)
                                  for k in sorted(set(blocks))},
        "rounds": args.rounds, "designs": replay}), flush=True)

    # 3. the two modes across batch sizes --------------------------------
    sweep = {}
    for n in SWEEP:
        data = torch.randint(0, 256, (n, 576), dtype=torch.uint8, device=dev)
        offsets = np.arange(n, dtype=np.int32) * 576
        lengths = np.full(n, 576, np.int32)
        flat = data.view(-1)
        outs = {m: keccak_cuda.absorb_ragged(flat, offsets, lengths, mode=m)
                for m in ("row", "column")}
        fixed = keccak_cuda.absorb_fixed(data)
        torch.cuda.synchronize()
        if not all(torch.equal(o, fixed) for o in outs.values()):
            raise SystemExit(f"K1r != K1f at {n} x 576")
        reps = 200 if n <= 10_000 else 10
        runs = {
            "column": (lambda: keccak_cuda.absorb_ragged(
                flat, offsets, lengths, outs["column"], mode="column"), "ragged"),
            "row": (lambda: keccak_cuda.absorb_ragged(
                flat, offsets, lengths, outs["row"], mode="row"), "ragged"),
            "k1f": (lambda: keccak_cuda.absorb_fixed(data, fixed), "fixed"),
        }
        times = {m: [] for m in runs}
        for rnd in range(3):
            for m in list(runs)[rnd:] + list(runs)[:rnd]:
                fn, match = runs[m]
                times[m].append(kernel_us(torch, fn, reps, match)[1])
        sweep[str(n)] = {m: sorted(t)[1] for m, t in times.items()}
        del data, flat, outs, fixed
    print(json.dumps({"part": "mode_sweep", "bytes": 576,
                      "us_median_of_3": sweep,
                      "column_max_rows": keccak_cuda.COLUMN_MAX_ROWS}),
          flush=True)

    # 4. paced like the sync loop ---------------------------------------
    sample = batches[: args.paced]
    paced = {}
    pause = args.pause_ms / 1e3

    def spin():
        end = time.perf_counter() + pause
        while time.perf_counter() < end:
            pass

    for label, wait in (("back_to_back", None), ("asleep", lambda: time.sleep(pause)),
                        ("spinning", spin)):
        spent = 0.0
        for b in sample:
            if wait:
                wait()
            t0 = time.perf_counter()
            keccak256_batch(b, dev)
            spent += time.perf_counter() - t0
        paced[f"{label}_us_per_call"] = spent / len(sample) * 1e6
    print(json.dumps({"part": "paced_replay", "batches": len(sample),
                      "pause_ms": args.pause_ms, **paced}), flush=True)

    # 5. column mode against rewrites of its own source -----------------
    libs = build_variants(build)
    rng = np.random.default_rng(args.seed)
    dev_index, stream = build.launch_args(torch.empty(1, device=dev))
    variants = {}
    for nb in (1, 4, 16):
        msgs = [rng.integers(0, 256, 136 * nb - 1 - int(rng.integers(0, 100)),
                             dtype=np.uint8).tobytes() for _ in range(100)]
        blob, offsets, lengths = keccak_torch.pack_ragged(msgs)
        blob_d = torch.from_numpy(blob).to(dev)
        header = torch.from_numpy(np.concatenate([offsets, lengths])).to(dev)
        want = keccak_torch.absorb_ragged(blob_d, torch.from_numpy(offsets),
                                          torch.from_numpy(lengths))
        out = torch.empty_like(want)

        def launch(lib):
            rc = lib.khipu_keccak256_ragged(
                blob_d.data_ptr(), header.data_ptr(), out.data_ptr(),
                len(msgs), 1, dev_index, stream)
            if rc:
                raise RuntimeError(f"cudaError {rc}")

        for name, (lib, _) in libs.items():
            launch(lib)
            torch.cuda.synchronize()
            if name in EXACT and not torch.equal(out, want):
                raise SystemExit(f"{name} != plain at 100 x {nb}")
        names = list(libs)
        times = {name: [] for name in names}
        for rnd in range(3):
            for name in names[rnd % len(names):] + names[: rnd % len(names)]:
                times[name].append(kernel_us(
                    torch, lambda lib=libs[name][0]: launch(lib), 200,
                    "ragged_columns")[1])
        for name, t in times.items():
            variants.setdefault(name, {})[f"100x{nb}_us"] = sorted(t)[1]
    for name, (_, log) in libs.items():
        found = ptxas_by_kernel([log])
        variants[name]["ptxas"] = found.get("keccak256_ragged_columns_kernel")
        variants[name]["exact"] = name in EXACT
    print(json.dumps({"part": "column_variants", "variants": variants,
                      "ptxas_k1r": ptxas_by_kernel([libs["k1r"][1]])}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
