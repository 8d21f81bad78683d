#!/usr/bin/env python3
"""Where K5's time goes: the kernel against variants of itself, on one
NVIDIA card.

    python3 scripts/k5_ablation.py [--seed N]

Builds ``khipu_tpu_torch/trie/csrc/fixpoint.cu`` as it is and, from the
same source with one part rewritten, these variants (each its own
library under ``khipu_tpu_torch/_build/k5_ablation/``):

  block_order   rows go to threads in block order and the grid has one
                128-thread block per 128 rows of the widest level, so a
                narrow level fills the first SMs only
  byte_stores   the gathered digests are stored as 32 single bytes
  no_gather     no child digest is fetched or stored (timing only)
  no_sponge     no permutation is run (timing only)
  no_work       neither: what is left is the level barriers and loads

It packs the same two shapes ``chip_smoke.py`` times (the 100,000-account
trie and a 16-block x 400-write window over it), checks that K5 and the
two exact variants give the digests and encodings of the plain version
(``fused.resolve_levels_plain``), then, after 1,000 launches to bring
the clocks up, times the variants in turns with CUDA events: ``--rounds``
rounds of 10 launches each, the order rotated every round (a launch on
its own output writes the same bytes); median, least and most of the
rounds' means. Prints the card line and one JSON line per shape. Exits
2 without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "khipu_tpu_torch", "trie", "csrc", "fixpoint.cu")

# variant -> (text in fixpoint.cu, its replacement) pairs
VARIANTS = {
    "k5": [],
    "block_order": [
        ("((long long)(threadIdx.x >> 5) * gridDim.x + blockIdx.x) * 32 + "
         "(threadIdx.x & 31);",
         "(long long)blockIdx.x * blockDim.x + threadIdx.x;"),
        ("long long grid = (widest + 31) / 32;",
         "long long grid = (widest + kThreads - 1) / kThreads;"),
    ],
    "byte_stores": [
        ("store_digest(enc + off[j], w[j]);",
         "for (int k = 0; k < 4; ++k) for (int b = 0; b < 8; ++b) "
         "enc[off[j] + 8 * k + b] = (uint8_t)(w[j][k] >> (8 * b));"),
    ],
    "no_gather": [
        ("t < t_end; t += kGather)", "t < t_end && false; t += kGather)"),
    ],
    "no_sponge": [
        ("        keccak_f1600(a);\n", "\n"),
    ],
    "no_work": [
        ("t < t_end; t += kGather)", "t < t_end && false; t += kGather)"),
        ("        keccak_f1600(a);\n", "\n"),
    ],
}
EXACT = ("k5", "block_order", "byte_stores")


def build_variants(build) -> dict:
    """Each variant's source written and compiled, all nvcc processes
    started together; returns name -> ctypes library."""
    out_dir = os.path.join(str(build.BUILD_DIR), "k5_ablation")
    os.makedirs(out_dir, exist_ok=True)
    text = open(SRC).read()
    header = os.path.join(ROOT, "khipu_tpu_torch", "ops", "csrc")
    procs = {}
    for name, subs in VARIANTS.items():
        src = text
        for old, new in subs:
            if old not in src:
                raise SystemExit(f"{name}: {old!r} is not in fixpoint.cu")
            src = src.replace(old, new)
        src = src.replace('#include "../../ops/csrc/keccak_f1600.cuh"',
                          '#include "keccak_f1600.cuh"')
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(src)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", header, "-shared",
             "-o", os.path.join(out_dir, f"{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
        lib.khipu_fixpoint_levels.argtypes = [p, i, p, p, i, p, p, p, p, p,
                                              ll, ll, i, p]
        lib.khipu_fixpoint_levels.restype = i
        libs[name] = (lib, [ln.strip() for ln in log.splitlines()
                            if "registers" in ln])
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--accounts", type=int, default=100_000)
    ap.add_argument("--blocks", type=int, default=16)
    ap.add_argument("--writes", type=int, default=400)
    ap.add_argument("--rounds", type=int, default=9)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("k5_ablation: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    from khipu_tpu_torch import workloads
    from khipu_tpu_torch.ops import build
    from khipu_tpu_torch.state import load_reference_nodes
    from khipu_tpu_torch.trie import bulk, deferred, fused

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip(), flush=True)
    libs = build_variants(build)
    dev = torch.device("cuda")

    pairs = workloads.fresh_state_pairs(args.accounts, device=dev)
    root, nodes = bulk.bulk_build(pairs, fused=True, device=dev)
    session = deferred.DeferredMPT(load_reference_nodes(nodes), root_hash=root)
    blocks = workloads.TransferBlocks(pairs, np.random.default_rng(args.seed))
    for _ in range(args.blocks):
        for k, v in blocks.next(args.writes, 20).items():
            session = session.put(k, v)
        session.force_hashed_root()
    shapes = (
        ("bulk_100k", bulk.placeholder_dag(bulk.build_levels(pairs)[1])[0]),
        ("window_16x400", deferred.resolution_inputs(session)[0]),
    )
    empty = torch.zeros((0, 32), dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for shape, resolve in shapes:
        classes, _, total, plan = fused.pack(
            resolve, deferred._PLACEHOLDER_PREFIX, dev)
        raw = [c.enc.clone() for c in classes]
        want_g = fused.resolve_levels_plain(classes, total, empty, plan)
        want_enc = [c.enc for c in classes]
        launches = {}
        for name, (lib, regs) in libs.items():
            encs = [r.clone() for r in raw]
            table = torch.tensor(
                [e.data_ptr() for e in encs] + [c.base for c in classes]
                + [total] + [c.nb for c in classes], dtype=torch.int64,
            ).to(dev)
            digests = torch.empty((total, 32), dtype=torch.uint8, device=dev)

            def launch(lib=lib, name=name, table=table, digests=digests):
                rc = lib.khipu_fixpoint_levels(
                    table.data_ptr(), len(classes), plan.d_order.data_ptr(),
                    plan.d_level_ptr.data_ptr(), plan.nlevels,
                    plan.d_tptr.data_ptr(), plan.d_toff.data_ptr(),
                    plan.d_tchild.data_ptr(), digests.data_ptr(),
                    empty.data_ptr(), total, plan.widest, 0, stream)
                if rc:
                    raise RuntimeError(f"{name}: cudaError {rc}")

            launch()
            torch.cuda.synchronize()
            exact = torch.equal(digests, want_g) and all(
                torch.equal(a, b) for a, b in zip(encs, want_enc))
            if name in EXACT and not exact:
                raise SystemExit(f"{name} != plain at the {shape} shape")
            launches[name] = (launch, exact, regs[-1] if regs else None,
                              encs, table, digests)
        # warm the clocks, then time the variants in turns, the order
        # rotated each round, so drift lands on every variant alike
        for _ in range(1000):
            launches["k5"][0]()
        names = list(launches)
        times = {name: [] for name in names}
        for rnd in range(args.rounds):
            for name in names[rnd % len(names):] + names[: rnd % len(names)]:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(10):
                    launches[name][0]()
                end.record()
                end.synchronize()
                times[name].append(start.elapsed_time(end) / 10)
        out = {name: {"ms_median": sorted(t)[len(t) // 2], "ms_min": min(t),
                      "ms_max": max(t), "exact": launches[name][1],
                      "ptxas": launches[name][2]}
               for name, t in times.items()}
        print(json.dumps({
            "shape": shape, "levels": plan.nlevels, "rows": total,
            "triples": plan.ntriples,
            "level_widths": np.diff(plan.level_ptr).tolist(),
            "variants": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
