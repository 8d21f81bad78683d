"""The controls of ``correct``, on the card at a cell's own size.

    python3 -m portbench.controls --workload <name> --seeds 1,2,3 \
        [--rounds 12 | --fault stale|half|altered|cached] [--seconds 2]

``--rounds``: the reference at that many Keccak-f rounds is put in the
program's place (12 is the control: the nearest weaker sponge, as
KangarooTwelve runs it); ``--fault``: the program runs with that fault
planted underneath its timed path (the seams its driver declares,
``faults.planted``). Each seed runs the cell's set-up, a short window
and its comparison in this one process, and prints one line: the seed,
``correct`` and every number compared beside its limit. The benchmark's
own runs never run a control.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

from portbench import faults
from portbench.run import Cell, load_manifest, run_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.controls")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--rounds", type=int)
    mode.add_argument("--fault", choices=faults.FAULTS)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("portbench.controls: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    manifest = load_manifest()
    cell = Cell(manifest, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = (faults.planted(args.fault, cell.traffic["driver"], cell.bench_dir)
               if args.fault else contextlib.nullcontext())
        with ctx:
            result, _ = run_cell(args.workload, seed, args.seconds, False,
                                 device, manifest=manifest,
                                 control_rounds=args.rounds,
                                 t0=time.perf_counter())
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "rounds": args.rounds, "fault": args.fault,
                          "correct": result["correct"],
                          "attempted": result["attempted"],
                          "failed": result["failed"],
                          "checks": result["checks"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
