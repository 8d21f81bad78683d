"""The multi-card dry run: every sharded path, held against the one-card
path and the scalar oracle.

    torchrun --standalone --nproc-per-node=<cards> -m khipu_tpu_torch.parallel \
        [--device cpu] [--backend gloo --devices cuda:0,cuda:0] [--seed N] \
        [--rows N] [--length L] [--accounts A] [--blocks B] [--writes W]

The counterpart of ``__graft_entry__.py::dryrun_multichip``, one process
a rank. Steps, each on every rank, each printed by rank 0 as one JSON
line with every rank's launch counts, collectives and result digests:

  commit           the reference's commit step: 4 x world rows of 140 B
                   hashed sharded (K1f), the table all_gathered, the
                   mismatches all_reduced; against the scalar oracle
  snapshot_verify  ``--rows`` x ``--length`` rows made on the device;
                   ``keccak256_fixed_sharded`` and
                   ``hash_level_all_gather`` equal to the one-card K1f,
                   ``snapshot_verify_sharded`` 0, and exactly 1 with one
                   byte flipped (BASELINE #5)
  bulk_build       ``bulk_build(pairs, hasher=sharded_hasher(mesh))`` over
                   ``--accounts`` fresh accounts: root and node dict equal
                   to the one-card ``bulk_build(fused=True)`` (BASELINE #3)
  fused_*          ``fused_resolve_sharded`` equal to the one-card
                   ``fused_resolve`` on the dry run's 48-put session, on
                   the bulk build's placeholder DAG and on a window of
                   ``--blocks`` x ``--writes`` account writes over that
                   state in one deferred session

The card's defaults are BASELINE #5's full width (10,485,760 x 576 B)
and #3's 100,000 accounts; ``--device cpu`` (gloo) defaults to small
sizes. Any disagreement raises on every rank (each rank checks the same
gathered records), so the command exits non-zero.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

CHUNK_ROWS = 1 << 20  # rows made from one seed: a run's first chunks
#                      equal a larger run's
NEW_ACCOUNTS = 20  # a window block's fresh accounts, as chip_smoke's window


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()[:16]


def _sha_nodes(nodes) -> str:
    h = hashlib.sha256()
    for k in sorted(nodes):
        h.update(k)
        h.update(nodes[k])
    return h.hexdigest()[:16]


def _sha_mapping(mapping) -> str:
    """Of the digests in placeholder-counter order: each process draws
    its own placeholder prefix, the counters are the session's."""
    return _sha(b"".join(mapping[k] for k in sorted(
        mapping, key=lambda ph: ph[18:])))


def _counts():
    from khipu_tpu_torch.ops import keccak_cuda
    from khipu_tpu_torch.trie import fixpoint_cuda

    return {"k1f": keccak_cuda.FIXED_LAUNCHES,
            "k1r": keccak_cuda.RAGGED_LAUNCHES,
            "k5": fixpoint_cuda.LAUNCHES}


def _zero() -> None:
    from khipu_tpu_torch.ops import keccak_cuda
    from khipu_tpu_torch.trie import fixpoint_cuda

    keccak_cuda.FIXED_LAUNCHES = keccak_cuda.RAGGED_LAUNCHES = 0
    fixpoint_cuda.LAUNCHES = 0


class _Step:
    """Times one step (synchronised on the card) and records this rank's
    launches and collectives over it, and the seconds since the previous
    step ended (``setup_seconds``: making and checking inputs)."""

    last_end = time.perf_counter()

    def __init__(self, mesh, name: str):
        self.mesh, self.name = mesh, name

    def __enter__(self):
        self._sync()
        _zero()
        self.coll0 = dict(self.mesh.collectives)
        self.t0 = time.perf_counter()
        self.rec = {"step": self.name,
                    "setup_seconds": self.t0 - _Step.last_end}
        return self.rec

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            return False
        self._sync()
        _Step.last_end = time.perf_counter()
        self.rec["seconds"] = _Step.last_end - self.t0
        self.rec["launches"] = _counts()
        self.rec["collectives"] = {
            k: v - self.coll0.get(k, 0)
            for k, v in self.mesh.collectives.items()
            if v - self.coll0.get(k, 0)}
        return False

    def _sync(self):
        if self.mesh.device.type == "cuda":
            torch.cuda.synchronize(self.mesh.device)


def _rows(n: int, length: int, seed: int, dev) -> torch.Tensor:
    """u8[n, length] on ``dev``, made in chunks of ``CHUNK_ROWS`` rows,
    chunk c from seed ``(seed, c)``."""
    out = torch.empty((n, length), dtype=torch.uint8, device=dev)
    for c, lo in enumerate(range(0, n, CHUNK_ROWS)):
        hi = min(lo + CHUNK_ROWS, n)
        gen = torch.Generator(device=dev).manual_seed(seed * 65_537 + c)
        out[lo:hi] = torch.randint(0, 256, (hi - lo, length),
                                   dtype=torch.uint8, device=dev,
                                   generator=gen)
    return out


def steps(mesh, args) -> List[dict]:
    """Run every step on this rank; returns this rank's records."""
    from khipu_tpu_torch import workloads
    from khipu_tpu_torch.base.keccak import keccak256
    from khipu_tpu_torch.ops.keccak import keccak256_device_fixed
    from khipu_tpu_torch.parallel import (
        fused_resolve_sharded,
        hash_level_all_gather,
        sharded_hasher,
        snapshot_verify_sharded,
        keccak256_fixed_sharded,
    )
    from khipu_tpu_torch.state import load_reference_nodes
    from khipu_tpu_torch.storage.datasource import MemoryNodeDataSource
    from khipu_tpu_torch.trie import bulk, deferred, fused

    dev = mesh.device
    prefix = deferred._PLACEHOLDER_PREFIX
    out = []

    # the reference's commit step, on the reference's shapes
    rng = np.random.default_rng(42)
    n, length = 4 * mesh.size, 140
    nodes = rng.integers(0, 256, size=(n, length), dtype=np.uint8)
    keys = np.stack([np.frombuffer(keccak256(r.tobytes()), np.uint8)
                     for r in nodes])
    with _Step(mesh, "commit") as rec:
        table = hash_level_all_gather(nodes, mesh)
        bad = snapshot_verify_sharded(nodes, keys, mesh)
    rec.update(rows=n, length=length, mismatches=bad,
               equal_oracle=bool(np.array_equal(table, keys)),
               table_sha=_sha(table.tobytes()))
    out.append(rec)

    # BASELINE #5: the snapshot verify at full width
    data = _rows(args.rows, args.length, args.seed, dev)
    with _Step(mesh, "one_card_claims") as claim_rec:
        claims = keccak256_device_fixed(data, device=dev)
    sample = np.unique(np.linspace(0, args.rows - 1, 16).astype(np.int64))
    picked = data[sample.tolist()]
    # khipu-lint: ok KL001 the dry run's check of the one-card claims
    # against the scalar oracle on 16 sampled rows; not a path of the node
    truth, rows_h = claims.cpu().numpy(), picked.cpu().numpy()
    oracle = all(truth[i].tobytes() == keccak256(rows_h[j].tobytes())
                 for j, i in enumerate(sample))
    with _Step(mesh, "fixed_sharded") as rec:
        fixed = keccak256_fixed_sharded(data, mesh)
    rec.update(rows=args.rows, length=args.length,
               equal_one_card=bool(np.array_equal(fixed, truth)),
               one_card_equal_oracle=oracle,
               one_card_seconds=claim_rec["seconds"],
               table_sha=_sha(fixed.tobytes()),
               prefix_sha=_sha(fixed[:CHUNK_ROWS].tobytes()))
    out.append(rec)
    del fixed
    with _Step(mesh, "level_all_gather") as rec:
        level = hash_level_all_gather(data, mesh)
    rec.update(rows=args.rows, equal_one_card=bool(np.array_equal(level,
                                                                  truth)))
    out.append(rec)
    del level
    flip = args.rows * 2 // 3
    with _Step(mesh, "snapshot_verify") as rec:
        clean = snapshot_verify_sharded(data, claims, mesh)
        data[flip, args.length // 2] ^= 1
        flipped = snapshot_verify_sharded(data, claims, mesh)
        data[flip, args.length // 2] ^= 1
    rec.update(rows=args.rows, length=args.length, mismatches=clean,
               mismatches_one_flipped=flipped, flipped_row=flip)
    out.append(rec)
    del data, claims, truth

    # BASELINE #3: the bulk build with the sharded hasher
    pairs = bulk_pairs = workloads.fresh_state_pairs(args.accounts,
                                                     device=dev)
    calls = []
    hasher = sharded_hasher(mesh)

    def counting(msgs):
        calls.append(len(msgs))
        return hasher(msgs)

    with _Step(mesh, "bulk_build") as rec:
        root, bnodes = bulk.bulk_build(pairs, hasher=counting)
    one_root, one_nodes = bulk.bulk_build(pairs, fused=True, device=dev)
    rec.update(accounts=args.accounts, nodes=len(bnodes), root=root.hex(),
               hasher_calls=len(calls), k1r_shares=sum(
                   1 for c in calls if mesh.share(c)[1] > mesh.share(c)[0]),
               nodes_sha=_sha_nodes(bnodes),
               equal_one_card=root == one_root and bnodes == one_nodes)
    out.append(rec)

    # the sharded fixpoint against the one-card fixpoint
    def session48():
        d = deferred.DeferredMPT(MemoryNodeDataSource())
        for i in range(48):
            d = d.put(keccak256(i.to_bytes(4, "big")), b"v" * (20 + i % 37))
        return d

    if args.window_accounts != args.accounts:
        pairs = workloads.fresh_state_pairs(args.window_accounts, device=dev)
        one_root, one_nodes = bulk.bulk_build(pairs, fused=True, device=dev)
    window = deferred.DeferredMPT(load_reference_nodes(one_nodes),
                                  root_hash=one_root)
    writes = workloads.TransferBlocks(pairs, np.random.default_rng(args.seed))
    for _ in range(args.blocks):
        for k, v in writes.next(args.writes, NEW_ACCOUNTS).items():
            window = window.put(k, v)
        window.force_hashed_root()
    dags = [
        ("fused_session48", deferred.resolution_inputs(session48())[:2]),
        (f"fused_bulk_dag_{args.accounts}", (bulk.placeholder_dag(
            bulk.build_levels(bulk_pairs)[1])[0], {})),
        (f"fused_window_{args.blocks}x{args.writes}",
         deferred.resolution_inputs(window)[:2]),
    ]
    for name, (to_resolve, deps) in dags:
        stats = {}
        with _Step(mesh, name) as rec:
            got = fused_resolve_sharded(to_resolve, deps, prefix, mesh,
                                        stats_out=stats)
        want = fused.fused_resolve(to_resolve, deps, prefix, device=dev)
        rec.update(nodes=len(to_resolve), mapping_sha=_sha_mapping(got),
                   equal_one_card=got == want, **stats)
        out.append(rec)
    return out


def check_records(per_rank: List[List[dict]]) -> None:
    """Every rank's results equal, each equal to the one-card path and
    the oracle, and the launches and collectives as designed. Raises
    AssertionError; every rank runs it on the same gathered records."""
    def need(cond, what):
        if not cond:
            raise AssertionError(what)

    first = per_rank[0]
    for recs in per_rank:
        need([r["step"] for r in recs] == [r["step"] for r in first],
             "ranks ran different steps")
    keys = ("table_sha", "prefix_sha", "mismatches",
            "mismatches_one_flipped", "root", "nodes_sha", "mapping_sha",
            "equal_oracle", "equal_one_card", "one_card_equal_oracle")
    for i, rec in enumerate(first):
        name = rec["step"]
        for recs in per_rank[1:]:
            for k in keys:
                need(recs[i].get(k) == rec.get(k),
                     f"{name}: ranks disagree on {k}")
        for k in ("equal_oracle", "equal_one_card", "one_card_equal_oracle"):
            need(rec.get(k, True), f"{name}: {k} is False")
        coll = [recs[i]["collectives"] for recs in per_rank]
        if name == "commit":
            need(rec["mismatches"] == 0, "commit: mismatches on clean rows")
            need(all(c == {"all_gather": 1, "all_reduce": 1} for c in coll),
                 f"commit: collectives {coll}")
        elif name in ("fixed_sharded", "level_all_gather"):
            need(all(c == {"all_gather": 1} for c in coll),
                 f"{name}: collectives {coll}")
        elif name == "snapshot_verify":
            need(rec["mismatches"] == 0 and
                 rec["mismatches_one_flipped"] == 1,
                 f"snapshot_verify: {rec['mismatches']} clean, "
                 f"{rec['mismatches_one_flipped']} flipped")
            need(all(c == {"all_reduce": 2} for c in coll),
                 f"snapshot_verify: collectives {coll}")
        elif name == "bulk_build":
            need(all(c == {"all_gather": rec["hasher_calls"]} for c in coll),
                 f"bulk_build: collectives {coll}")
        elif name.startswith("fused_"):
            for r, recs in enumerate(per_rank):
                need(coll[r] == {"all_gather": recs[i]["levels"]},
                     f"{name}: rank {r} collectives {coll[r]}")
        _check_launches(name, [recs[i] for recs in per_rank], need)


def _check_launches(name, recs, need) -> None:
    """On the card, each rank launched what its shares call for."""
    if recs[0].get("device_type") != "cuda":
        return
    rows = recs[0].get("rows")
    size = len(recs)
    for r, rec in enumerate(recs):
        got = rec["launches"]
        per = -(-rows // size) if rows else 0
        share = rows and min(r * per, rows) < rows
        if name == "commit":
            want = {"k1f": 2 * bool(share), "k1r": 0, "k5": 0}
        elif name in ("fixed_sharded", "level_all_gather"):
            want = {"k1f": int(bool(share)), "k1r": 0, "k5": 0}
        elif name == "snapshot_verify":
            want = {"k1f": 2 * bool(share), "k1r": 0, "k5": 0}
        elif name == "bulk_build":
            want = {"k1f": 0, "k1r": rec["k1r_shares"], "k5": 0}
        else:
            want = {"k1f": 0, "k1r": 0, "k5": rec["k5_levels"]}
        need(got == want, f"{name}: rank {r} launched {got}, not {want}")


def parse_args(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(prog="python -m khipu_tpu_torch.parallel",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' for gloo ranks on the CPU; default the cards")
    ap.add_argument("--backend", default=None, help="nccl or gloo")
    ap.add_argument("--devices", default=None,
                    help="comma-separated device of each rank")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=None)
    ap.add_argument("--length", type=int, default=576)
    ap.add_argument("--accounts", type=int, default=None)
    ap.add_argument("--window-accounts", type=int, default=None,
                    help="accounts of the window's base state")
    ap.add_argument("--blocks", type=int, default=None)
    ap.add_argument("--writes", type=int, default=None)
    args = ap.parse_args(argv)
    cpu = args.device == "cpu"
    for name, card, host in (("rows", 10_485_760, 4096),
                             ("accounts", 100_000, 2_000),
                             ("window_accounts", 100_000, 2_000),
                             ("blocks", 16, 4), ("writes", 400, 100)):
        if getattr(args, name) is None:
            setattr(args, name, host if cpu else card)
    return args


def run(mesh, args) -> List[List[dict]]:
    """``steps`` on this rank, every rank's records gathered and checked
    here; rank 0 prints one JSON line a step."""
    mine = steps(mesh, args)
    for rec in mine:
        rec["device_type"] = mesh.device.type
    per_rank = [None] * mesh.size
    dist.all_gather_object(per_rank, mine)
    if mesh.rank == 0:
        for i, rec in enumerate(per_rank[0]):
            line = {k: v for k, v in rec.items()
                    if k not in ("launches", "collectives", "seconds")}
            line.update(world=mesh.size, backend=mesh.backend,
                        device=str(mesh.device),
                        seconds=[recs[i]["seconds"] for recs in per_rank],
                        launches=[recs[i]["launches"] for recs in per_rank],
                        collectives=[recs[i]["collectives"]
                                     for recs in per_rank])
            if mesh.device.type == "cuda":
                line["card"] = torch.cuda.get_device_name(mesh.device)
            print(json.dumps(line), flush=True)
    check_records(per_rank)
    return per_rank


def main(argv: Optional[List[str]] = None) -> int:
    from khipu_tpu_torch.parallel import device_mesh

    args = parse_args(argv)
    devices = args.devices.split(",") if args.devices else None
    mesh = device_mesh(device=args.device, backend=args.backend,
                       devices=devices)
    try:
        run(mesh, args)
        if mesh.rank == 0:
            print(json.dumps({"ok": True, "world": mesh.size,
                              "backend": mesh.backend}), flush=True)
    finally:
        mesh.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
