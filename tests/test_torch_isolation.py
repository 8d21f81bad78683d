"""The port stands alone: importing every khipu_tpu_torch module (the
consensus, chaos, reorg, pool and miner modules among them, and the
serving plane and node front: jsonrpc/, serving/, service_board,
__main__) loads neither JAX, nor the khipu_tpu reference package, nor
gRPC, and an entry point that is asked for the card where there is none
raises instead of running on the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from khipu_tpu_torch import workloads
from khipu_tpu_torch.config import SyncConfig
from khipu_tpu_torch.domain.blockchain import Blockchain, GenesisSpec
from khipu_tpu_torch.domain.transaction import SignedTransaction
from khipu_tpu_torch.ops import build, keccak_cuda
from khipu_tpu_torch.ops.keccak import (
    keccak256_batch,
    keccak256_device_fixed,
    keccak256_fixed,
)
from khipu_tpu_torch.ledger.window import WindowCommitter
from khipu_tpu_torch.storage import mirror_cuda
from khipu_tpu_torch.storage.datasource import MemoryKeyValueDataSource
from khipu_tpu_torch.storage.device_mirror import DeviceNodeMirror
from khipu_tpu_torch.storage.storages import Storages
from khipu_tpu_torch.sync.fast_sync import FastSyncStateStorage, StateSyncer
from khipu_tpu_torch.sync import adaptive
from khipu_tpu_torch.sync.adaptive import AdaptiveCommitController, probe_backend
from khipu_tpu_torch.sync.prefetch import recover_block_senders
from khipu_tpu_torch.sync.fast_sync_service import FastSyncService
from khipu_tpu_torch.sync.regular_sync import RegularSyncService
from khipu_tpu_torch.sync.reorg import ReorgManager
from khipu_tpu_torch.sync.replay import ReplayDriver
from khipu_tpu_torch.trie import bulk, deferred, fixpoint_cuda, fused
from khipu_tpu_torch.trie.mpt import EMPTY_TRIE_HASH, MerklePatriciaTrie
from khipu_tpu_torch.state import load_reference_nodes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import khipu_tpu_torch
names = ["khipu_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(khipu_tpu_torch.__path__, "khipu_tpu_torch.")
]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "grpc" or m.startswith("grpc.")
             or m == "khipu_tpu" or m.startswith("khipu_tpu."))
want = {"khipu_tpu_torch.consensus", "khipu_tpu_torch.consensus.ethash",
        "khipu_tpu_torch.chaos", "khipu_tpu_torch.chaos.plan",
        "khipu_tpu_torch.chaos.scenario", "khipu_tpu_torch.chaos.invariants",
        "khipu_tpu_torch.sync.reorg", "khipu_tpu_torch.txpool",
        "khipu_tpu_torch.mining", "khipu_tpu_torch.storage.segment",
        "khipu_tpu_torch.storage.kesque", "khipu_tpu_torch.storage.known_nodes",
        "khipu_tpu_torch.storage.remote", "khipu_tpu_torch.network.peer",
        "khipu_tpu_torch.network.rlpx", "khipu_tpu_torch.network.discovery",
        "khipu_tpu_torch.sync.regular_sync",
        "khipu_tpu_torch.sync.fast_sync_service", "khipu_tpu_torch.keystore",
        "khipu_tpu_torch.native.aes", "khipu_tpu_torch.base.aes",
        "khipu_tpu_torch.ledger.simulate", "khipu_tpu_torch.jsonrpc",
        "khipu_tpu_torch.jsonrpc.filters",
        "khipu_tpu_torch.jsonrpc.eth_service",
        "khipu_tpu_torch.jsonrpc.personal_service",
        "khipu_tpu_torch.jsonrpc.server", "khipu_tpu_torch.serving",
        "khipu_tpu_torch.serving.readview", "khipu_tpu_torch.serving.slo",
        "khipu_tpu_torch.serving.admission",
        "khipu_tpu_torch.serving.loadgen", "khipu_tpu_torch.serving.router",
        "khipu_tpu_torch.serving.replica", "khipu_tpu_torch.serving.fleet",
        "khipu_tpu_torch.observability.telemetry",
        "khipu_tpu_torch.service_board", "khipu_tpu_torch.__main__"}
print(len(names), sorted(want - set(names)) + bad)
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 20
    assert bad == "[]"


def test_no_module_names_the_kesque_engine_as_missing():
    """The Kesque engine is ported: no source of the port says it is not
    (the ``ROADMAP A7`` placeholders and their error are gone)."""
    root = os.path.join(REPO, "khipu_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(dirpath, f)).read()
                assert "ROADMAP A7" not in text, f
                assert "kesque' is not ported" not in text, f


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _chain():
    return Blockchain(Storages(), workloads.replay_config())


def _signed_tx():
    from khipu_tpu_torch.domain.transaction import (
        Transaction,
        sign_transaction,
    )

    stx = sign_transaction(Transaction(0, 1, 21000, b"b" * 20, 1),
                           b"\x01" * 32, chain_id=1)
    return SignedTransaction.decode(stx.encode())  # no cached sender


def _service_board():
    from khipu_tpu_torch.service_board import ServiceBoard

    return ServiceBoard(workloads.replay_config())


def _replica():
    from khipu_tpu_torch.serving.replica import PrimaryFeed, ReplicaDriver

    return ReplicaDriver("r", PrimaryFeed(_chain()), workloads.replay_config(),
                         GenesisSpec(alloc={b"a" * 20: 1}))


def _session():
    d = deferred.DeferredMPT(load_reference_nodes({}))
    for i in range(4):
        d = d.put(bytes([i]) * 32, b"v" * 40)
    return d


@pytest.mark.parametrize("call", [
    lambda: keccak256_batch([b"x"]),
    lambda: keccak256_batch([b"x"], device="cuda"),
    lambda: keccak256_fixed(np.zeros((2, 20), np.uint8)),
    lambda: bulk.device_hasher([b"x"]),
    lambda: bulk.bulk_build([(b"k" * 32, b"v" * 40)], fused=True),
    lambda: bulk.bulk_build([(b"k" * 32, b"v" * 40)]),
    lambda: deferred.finalize(_session(), fused=True),
    lambda: deferred.finalize(_session()),
    lambda: _session().commit(),
    lambda: deferred.batch_commit(
        MerklePatriciaTrie(load_reference_nodes({})), [(b"k" * 32, b"v" * 40)]
    ),
    lambda: fused.fused_submit({b"p" * 32: b"e" * 40}, {}, b"p"),
    lambda: keccak256_device_fixed(np.zeros((2, 20), np.uint8)),
    lambda: keccak256_device_fixed(np.zeros((2, 5), np.uint32)),
    lambda: DeviceNodeMirror(),
    lambda: StateSyncer(
        Storages(), FastSyncStateStorage(MemoryKeyValueDataSource()),
        lambda want: {},
    ).start(b"\x00" * 32),
    lambda: ReplayDriver(_chain(), workloads.replay_config()),
    lambda: ReplayDriver(_chain(), workloads.replay_config(),
                         device_commit=True),
    lambda: _chain().load_genesis(GenesisSpec(alloc={b"a" * 20: 1}),
                                  on_device=True),
    lambda: recover_block_senders([_signed_tx()], batch_hash=True),
    lambda: ReplayDriver(_chain(), workloads.replay_config(
        commit_window_blocks=8), device_commit=True),
    lambda: WindowCommitter(Storages(), EMPTY_TRIE_HASH, fused=True),
    lambda: AdaptiveCommitController(SyncConfig()),
    lambda: probe_backend(),
    lambda: fused.fused_exec_validate([0], [0], [1], [1]),
    lambda: adaptive.exec_device_allowed(SyncConfig(exec_device=True)),
    lambda: ReorgManager(_chain(), workloads.replay_config()),
    lambda: RegularSyncService(_chain(), workloads.replay_config(), None),
    lambda: FastSyncService(_chain(), workloads.replay_config(), None),
    lambda: _service_board(),
    lambda: _replica(),
], ids=["batch", "batch-cuda", "fixed", "device_hasher", "bulk_fused",
        "bulk_levels", "finalize_fused", "finalize_levels", "commit",
        "batch_commit", "fused_submit", "device_fixed", "device_fixed_words",
        "mirror", "state_syncer", "replay_driver", "replay_device_commit",
        "genesis_on_device", "sender_batch_hash", "replay_windowed",
        "window_committer_fused", "adaptive_controller", "adaptive_probe",
        "exec_validate", "exec_device_allowed", "reorg_manager",
        "regular_sync", "fast_sync_service", "service_board", "replica"])
def test_entry_points_raise_without_card(no_card, call):
    with pytest.raises(RuntimeError, match="is_available"):
        call()


def test_windowed_replay_on_cpu_touches_no_cuda(monkeypatch):
    """A windowed replay on ``device="cpu"`` with the adaptive controller
    on: the probe reports ``device_ok=False`` without timing anything,
    the controller holds host mode, and no CUDA call is made."""

    def no_cuda(*a, **kw):
        raise AssertionError("CUDA touched on a CPU replay")

    for name in ("is_available", "synchronize", "Event", "current_device",
                 "current_stream", "device"):
        monkeypatch.setattr(torch.cuda, name, no_cuda)
    monkeypatch.setattr(adaptive, "_PROBE_CACHE", {})
    probe = probe_backend(device="cpu")
    assert (probe.platform, probe.device_ok) == ("cpu", False)
    cfg = workloads.replay_config(commit_window_blocks=2,
                                  adaptive_commit=True)
    assert cfg.sync.adaptive_probe
    _, spec, blocks = workloads.transfer_chain(cfg, 3, 1, senders=2)
    chain = Blockchain(Storages(), cfg)
    chain.load_genesis(spec)
    driver = ReplayDriver(chain, cfg, device_commit=True, device="cpu")
    assert driver.replay(blocks).blocks == 3
    assert driver.adaptive.mode() == "host" and driver.adaptive.flips == 1
    assert driver.adaptive.probe is probe


def test_kernel_wrappers_refuse_cpu_tensors():
    rows = torch.zeros((2, 136), dtype=torch.uint8)
    with pytest.raises(ValueError, match="on the card"):
        keccak_cuda.absorb_ragged(rows.view(-1), np.zeros(2, np.int32),
                                  np.full(2, 136, np.int32))
    i32 = torch.zeros(2, dtype=torch.int32)
    d = torch.zeros((2, 32), dtype=torch.uint8)
    with pytest.raises(ValueError):
        fixpoint_cuda.resolve_levels([rows], [0], d, d, i32, i32,
                                     torch.zeros(3, dtype=torch.int32),
                                     i32, i32, 2)
    with pytest.raises(ValueError):
        keccak_cuda.absorb_fixed(torch.zeros((2, 20), dtype=torch.uint8))
    planes = torch.zeros((34, 4), dtype=torch.int32)
    out = torch.zeros((8, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        mirror_cuda.hash_planes(planes, 1, 34, out)
    with pytest.raises(ValueError):
        mirror_cuda.verify_planes(planes, out, 1, 34)


def test_k5_wrapper_refuses_cpu_tensors():
    """A packed window on the CPU: K5's wrapper raises on its tensors and
    launches nothing, while the dispatcher takes the plain version."""
    to_resolve = {bytes([i]) * 32: bytes([i]) * 40 for i in range(3)}
    classes, _, total, plan = fused.pack(to_resolve, b"\xfe\xc0", "cpu")
    ext = torch.zeros((0, 32), dtype=torch.uint8)
    digests = torch.zeros((total, 32), dtype=torch.uint8)
    before = fixpoint_cuda.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        fixpoint_cuda.resolve_levels(
            [c.enc for c in classes], [c.base for c in classes], digests,
            ext, plan.d_order, plan.d_level_ptr, plan.d_tptr, plan.d_toff,
            plan.d_tchild, plan.widest,
        )
    got = fused.resolve_levels(classes, total, ext, plan)
    assert fixpoint_cuda.LAUNCHES == before
    assert got.device.type == "cpu" and got.shape == (total, 32)


def test_build_sees_both_kernel_sources():
    assert sorted(p.name for p in build.sources()) == [
        "exec_validate.cu", "fixpoint.cu", "keccak.cu", "mirror.cu"
    ]
    assert [p.name for p in build.headers()] == ["keccak_f1600.cuh"]
    assert build.BUILD_DIR.name == "_build"


def test_build_key_covers_shared_headers(monkeypatch):
    """The shared permutation header is part of the library's name, so
    an edit to it cannot reuse a stale build."""
    srcs = build.sources()
    key = build._key(srcs)
    monkeypatch.setattr(build, "headers", lambda: [])
    assert build._key(srcs) != key


def _ragged_call(blob_bytes=64, offsets=(0, 8), lengths=(5, 40), **kw):
    return lambda: keccak_cuda.absorb_ragged(
        torch.zeros(blob_bytes, dtype=torch.uint8),
        np.asarray(offsets, np.int32), np.asarray(lengths, np.int32), **kw)


@pytest.mark.parametrize("call,match", [
    (_ragged_call(offsets=(0, 12)), "aligned"),
    (_ragged_call(offsets=(0, 32)), "bounds"),  # 32 + 40 > 64
    (_ragged_call(lengths=(5, 57)), "bounds"),  # rounded up to 64
    (_ragged_call(offsets=(-8, 8)), "negative"),
    (_ragged_call(lengths=(5, -1)), "negative"),
    (_ragged_call(lengths=(5,)), "one length"),
    (lambda: keccak_cuda.absorb_ragged(
        torch.zeros(64, dtype=torch.uint8), np.zeros(2, np.int64),
        np.zeros(2, np.int32)), "int32"),
    (lambda: keccak_cuda.absorb_ragged(
        torch.zeros((8, 8), dtype=torch.uint8), np.zeros(2, np.int32),
        np.zeros(2, np.int32)), "u8"),
    (_ragged_call(), "on the card"),
], ids=["misaligned", "offset_out_of_bounds", "length_out_of_bounds",
        "negative_offset", "negative_length", "header_shapes",
        "header_dtype", "blob_shape", "cpu_blob"])
def test_ragged_wrapper_checks_before_launch(call, match):
    """K1r's wrapper checks the header on the host, then refuses a blob
    that is not on the card; nothing is launched."""
    before = keccak_cuda.RAGGED_LAUNCHES
    with pytest.raises(ValueError, match=match):
        call()
    assert keccak_cuda.RAGGED_LAUNCHES == before


def test_native_sources_include_nothing_of_the_reference():
    """The copied C++ and C (and the CUDA sources) include only system
    headers and headers beside them in the port."""
    import re

    srcs = sorted(build.PKG.glob("*/csrc/*.c*")) + sorted(
        build.PKG.glob("*/csrc_ext/*.c"))
    assert {p.name for p in srcs} >= {"keccak.cc", "secp256k1.cc",
                                      "evm.cc", "store.cc", "rlp_ext.c",
                                      "keccak.cu", "keccak_f1600.cuh"}
    for src in srcs:
        for inc in re.findall(r'#include\s*([<"][^>"]+[>"])', src.read_text()):
            if inc.startswith('"'):
                local = (src.parent / inc[1:-1]).resolve()
                assert local.exists() and build.PKG in local.parents, (src, inc)
            else:
                assert "khipu" not in inc, (src, inc)
        assert "khipu_tpu/" not in src.read_text().replace(
            "khipu_tpu_torch/", ""), src


def test_port_never_imports_grpc():
    """The machine with the card has no gRPC package: no module of the
    port imports it (the bridge waits for ROADMAP A11)."""
    import re

    root = os.path.join(REPO, "khipu_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(dirpath, f)).read()
                assert not re.search(
                    r"^\s*(from|import)\s+grpc\b", text, re.M), f


def test_port_never_imports_cryptography():
    """One AES path: the host library's. No module of the port imports
    the ``cryptography`` package, not even as a fallback."""
    import re

    root = os.path.join(REPO, "khipu_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(dirpath, f)).read()
                assert not re.search(
                    r"^\s*(from|import)\s+cryptography\b", text, re.M), f


def test_ragged_mode_switch():
    assert keccak_cuda.ragged_mode(100) == "column"
    assert keccak_cuda.ragged_mode(keccak_cuda.COLUMN_MAX_ROWS) == "column"
    assert keccak_cuda.ragged_mode(keccak_cuda.COLUMN_MAX_ROWS + 1) == "row"


def test_k1_is_retired():
    """K1r took K1's place on every path: no padded-row kernel is left to
    launch or bind."""
    assert not hasattr(keccak_cuda, "absorb_padded")
    assert not hasattr(keccak_cuda, "LAUNCHES")
    src = (build.PKG / "ops" / "csrc" / "keccak.cu").read_text()
    assert "khipu_keccak256_rows" not in src
    assert "khipu_keccak256_ragged" in src


@pytest.mark.parametrize("script", [
    "chip_smoke.py", "scripts/k1_ablation.py", "scripts/k5_ablation.py",
    "scripts/torch_profile.py",
])
def test_scripts_import_no_jax_and_no_reference(script):
    """The chip scripts import nothing of JAX or of khipu_tpu (read from
    their syntax trees: importing them needs no card either way)."""
    import ast

    tree = ast.parse(open(os.path.join(REPO, script)).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    roots = {n.split(".")[0] for n in names}
    assert "jax" not in roots and "khipu_tpu" not in roots
    assert "khipu_tpu_torch" in roots
