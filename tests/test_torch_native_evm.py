"""The port's native EVM core (native/csrc/evm.cc through evm/native_vm.py)
against the port's Python VM and the JAX package's native core.

Every case runs three ways on identical fresh worlds: the port's native
backend, the port's Python backend (``set_backend("python")``) and the
JAX package's native backend. They must agree on the ProgramResult
(status, gas, output, refund, logs), on the world's write log (accounts,
deltas, storage cells, codes, written sets, touched and selfdestructed
addresses), on its read sets, and on the resulting state root. Inputs
are seeded with numpy.
"""

import glob
import os
import threading
import time
import types

import numpy as np
import pytest

from khipu_tpu.config import fixture_config as jx_fixture_config
from khipu_tpu.domain.account import Account as JxAccount
from khipu_tpu.evm import dispatch as jx_dispatch
from khipu_tpu.evm import native_vm as jx_native_vm
from khipu_tpu.evm.config import for_block as jx_for_block
from khipu_tpu.evm.vm import BlockEnv as JxBlockEnv
from khipu_tpu.evm.vm import MessageEnv as JxMessageEnv
from khipu_tpu.ledger.world import BlockWorldState as JxWorld
from khipu_tpu.storage.datasource import MemoryNodeDataSource as JxMemNodes
from khipu_tpu.trie.mpt import MerklePatriciaTrie as JxMPT

from khipu_tpu_torch.config import fixture_config
from khipu_tpu_torch.domain.account import Account
from khipu_tpu_torch.evm import dataword as dw
from khipu_tpu_torch.evm import dispatch, native_vm
from khipu_tpu_torch.evm.config import for_block
from khipu_tpu_torch.evm.vm import BlockEnv, MessageEnv
from khipu_tpu_torch.ledger.world import BlockWorldState
from khipu_tpu_torch.storage.datasource import MemoryNodeDataSource
from khipu_tpu_torch.trie.mpt import MerklePatriciaTrie

RNG_SEED = 20261017
OWNER = b"\xcc" * 20
CALLER = b"\xdd" * 20
STATE_TESTS = os.path.join(os.path.dirname(__file__), "fixtures",
                           "state_tests")

PORT = types.SimpleNamespace(
    dispatch=dispatch, Account=Account, BlockEnv=BlockEnv,
    MessageEnv=MessageEnv, World=BlockWorldState, Nodes=MemoryNodeDataSource,
    MPT=MerklePatriciaTrie,
    configs={"all": for_block(1, fixture_config().blockchain),
             "frontier": for_block(
                 0, fixture_config(fork_block=10**9).blockchain)})
JAX = types.SimpleNamespace(
    dispatch=jx_dispatch, Account=JxAccount, BlockEnv=JxBlockEnv,
    MessageEnv=JxMessageEnv, World=JxWorld, Nodes=JxMemNodes, MPT=JxMPT,
    configs={"all": jx_for_block(1, jx_fixture_config().blockchain),
             "frontier": jx_for_block(
                 0, jx_fixture_config(fork_block=10**9).blockchain)})


# ------------------------------------------------------------- arithmetic

PY_OPS = {
    0: lambda a, b, c: (a + b) % dw.MOD,
    1: lambda a, b, c: (a - b) % dw.MOD,
    2: lambda a, b, c: (a * b) % dw.MOD,
    3: lambda a, b, c: a // b if b else 0,
    4: lambda a, b, c: a % b if b else 0,
    5: lambda a, b, c: dw.sdiv(a, b),
    6: lambda a, b, c: dw.smod(a, b),
    7: lambda a, b, c: pow(a, b, dw.MOD),
    8: lambda a, b, c: (a + b) % c if c else 0,
    9: lambda a, b, c: (a * b) % c if c else 0,
    10: lambda a, b, c: dw.signextend(a, b),
    11: lambda a, b, c: dw.byte_at(a, b),
    12: lambda a, b, c: (b << a) % dw.MOD if a < 256 else 0,
    13: lambda a, b, c: b >> a if a < 256 else 0,
    14: lambda a, b, c: dw.sar(a if a < 256 else 256, b),
}


def _interesting(rng) -> int:
    """A 256-bit word biased to the edges: random, short, near the top,
    a power of two, or a run of ones."""
    kind = int(rng.integers(6))
    if kind == 0:
        return int.from_bytes(rng.bytes(32), "big")
    if kind == 1:
        return int.from_bytes(rng.bytes(8), "big")
    if kind == 2:
        return int(rng.integers(256))
    if kind == 3:
        return dw.MASK - int(rng.integers(256))
    if kind == 4:
        return 1 << int(rng.integers(256))
    return (1 << int(rng.integers(1, 257))) - 1


def test_arith_matches_dataword_and_reference():
    rng = np.random.default_rng(RNG_SEED)
    for _ in range(3000):
        op = int(rng.integers(15))
        a, b, c = _interesting(rng), _interesting(rng), _interesting(rng)
        want = PY_OPS[op](a, b, c)
        got = native_vm.test_arith(op, a, b, c)
        assert got == want == jx_native_vm.test_arith(op, a, b, c), \
            f"op={op} a={a:x} b={b:x} c={c:x}"


def test_arith_edge_vectors():
    m, int_min = dw.MASK, 1 << 255
    cases = [
        (5, int_min, m, 0),      # INT_MIN / -1 wraps to INT_MIN
        (6, int_min, m, 0),
        (3, 7, 0, 0), (4, 7, 0, 0), (8, 5, 6, 0), (9, 5, 6, 0),
        (7, 3, m, 0), (9, m, m, m - 1), (8, m, m, 7),
        (10, 31, m, 0), (10, 500, 123, 0), (10, 0, 0xFF, 0),
        (11, 32, 77, 0), (11, 31, 0xAB, 0),
        (12, 255, 1, 0), (13, 256, m, 0), (14, 256, int_min, 0),
        (14, 1, int_min, 0), (14, 255, m, 0),
    ]
    for op, a, b, c in cases:
        want = PY_OPS[op](a, b, c)
        assert native_vm.test_arith(op, a, b, c) == want == \
            jx_native_vm.test_arith(op, a, b, c), f"op={op} a={a:x} b={b:x}"


# ------------------------------------------------------ message frames


def _deploy(pkg, world, addr, code=b"", balance=0, storage=()):
    """Settle an account into the world's tries and sources, so every
    backend reads the same committed base (get_original_storage too)."""
    world.save_account(addr, pkg.Account(nonce=0, balance=balance))
    if code:
        world.save_code(addr, code)
    for k, v in storage:
        world.save_storage(addr, k, v)
    world.persist(world.account_trie.source, world.storage_source,
                  world.evmcode_source)
    world.touched.clear()
    for cat in world.written:
        world.written[cat].clear()
    for cat in world.reads:
        world.reads[cat].clear()


def _summary(r, world, exact_errors: bool) -> dict:
    """What a frame did, in plain Python values (comparable across the
    two packages)."""
    err = r.error
    if err is not None and not exact_errors:
        err = err.split(":")[0]
    out = {"error": err, "revert": r.is_revert, "gas": r.gas_remaining,
           "output": bytes(r.output), "refund": r.refund,
           "logs": [(l.address, tuple(l.topics), l.data) for l in r.logs],
           "reads": {k: sorted(map(repr, v)) for k, v in world.reads.items()}}
    if r.ok:
        w = r.world
        out.update(
            accounts={a: None if acc is None else (
                acc.nonce, acc.balance, acc.storage_root, acc.code_hash)
                for a, acc in w.accounts.items()},
            deltas={a: (d.nonce, d.balance) for a, d in w.deltas.items()},
            # a storage entry with no cells is a read cache, not a write
            storage={a: dict(s.logs) for a, s in w.storages.items()
                     if s.logs},
            codes=dict(w.codes),
            written={k: sorted(map(repr, v)) for k, v in w.written.items()},
            touched=sorted(w.touched),
            selfdestructed=sorted(w.selfdestructed),
            root=w.root_hash)
    return out


def _run(pkg, backend, code, *, fork="all", gas=1_000_000, input_data=b"",
         value=0, setup=(), pre_transfer=False, exact_errors=False) -> dict:
    world = pkg.World(pkg.MPT(pkg.Nodes()), pkg.Nodes(), pkg.Nodes())
    for addr, kw in setup:
        _deploy(pkg, world, addr, **kw)
    _deploy(pkg, world, CALLER, balance=10**18)
    env = pkg.MessageEnv(owner=OWNER, caller=CALLER, origin=CALLER,
                         gas_price=1, value=value, input_data=input_data)
    block = pkg.BlockEnv(1, 1000, 131072, 8_000_000, b"\xaa" * 20)
    pkg.dispatch.set_backend(backend)
    try:
        r = pkg.dispatch.run_message_call(
            pkg.configs[fork], world, block, env, code, gas, OWNER,
            pre_transfer=pre_transfer)
    finally:
        pkg.dispatch.set_backend(None)
    return _summary(r, world, exact_errors)


def assert_three_way(code, **kw):
    """The port's native frame equals the JAX package's native frame
    (error strings too) and the port's Python frame (error kinds). The
    native core does not record a read that its own overlay answers
    (evm.cc's header), so its read sets are a subset of the Python VM's;
    everything else is equal."""
    before = dict(dispatch.VM_GAUGES)
    native = _run(PORT, "native", code, exact_errors=True, **kw)
    assert dispatch.VM_GAUGES["native_frames"] == before["native_frames"] + 1
    assert native == _run(JAX, "native", code, exact_errors=True, **kw)
    python = _run(PORT, "python", code, **kw)
    assert dispatch.VM_GAUGES["python_frames"] == before["python_frames"] + 1
    if native["error"] is not None:
        native["error"] = native["error"].split(":")[0]
    reads, py_reads = native.pop("reads"), python.pop("reads")
    for cat, got in reads.items():
        assert set(got) <= set(py_reads[cat]), cat
    assert native == python
    native["reads"] = reads
    return native


def asm(*parts) -> bytes:
    out = b""
    for p in parts:
        out += bytes([p]) if isinstance(p, int) else p
    return out


def push(v: int, width: int = None) -> bytes:
    b = v.to_bytes(width or max(1, (v.bit_length() + 7) // 8), "big")
    return bytes([0x60 + len(b) - 1]) + b


def _word(addr: bytes) -> int:
    return int.from_bytes(addr, "big")


RETURN_TOP = (push(0), 0x52, push(32), push(0), 0xF3)
COUNTER = asm(push(0), 0x54, push(1), 0x01, 0x80, push(0), 0x55, *RETURN_TOP)
RUNTIME = asm(push(7), *RETURN_TOP)
INIT = asm(push(_word(RUNTIME), len(RUNTIME)), push(0), 0x52,
           push(len(RUNTIME)), push(32 - len(RUNTIME)), 0xF3)
INIT_REVERTS = asm(push(0), push(0), 0xFD)
INIT_OOG = asm(push(1), push(1), 0x55)
FUNDED_OWNER = (OWNER, {"balance": 10**9})


def _store_init(init):
    return asm(push(_word(init), len(init)), push(0), 0x52)


MESSAGE_CASES = {
    "arith_mstore_return": dict(code=asm(push(2), push(3), 0x01,
                                         *RETURN_TOP)),
    "storage_write_read_refund": dict(code=asm(
        push(0xAB), push(1), 0x55, push(0), push(1), 0x55,
        push(7), push(2), 0x55, push(2), 0x54, *RETURN_TOP)),
    "storage_write_read_refund_frontier": dict(fork="frontier", code=asm(
        push(0xAB), push(1), 0x55, push(0), push(1), 0x55,
        push(7), push(2), 0x55, push(2), 0x54, *RETURN_TOP)),
    "sstore_with_prestate": dict(
        setup=[(OWNER, {"storage": [(1, 99), (2, 5)]})],
        code=asm(push(0), push(1), 0x55, push(99), push(1), 0x55,
                 push(7), push(2), 0x55, 0x00)),
    "sstore_with_prestate_frontier": dict(
        fork="frontier", setup=[(OWNER, {"storage": [(1, 99), (2, 5)]})],
        code=asm(push(0), push(1), 0x55, push(99), push(1), 0x55,
                 push(7), push(2), 0x55, 0x00)),
    "env_ops_and_sha3": dict(value=5, pre_transfer=True, code=asm(
        0x30, 0x31, 0x01, 0x32, 0x33, 0x01, 0x01, 0x34, 0x3A, 0x01, 0x01,
        0x41, 0x42, 0x43, 0x44, 0x45, 0x01, 0x01, 0x01, 0x01, 0x01,
        0x46, 0x47, 0x01, 0x01, push(0), 0x52,
        push(8), push(3), 0x20, *RETURN_TOP)),
    "calldata_code_copies": dict(input_data=bytes(range(1, 30)), code=asm(
        push(10), push(3), push(0), 0x37, 0x36, push(0), 0x52,
        push(20), push(5), push(64), 0x39, push(96), push(0), 0xF3)),
    "copy_src_offset_wraparound": dict(input_data=b"\xab" * 64, code=asm(
        push(4), push((1 << 64) - 1, 8), push(0), 0x37,
        push(2), push(1 << 200, 26), push(8), 0x39,
        push(32), push(0), 0xF3)),
    "extcodecopy_wraparound": dict(
        setup=[(b"\x29" * 20, {"code": b"\xcd" * 40})],
        code=asm(push(4), push((1 << 64) - 1, 8), push(0),
                 push(_word(b"\x29" * 20), 20), 0x3C, push(32), push(0),
                 0xF3)),
    "blockhash_oob": dict(code=asm(push(0), 0x40, push(500), 0x40, 0x01,
                                   *RETURN_TOP)),
    "exp_gas": dict(code=asm(push(3), push(2), 0x0A, push(0x1234, 2),
                             push(2), 0x0A, 0x01, *RETURN_TOP)),
    "exp_gas_frontier": dict(fork="frontier", code=asm(
        push(3), push(2), 0x0A, push(0x1234, 2), push(2), 0x0A, 0x01,
        *RETURN_TOP)),
    "oog_mid_program": dict(gas=5_000, code=asm(push(1), push(1), 0x55,
                                                0x00)),
    "invalid_jump": dict(code=asm(push(3), 0x56, 0x00)),
    "jump_loop": dict(code=asm(push(10), 0x5B, push(1), 0x90, 0x03, 0x80,
                               push(2), 0x57, 0x00)),
    "stack_underflow": dict(code=asm(0x01)),
    "dup_underflow": dict(code=asm(push(1), push(1), push(1), 0x84)),
    "revert_and_returndata": dict(
        setup=[(b"\x11" * 20, {"code": asm(push(0xEE), push(0), 0x52,
                                            push(32), push(0), 0xFD)})],
        code=asm(push(0), push(0), push(0), push(0), push(0),
                 push(_word(b"\x11" * 20), 20), push(50_000), 0xF1,
                 0x3D, push(0), 0x52, push(32), push(0), push(0), 0x3E,
                 0x00)),
    "memory_expansion_oog": dict(gas=100_000, code=asm(
        push(1), push(1 << 30, 5), 0x52, 0x00)),
    "msize_pc_gas": dict(code=asm(0x58, 0x59, 0x5A, 0x01, 0x01,
                                  *RETURN_TOP)),
    "logs": dict(code=asm(push(0xAA), push(0), 0x52, push(1), push(2),
                          push(16), push(8), 0xA2, push(3), push(0),
                          push(0), 0xA1, 0x00)),
    "shifts_and_extcode": dict(
        setup=[(b"\x22" * 20, {"code": asm(push(1), 0x00)})],
        code=asm(push(_word(b"\x22" * 20), 20), 0x3B,
                 push(4), push(1), push(0), push(_word(b"\x22" * 20), 20),
                 0x3C, push(_word(b"\x22" * 20), 20), 0x3F,
                 push(0xDEAD, 2), push(2), 0x1B, push(3), 0x1C, 0x01, 0x01,
                 *RETURN_TOP)),
}

CALL_CREATE_CASES = {
    "call_with_value_and_storage": dict(
        setup=[(b"\x33" * 20, {"code": COUNTER}), FUNDED_OWNER],
        code=asm(push(32), push(0), push(0), push(0), push(77),
                 push(_word(b"\x33" * 20), 20), push(100_000, 3), 0xF1,
                 push(32), push(0), push(0), push(0), push(0),
                 push(_word(b"\x33" * 20), 20), push(100_000, 3), 0xF1,
                 0x01, push(0), 0x52, push(64), push(0), 0xF3)),
    "callcode_delegatecall_static": dict(
        setup=[(b"\x44" * 20, {"code": COUNTER}), FUNDED_OWNER],
        code=asm(push(32), push(0), push(0), push(0), push(0),
                 push(_word(b"\x44" * 20), 20), push(100_000, 3), 0xF2,
                 push(32), push(32), push(0), push(0),
                 push(_word(b"\x44" * 20), 20), push(100_000, 3), 0xF4,
                 push(32), push(64), push(0), push(0),
                 push(_word(b"\x44" * 20), 20), push(100_000, 3), 0xFA,
                 0x01, 0x01, push(0), 0x52, push(96), push(0), 0xF3)),
    "call_to_missing_and_precompiles": dict(
        setup=[FUNDED_OWNER], input_data=b"\xde\xad\xbe\xef",
        code=asm(push(0), push(0), push(0), push(0), push(5),
                 push(_word(b"\x55" * 20), 20), push(100_000, 3), 0xF1,
                 push(4), push(0), 0x37,
                 push(32), push(0), push(4), push(0), push(0), push(4),
                 push(30_000, 2), 0xF1,
                 push(32), push(32), push(4), push(0), push(0), push(2),
                 push(30_000, 2), 0xF1,
                 0x01, 0x01, push(0), 0x52, push(64), push(0), 0xF3)),
    "depth_limited_recursion": dict(gas=300_000, code=asm(
        push(0), push(0), push(0), push(0), push(0), push(_word(OWNER), 20),
        0x5A, 0xF1, 0x00)),
    "create_and_create2": dict(setup=[FUNDED_OWNER], code=asm(
        _store_init(INIT),
        push(len(INIT)), push(32 - len(INIT)), push(3), 0xF0,
        push(0x5A17, 2), push(len(INIT)), push(32 - len(INIT)), push(0),
        0xF5, 0x01, *RETURN_TOP)),
    "create_init_reverts": dict(setup=[FUNDED_OWNER], code=asm(
        _store_init(INIT_REVERTS), push(len(INIT_REVERTS)),
        push(32 - len(INIT_REVERTS)), push(0), 0xF0, 0x15, *RETURN_TOP)),
    "create_init_oog": dict(setup=[FUNDED_OWNER], gas=80_000, code=asm(
        _store_init(INIT_OOG), push(len(INIT_OOG)),
        push(32 - len(INIT_OOG)), push(0), 0xF0, 0x15, *RETURN_TOP)),
    "selfdestruct": dict(setup=[(OWNER, {"balance": 12345})], code=asm(
        push(_word(b"\x66" * 20), 20), 0xFF)),
    "selfdestruct_frontier": dict(fork="frontier",
                                  setup=[(OWNER, {"balance": 12345})],
                                  code=asm(push(_word(b"\x66" * 20), 20),
                                           0xFF)),
    "selfdestruct_to_self": dict(setup=[(OWNER, {"balance": 999})],
                                 code=asm(push(_word(OWNER), 20), 0xFF)),
    "nested_revert_rolls_back_inner_sstore": dict(
        setup=[(b"\x77" * 20, {"code": asm(push(5), push(0), 0x55, push(0),
                                            push(0), 0xFD)}), FUNDED_OWNER],
        code=asm(push(1), push(1), 0x55, push(0), push(0), push(0),
                 push(0), push(0), push(_word(b"\x77" * 20), 20),
                 push(100_000, 3), 0xF1, *RETURN_TOP)),
}


@pytest.mark.parametrize("case", sorted(MESSAGE_CASES))
def test_message_frames_three_ways(case):
    assert_three_way(**MESSAGE_CASES[case])


@pytest.mark.parametrize("case", sorted(CALL_CREATE_CASES))
def test_call_create_frames_three_ways(case):
    got = assert_three_way(**CALL_CREATE_CASES[case])
    if case == "create_and_create2":
        assert got["codes"] and got["error"] is None


# ------------------------------------------------------- random programs

FUZZ_OPS = ([0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x0A,
             0x0B, 0x10, 0x11, 0x12, 0x13, 0x14, 0x15, 0x16, 0x17, 0x18,
             0x19, 0x1A, 0x1B, 0x1C, 0x1D, 0x20, 0x30, 0x31, 0x32, 0x33,
             0x34, 0x35, 0x36, 0x38, 0x3A, 0x3B, 0x41, 0x42, 0x43, 0x44,
             0x45, 0x46, 0x47, 0x50, 0x51, 0x52, 0x53, 0x54, 0x55, 0x56,
             0x57, 0x58, 0x59, 0x5A, 0x5B]
            + list(range(0x80, 0x90)) + list(range(0x90, 0xA0)))


def _random_program(rng) -> bytes:
    """PUSH-biased random programs: mostly valid-ish sequences of
    arithmetic, memory, storage and flow ops, now and then a stray
    byte."""
    out = b""
    for _ in range(int(rng.integers(5, 60))):
        r = rng.random()
        if r < 0.45:
            n = int(rng.integers(1, 5))
            out += bytes([0x60 + n - 1]) + rng.bytes(n)
        elif r < 0.92:
            out += bytes([FUZZ_OPS[int(rng.integers(len(FUZZ_OPS)))]])
        else:
            out += bytes([int(rng.integers(256))])
    out += bytes([(0x00, 0xF3, 0xFD)[int(rng.integers(3))]])
    if out[-1] in (0xF3, 0xFD):
        out = push(32) + push(0) + out
    return out


@pytest.mark.parametrize("chunk", range(4))
def test_random_programs_three_ways(chunk):
    rng = np.random.default_rng([RNG_SEED, chunk])
    for i in range(50):
        code = _random_program(rng)
        try:
            assert_three_way(code, gas=200_000)
        except AssertionError as e:
            raise AssertionError(f"program {chunk}/{i} {code.hex()}") from e


# ------------------------------------------------------ state tests


@pytest.mark.parametrize("path", sorted(glob.glob(
    os.path.join(STATE_TESTS, "*.json"))), ids=os.path.basename)
def test_statetest_under_native_backend(path):
    from khipu_tpu_torch.statetest import run_file

    before = dispatch.VM_GAUGES["python_frames"]
    dispatch.set_backend("native")
    try:
        results = run_file(path)
    finally:
        dispatch.set_backend(None)
    assert results
    for r in results:
        assert r.ok, f"{r.name}[{r.fork}]{r.index} {r.detail}"
    assert dispatch.VM_GAUGES["python_frames"] == before


# ----------------------------------------------------- the GIL


def test_native_interpretation_releases_the_gil():
    """While one long native frame interprets, a Python spinner thread
    keeps running: its progress stamps fall inside the frame's window,
    away from both ends (a frame that held the GIL would let it run only
    before and after). No rate is compared."""
    # a 400k-iteration MULMOD loop, no callbacks into Python
    code = asm(push(400_000, 3), 0x5B, push(3), 0x80, 0x80, 0x09, 0x50,
               push(1), 0x90, 0x03, 0x80, push(4), 0x57, 0x00)
    assert _run(PORT, "native", code, gas=50_000_000)["error"] is None
    stamps, stop = [], threading.Event()

    def spin():
        c = 0
        while not stop.is_set():
            c += 1
            if c % 256 == 0:
                stamps.append(time.perf_counter())

    th = threading.Thread(target=spin, daemon=True)
    th.start()
    try:
        t0 = time.perf_counter()
        r = _run(PORT, "native", code, gas=50_000_000)
        t1 = time.perf_counter()
    finally:
        stop.set()
        th.join(timeout=10)
    assert not th.is_alive()
    assert r["error"] is None
    margin = 0.2 * (t1 - t0)
    inside = [t for t in stamps if t0 + margin < t < t1 - margin]
    assert inside, (f"no spinner progress inside a {t1 - t0:.3f} s native "
                    "frame: the GIL was held")
