"""ctypes adapter for the native C++ EVM core (native/csrc/evm.cc).

The port's copy of ``khipu_tpu.evm.native_vm``. The core is part of the
host library (``native/build.py``); a failed build raises from the first
frame and nothing runs the Python VM in its place.

Split of responsibilities (see evm.cc header): C++ interprets the
bytecode (and its nested call/create frames) at native speed with the
GIL released; this module supplies

  * READ callbacks that land on BlockWorldState's *recording* accessors,
    so the optimistic-parallel merge algebra's read sets stay exact
    (ledger/world.py reads[] categories, BlockWorldState.scala:53-57
    role);
  * the PRECOMPILE callback (reusing evm/precompiles.py verbatim);
  * the OP-LOG replay: the C++ core emits the literal sequence of world
    mutations the Python VM would have made (reverted frames already
    truncated), and `_replay_oplog` applies them through the same
    BlockWorldState methods — so write-log / delta / race-set semantics
    are bit-identical to evm/vm.py.

The public entry points `native_execute_message` /
`native_create_contract` mirror vm.py's `_execute_message` /
`create_contract` signatures so evm/dispatch.py can switch backends
per call.
"""

from __future__ import annotations

import ctypes as C
import threading
from typing import List, Optional, Tuple

from khipu_tpu_torch.domain.receipt import TxLogEntry
from khipu_tpu_torch.evm.config import EvmConfig
from khipu_tpu_torch.evm.precompiles import get_precompile
from khipu_tpu_torch.evm.vm import ProgramResult
from khipu_tpu_torch.native.build import load_library

# must match enum Fee in evm.cc
FEE_FIELDS = (
    "G_zero", "G_base", "G_verylow", "G_low", "G_mid", "G_high",
    "G_balance", "G_sload", "G_jumpdest", "G_sset", "G_sreset", "R_sclear",
    "R_selfdestruct", "G_selfdestruct", "G_create", "G_codedeposit",
    "G_call", "G_callvalue", "G_callstipend", "G_newaccount", "G_exp",
    "G_expbyte", "G_memory", "G_txcreate", "G_txdatazero",
    "G_txdatanonzero", "G_transaction", "G_log", "G_logdata", "G_logtopic",
    "G_sha3", "G_sha3word", "G_copy", "G_blockhash", "G_extcode",
    "G_extcodehash", "G_sstore_noop", "G_sstore_init", "G_sstore_clean",
    "G_sstore_sentry",
)

# must match enum Err in evm.cc; values are vm.py-compatible error strings
_ERRORS = {
    2: "OutOfGas:native",
    3: "Stack:underflow",
    4: "Stack:overflow",
    5: "InvalidOpcode:native",
    6: "InvalidJump:native",
    7: "StaticViolation:native",
    8: "ReturnDataOutOfBounds:",
    9: "CreateCollision",
    10: "CodeSizeLimit",
    11: "OutOfGas:codeDeposit",
    12: "PrecompileFailure",
    13: "OutOfGas:precompile",
}

# a frame's gas must fit C++'s int64 comfortably
MAX_NATIVE_GAS = 1 << 62

_u8p = C.POINTER(C.c_uint8)

_CB_EXISTS = C.CFUNCTYPE(C.c_int, C.c_void_p, _u8p)
_CB_GET_ACCT = C.CFUNCTYPE(None, C.c_void_p, _u8p, _u8p)
_CB_GET_B32 = C.CFUNCTYPE(None, C.c_void_p, _u8p, _u8p)
_CB_GET_CODE = C.CFUNCTYPE(None, C.c_void_p, _u8p,
                           C.POINTER(C.c_char_p), C.POINTER(C.c_uint64))
_CB_STORAGE = C.CFUNCTYPE(None, C.c_void_p, _u8p, _u8p, _u8p)
_CB_BLOCKHASH = C.CFUNCTYPE(C.c_int, C.c_void_p, C.c_uint64, _u8p)
_CB_PRECOMPILE = C.CFUNCTYPE(
    C.c_int, C.c_void_p, C.c_uint32, _u8p, C.c_uint64, C.c_uint64,
    C.POINTER(C.c_char_p), C.POINTER(C.c_uint64), C.POINTER(C.c_uint64))


class _ResultC(C.Structure):
    _fields_ = [
        ("status", C.c_int32),
        ("_pad", C.c_int32),
        ("gas_remaining", C.c_uint64),
        ("refund", C.c_int64),
        ("output", C.c_void_p),
        ("output_len", C.c_uint64),
        ("oplog", C.c_void_p),
        ("oplog_len", C.c_uint64),
        ("owner_", C.c_void_p),
    ]


_lib = None
_lock = threading.Lock()

# live host contexts keyed by an integer handle (the void* the C side
# threads through every callback)
_hosts = {}
_next_handle = [1]


def _get_lib():
    """The host library with the EVM's entry points bound. Raises when
    the library does not build."""
    global _lib
    if _lib is not None:
        return _lib
    lib = load_library()
    with _lock:
        if _lib is None:
            u64, u32, vp = C.c_uint64, C.c_uint32, C.c_void_p
            pu64 = C.POINTER(C.c_uint64)
            pvp = C.POINTER(C.c_void_p)
            b = C.c_char_p  # bytes -> const uint8_t*
            lib.khipu_evm_call.restype = C.POINTER(_ResultC)
            lib.khipu_evm_call.argtypes = [
                pu64, pvp, vp, pu64, b,   # cfg, cbs, handle, blk_nums, blk_bytes
                b, b, b, b, b,            # owner, caller, origin, gas_price, value
                b, u64, u32, u32,         # input, input_len, depth, is_static
                b, u64, b, u64, u32,      # code, code_len, code_addr, gas, pre_transfer
            ]
            lib.khipu_evm_create.restype = C.POINTER(_ResultC)
            lib.khipu_evm_create.argtypes = [
                pu64, pvp, vp, pu64, b,   # cfg, cbs, handle, blk_nums, blk_bytes
                b, b, b, b, b,            # caller, origin, new_addr, gas_price, value
                b, u64, u32, u64,         # init_code, len, depth, gas
            ]
            lib.khipu_evm_free.restype = None
            lib.khipu_evm_free.argtypes = [C.POINTER(_ResultC)]
            lib.khipu_evm_test_arith.restype = None
            lib.khipu_evm_test_arith.argtypes = [C.c_int, b, b, b, b]
            _lib = lib
        return _lib


def available() -> bool:
    """True once the core is loaded; a failed build raises instead of
    answering False."""
    return _get_lib() is not None


def _addr(p) -> bytes:
    return C.string_at(p, 20)


class _Host:
    """Per-native-call host context: the world + config the callbacks
    close over, buffers kept alive for the duration, a captured
    exception (ctypes callbacks must not raise)."""

    __slots__ = ("world", "config", "keep", "exc")

    def __init__(self, world, config: EvmConfig):
        self.world = world
        self.config = config
        self.keep: List[bytes] = []
        self.exc: Optional[BaseException] = None


def _host(h) -> _Host:
    return _hosts[h]


# ------------------------------------------------------------- callbacks
# Module-level trampolines created ONCE (CFUNCTYPE construction is
# expensive); they dispatch on the handle.


@_CB_EXISTS
def _cb_exists(h, addr):
    host = _host(h)
    try:
        return 1 if host.world.account_exists(_addr(addr)) else 0
    # khipu-lint: ok KL002 ctypes callback boundary: raising here
    # would corrupt the native stack — the exception is captured to
    # host.exc and re-raised on the host side as soon as the native
    # call returns (_run)
    except BaseException as e:  # noqa: BLE001 — must not cross ctypes
        host.exc = host.exc or e
        return 0


@_CB_EXISTS
def _cb_is_dead(h, addr):
    host = _host(h)
    try:
        return 1 if host.world.is_dead(_addr(addr)) else 0
    # khipu-lint: ok KL002 captured to host.exc; re-raised after the
    # native call returns (see _cb_exists note)
    except BaseException as e:  # noqa: BLE001
        host.exc = host.exc or e
        return 1


@_CB_GET_ACCT
def _cb_get_account(h, addr, out):
    # out[73]: exists u8 | nonce u64 LE | balance 32 BE | code_hash 32
    host = _host(h)
    try:
        acc = host.world.get_account(_addr(addr))
        if acc is None:
            buf = b"\x00" * 73
        else:
            buf = (
                b"\x01"
                + int(acc.nonce).to_bytes(8, "little")
                + int(acc.balance).to_bytes(32, "big")
                + acc.code_hash
            )
        C.memmove(out, buf, 73)
    # khipu-lint: ok KL002 captured to host.exc; re-raised after the
    # native call returns (see _cb_exists note)
    except BaseException as e:  # noqa: BLE001
        host.exc = host.exc or e
        C.memmove(out, b"\x00" * 73, 73)


@_CB_GET_B32
def _cb_get_code_hash(h, addr, out):
    host = _host(h)
    try:
        C.memmove(out, host.world.get_code_hash(_addr(addr)), 32)
    # khipu-lint: ok KL002 captured to host.exc; re-raised after the
    # native call returns (see _cb_exists note)
    except BaseException as e:  # noqa: BLE001
        host.exc = host.exc or e
        C.memmove(out, b"\x00" * 32, 32)


@_CB_GET_CODE
def _cb_get_code(h, addr, out_ptr, out_len):
    host = _host(h)
    try:
        code = host.world.get_code(_addr(addr))
    # khipu-lint: ok KL002 captured to host.exc; re-raised after the
    # native call returns (see _cb_exists note)
    except BaseException as e:  # noqa: BLE001
        host.exc = host.exc or e
        code = b""
    host.keep.append(code)  # pointer must outlive the native call
    out_ptr[0] = code
    out_len[0] = len(code)


@_CB_STORAGE
def _cb_get_storage(h, addr, key, out):
    host = _host(h)
    try:
        v = host.world.get_storage(
            _addr(addr), int.from_bytes(C.string_at(key, 32), "big")
        )
        C.memmove(out, v.to_bytes(32, "big"), 32)
    # khipu-lint: ok KL002 captured to host.exc; re-raised after the
    # native call returns (see _cb_exists note)
    except BaseException as e:  # noqa: BLE001
        host.exc = host.exc or e
        C.memmove(out, b"\x00" * 32, 32)


@_CB_STORAGE
def _cb_get_original(h, addr, key, out):
    host = _host(h)
    try:
        v = host.world.get_original_storage(
            _addr(addr), int.from_bytes(C.string_at(key, 32), "big")
        )
        C.memmove(out, v.to_bytes(32, "big"), 32)
    # khipu-lint: ok KL002 captured to host.exc; re-raised after the
    # native call returns (see _cb_exists note)
    except BaseException as e:  # noqa: BLE001
        host.exc = host.exc or e
        C.memmove(out, b"\x00" * 32, 32)


@_CB_BLOCKHASH
def _cb_blockhash(h, number, out):
    host = _host(h)
    try:
        bh = host.world.get_block_hash(number)
    # khipu-lint: ok KL002 captured to host.exc; re-raised after the
    # native call returns (see _cb_exists note)
    except BaseException as e:  # noqa: BLE001
        host.exc = host.exc or e
        bh = None
    if bh is None:
        return 0
    C.memmove(out, bh, 32)
    return 1


@_CB_PRECOMPILE
def _cb_precompile(h, addr_low, inp, inlen, gas, out_ptr, out_len, gas_left):
    host = _host(h)
    try:
        address = int(addr_low).to_bytes(20, "big")
        pre = get_precompile(address, host.config)
        data = C.string_at(inp, inlen) if inlen else b""
        gas_fn, run_fn = pre
        cost = gas_fn(data, host.config)
        if cost > gas:
            gas_left[0] = 0
            return 1  # OutOfGas:precompile
        out = run_fn(data)
        if out is None:
            gas_left[0] = 0
            return 2  # PrecompileFailure
        host.keep.append(out)
        out_ptr[0] = out
        out_len[0] = len(out)
        gas_left[0] = gas - cost
        return 0
    # khipu-lint: ok KL002 captured to host.exc; re-raised after the
    # native call returns (see _cb_exists note)
    except BaseException as e:  # noqa: BLE001
        host.exc = host.exc or e
        gas_left[0] = 0
        return 2


_CBS = (C.c_void_p * 9)(
    C.cast(_cb_exists, C.c_void_p),
    C.cast(_cb_is_dead, C.c_void_p),
    C.cast(_cb_get_account, C.c_void_p),
    C.cast(_cb_get_code_hash, C.c_void_p),
    C.cast(_cb_get_code, C.c_void_p),
    C.cast(_cb_get_storage, C.c_void_p),
    C.cast(_cb_get_original, C.c_void_p),
    C.cast(_cb_blockhash, C.c_void_p),
    C.cast(_cb_precompile, C.c_void_p),
)

# ------------------------------------------------------------ config/env

_cfg_cache = {}


def _pack_config(config: EvmConfig):
    arr = _cfg_cache.get(config)
    if arr is None:
        vals = [
            config.chain_id,
            config.account_start_nonce,
            config.contract_start_nonce,
            config.max_code_size,
            int(config.homestead),
            int(config.eip150),
            int(config.eip161),
            int(config.eip170),
            int(config.byzantium),
            int(config.constantinople),
            int(config.istanbul),
            int(config.eip161_patch),
        ] + [getattr(config.fees, f) for f in FEE_FIELDS]
        arr = (C.c_uint64 * len(vals))(*vals)
        _cfg_cache[config] = arr
    return arr


def _pack_block(block):
    nums = (C.c_uint64 * 3)(
        block.number, block.timestamp, block.gas_limit
    )
    data = (
        int(block.difficulty).to_bytes(32, "big") + block.beneficiary
    )
    return nums, data


# -------------------------------------------------------------- replay


def _replay_oplog(world, buf: bytes) -> List[TxLogEntry]:
    """Apply the C++ core's write sequence through the world's own
    mutators (identical write-log/delta/race-set effects to the Python
    VM) and collect the log entries in emission order."""
    logs: List[TxLogEntry] = []
    mv = memoryview(buf)
    i = 0
    n = len(mv)
    while i < n:
        op = mv[i]
        i += 1
        if op == 1:  # ADD_BALANCE
            addr = bytes(mv[i : i + 20])
            negf = mv[i + 20]
            val = int.from_bytes(mv[i + 21 : i + 53], "big")
            world.add_balance(addr, -val if negf else val)
            i += 53
        elif op == 2:  # INC_NONCE
            addr = bytes(mv[i : i + 20])
            by = int.from_bytes(mv[i + 20 : i + 28], "little")
            world.increase_nonce(addr, by)
            i += 28
        elif op == 3:  # SAVE_STORAGE
            addr = bytes(mv[i : i + 20])
            key = int.from_bytes(mv[i + 20 : i + 52], "big")
            val = int.from_bytes(mv[i + 52 : i + 84], "big")
            world.save_storage(addr, key, val)
            i += 84
        elif op == 4:  # SAVE_CODE
            addr = bytes(mv[i : i + 20])
            ln = int.from_bytes(mv[i + 20 : i + 24], "little")
            world.save_code(addr, bytes(mv[i + 24 : i + 24 + ln]))
            i += 24 + ln
        elif op == 5:  # CREATE_ACCOUNT
            addr = bytes(mv[i : i + 20])
            nonce = int.from_bytes(mv[i + 20 : i + 28], "little")
            bal = int.from_bytes(mv[i + 28 : i + 60], "big")
            world.create_account(addr, nonce, bal)
            i += 60
        elif op == 6:  # INIT_IF_MISSING
            world.initialize_if_missing(bytes(mv[i : i + 20]))
            i += 20
        elif op == 7:  # TRANSFER
            frm = bytes(mv[i : i + 20])
            to = bytes(mv[i + 20 : i + 40])
            val = int.from_bytes(mv[i + 40 : i + 72], "big")
            world.transfer(frm, to, val)
            i += 72
        elif op == 8:  # TOUCH
            world.touch(bytes(mv[i : i + 20]))
            i += 20
        elif op == 9:  # SD_MARK
            world.selfdestructed.add(bytes(mv[i : i + 20]))
            i += 20
        elif op == 10:  # LOG
            addr = bytes(mv[i : i + 20])
            nt = mv[i + 20]
            i += 21
            topics = tuple(
                bytes(mv[i + 32 * t : i + 32 * (t + 1)]) for t in range(nt)
            )
            i += 32 * nt
            dlen = int.from_bytes(mv[i : i + 4], "little")
            logs.append(TxLogEntry(addr, topics, bytes(mv[i + 4 : i + 4 + dlen])))
            i += 4 + dlen
        else:
            raise ValueError(f"bad native oplog op {op} at {i - 1}")
    return logs


# -------------------------------------------------------------- entries


def _run(world, config, call_fn) -> Tuple[int, int, int, bytes, bytes]:
    """Register a host, run the native call, unpack + free the result."""
    host = _Host(world, config)
    with _lock:
        handle = _next_handle[0]
        _next_handle[0] += 1
        _hosts[handle] = host
    try:
        res = call_fn(C.c_void_p(handle))
        try:
            r = res.contents
            status = r.status
            gas_remaining = r.gas_remaining
            refund = r.refund
            output = C.string_at(r.output, r.output_len) if r.output_len else b""
            oplog = C.string_at(r.oplog, r.oplog_len) if r.oplog_len else b""
        finally:
            _get_lib().khipu_evm_free(res)
    finally:
        with _lock:
            del _hosts[handle]
    if host.exc is not None:
        raise host.exc
    return status, gas_remaining, refund, output, oplog


def _finish(world, status, gas_remaining, refund, output, oplog) -> ProgramResult:
    if status == 0:
        logs = _replay_oplog(world, oplog)
        return ProgramResult(
            gas_remaining=gas_remaining,
            world=world,
            output=output,
            logs=logs,
            refund=refund,
            deletes=set(world.selfdestructed),
        )
    if status == 1:  # REVERT — state discarded, gas + output returned
        return ProgramResult(
            gas_remaining=gas_remaining,
            world=world,
            output=output,
            is_revert=True,
        )
    return ProgramResult(0, world, error=_ERRORS.get(status, f"Native:{status}"))


def native_execute_message(
    config: EvmConfig,
    world,
    block,
    env,
    code: bytes,
    gas: int,
    code_address: bytes,
    pre_transfer: bool = False,
) -> ProgramResult:
    """vm._execute_message through the native core. With
    ``pre_transfer``, the tx-level value transfer (ledger.py:179-181) is
    emitted inside the native frame so it reverts with it."""
    lib = _get_lib()
    nums, blk_bytes = _pack_block(block)
    cfg = _pack_config(config)
    inp = env.input_data

    def call(handle):
        return lib.khipu_evm_call(
            cfg, _CBS, handle, nums, blk_bytes,
            env.owner, env.caller, env.origin,
            int(env.gas_price).to_bytes(32, "big"),
            int(env.value).to_bytes(32, "big"),
            inp, len(inp), env.depth, int(env.static),
            code, len(code), code_address, C.c_uint64(gas),
            int(pre_transfer),
        )

    return _finish(world, *_run(world, config, call))


def native_create_contract(
    config: EvmConfig,
    world,
    block,
    caller: bytes,
    origin: bytes,
    new_addr: bytes,
    gas: int,
    gas_price: int,
    value: int,
    init_code: bytes,
    depth: int,
) -> Tuple[ProgramResult, bytes]:
    """vm.create_contract through the native core (collision check,
    init run, EIP-170 limit and code deposit all happen in C++)."""
    lib = _get_lib()
    nums, blk_bytes = _pack_block(block)
    cfg = _pack_config(config)

    def call(handle):
        return lib.khipu_evm_create(
            cfg, _CBS, handle, nums, blk_bytes,
            caller, origin, new_addr,
            int(gas_price).to_bytes(32, "big"),
            int(value).to_bytes(32, "big"),
            init_code, len(init_code), depth, C.c_uint64(gas),
        )

    return _finish(world, *_run(world, config, call)), new_addr


def test_arith(op: int, a: int, b: int, c: int = 0) -> int:
    """Raw u256 arithmetic hook (differential tests vs evm/dataword)."""
    lib = _get_lib()
    out = C.create_string_buffer(32)
    lib.khipu_evm_test_arith(
        op, a.to_bytes(32, "big"), b.to_bytes(32, "big"),
        c.to_bytes(32, "big"), out,
    )
    return int.from_bytes(out.raw, "big")
