"""The EVM interpreter: fetch-decode-execute over a per-frame state.

Parity map (khipu-eth/.../vm/):
  VM.scala:14-60        -> run() loop
  ProgramState.scala:29 -> ProgramState (race flags live in the world's
                           read sets instead of :48's booleans)
  OpCode.scala:93-174   -> fork-gated op tables (_build_table)
  OpCode.scala:211-1646 -> the opcode bodies below
  EvmConfig.scala       -> khipu_tpu_torch.evm.config
  PrecompiledContracts  -> khipu_tpu_torch.evm.precompiles, dispatched in
                           _execute_message (Ledger.runVM:714 role)

Design: opcodes are closures over the fork's FeeSchedule, built once per
EvmConfig into a 256-slot dispatch list. Words are ints (dataword.py).
Call frames snapshot the world via BlockWorldState.copy(); exceptional
halts discard the frame's world and consume all frame gas, REVERT
additionally carries output and returns remaining gas.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Set, Tuple

from khipu_tpu_torch.base.keccak import keccak256
from khipu_tpu_torch.domain.account import EMPTY_CODE_HASH
from khipu_tpu_torch.domain.receipt import TxLogEntry
from khipu_tpu_torch.domain.transaction import contract_address, create2_address
from khipu_tpu_torch.evm import dataword as dw
from khipu_tpu_torch.evm.config import EvmConfig
from khipu_tpu_torch.evm.memory import Memory, memory_cost
from khipu_tpu_torch.evm.precompiles import get_precompile
from khipu_tpu_torch.evm.program import Program
from khipu_tpu_torch.evm.stack import Stack, StackError

MAX_CALL_DEPTH = 1024
RIPEMD_ADDR = b"\x00" * 19 + b"\x03"

# Opcode-level trace hook (debug-trace-at, VM.scala:40-57): set by the
# ledger around a traced block (which runs sequentially, so a module
# global is race-free); receives (depth, pc, op, gas, stack_items).
_TRACE: Optional[Callable] = None


def set_trace(fn: Optional[Callable]) -> None:
    global _TRACE
    _TRACE = fn


# ----------------------------------------------------------------- errors


class ProgramError(Exception):
    """Exceptional halt: consumes all frame gas (vm/ProgramError.scala:9)."""


class OutOfGas(ProgramError):
    pass


class InvalidOpcode(ProgramError):
    pass


class InvalidJump(ProgramError):
    pass


class StaticViolation(ProgramError):
    pass


class ReturnDataOutOfBounds(ProgramError):
    pass


class CreateCollision(ProgramError):
    pass


# ------------------------------------------------------------- contexts


@dataclass
class BlockEnv:
    """What the VM can observe of the enclosing block (ExecEnv role)."""

    number: int
    timestamp: int
    difficulty: int
    gas_limit: int
    beneficiary: bytes
    get_block_hash: Callable[[int], Optional[bytes]] = lambda n: None


@dataclass
class MessageEnv:
    """Per-call-frame immutable context (vm/ExecEnv.scala:21)."""

    owner: bytes  # storage/balance context (I_a)
    caller: bytes  # I_s
    origin: bytes  # I_o
    gas_price: int
    value: int  # apparent value (I_v)
    input_data: bytes
    depth: int = 0
    static: bool = False


@dataclass
class ProgramResult:
    """vm/ProgramResult.scala:16."""

    gas_remaining: int
    world: object  # BlockWorldState (valid only when error is None)
    output: bytes = b""
    logs: List[TxLogEntry] = field(default_factory=list)
    refund: int = 0
    deletes: Set[bytes] = field(default_factory=set)
    error: Optional[str] = None
    is_revert: bool = False

    @property
    def ok(self) -> bool:
        return self.error is None and not self.is_revert


class ProgramState:
    """Mutable per-frame interpreter state (vm/ProgramState.scala:29)."""

    __slots__ = (
        "world", "config", "fees", "block", "env", "program", "gas",
        "pc", "stack", "memory", "returndata", "logs", "refund",
        "halted", "output", "revert",
    )

    def __init__(self, config: EvmConfig, world, block: BlockEnv,
                 env: MessageEnv, program: Program, gas: int):
        self.world = world
        self.config = config
        self.fees = config.fees
        self.block = block
        self.env = env
        self.program = program
        self.gas = gas
        self.pc = 0
        self.stack = Stack()
        self.memory = Memory()
        self.returndata = b""
        self.logs: List[TxLogEntry] = []
        self.refund = 0
        self.halted = False
        self.output = b""
        self.revert = False

    def use_gas(self, amount: int) -> None:
        if amount > self.gas:
            raise OutOfGas(f"need {amount}, have {self.gas}")
        self.gas -= amount

    def mem_expand_gas(self, offset: int, size: int) -> int:
        """Expansion cost for touching [offset, offset+size)."""
        if size == 0:
            return 0
        new_words = (offset + size + 31) // 32
        cur = self.memory.active_words
        if new_words <= cur:
            return 0
        g = self.fees.G_memory
        return memory_cost(new_words, g) - memory_cost(cur, g)


def _to_addr(word: int) -> bytes:
    return (word & ((1 << 160) - 1)).to_bytes(20, "big")


# ------------------------------------------------------------ op bodies
# Each op is fn(st); builders below close over the fee schedule.


def _mk_binop(cost_attr, fn):
    def op(st):
        st.use_gas(getattr(st.fees, cost_attr))
        s = st.stack
        a = s.pop()
        b = s.pop()
        s.push(fn(a, b))
        st.pc += 1
    return op


def _mk_const(cost_attr, getter):
    def op(st):
        st.use_gas(getattr(st.fees, cost_attr))
        st.stack.push(getter(st))
        st.pc += 1
    return op


def _op_exp(st):
    a = st.stack.pop()
    e = st.stack.pop()
    nbytes = (e.bit_length() + 7) // 8
    st.use_gas(st.fees.G_exp + st.fees.G_expbyte * nbytes)
    st.stack.push(pow(a, e, dw.MOD))
    st.pc += 1


def _op_sha3(st):
    off = st.stack.pop()
    size = st.stack.pop()
    st.use_gas(
        st.fees.G_sha3
        + st.fees.G_sha3word * ((size + 31) // 32)
        + st.mem_expand_gas(off, size)
    )
    data = st.memory.load(off, size)
    st.stack.push(int.from_bytes(keccak256(data), "big"))
    st.pc += 1


def _op_calldataload(st):
    off = st.stack.pop()
    st.use_gas(st.fees.G_verylow)
    data = st.env.input_data
    if off >= len(data):
        st.stack.push(0)
    else:
        chunk = data[off : off + 32]
        st.stack.push(int.from_bytes(chunk.ljust(32, b"\x00"), "big"))
    st.pc += 1


def _copy_gas(st, dst, size):
    return (
        st.fees.G_verylow
        + st.fees.G_copy * ((size + 31) // 32)
        + st.mem_expand_gas(dst, size)
    )


def _zero_slice(data: bytes, off: int, size: int) -> bytes:
    if off >= len(data):
        return b"\x00" * size
    chunk = data[off : off + size]
    return chunk + b"\x00" * (size - len(chunk))


def _op_calldatacopy(st):
    dst = st.stack.pop()
    src = st.stack.pop()
    size = st.stack.pop()
    st.use_gas(_copy_gas(st, dst, size))
    st.memory.store(dst, _zero_slice(st.env.input_data, src, size))
    st.pc += 1


def _op_codecopy(st):
    dst = st.stack.pop()
    src = st.stack.pop()
    size = st.stack.pop()
    st.use_gas(_copy_gas(st, dst, size))
    st.memory.store(dst, st.program.slice(src, size))
    st.pc += 1


def _op_extcodesize(st):
    addr = _to_addr(st.stack.pop())
    st.use_gas(st.fees.G_extcode)
    st.stack.push(len(st.world.get_code(addr)))
    st.pc += 1


def _op_extcodecopy(st):
    addr = _to_addr(st.stack.pop())
    dst = st.stack.pop()
    src = st.stack.pop()
    size = st.stack.pop()
    st.use_gas(
        st.fees.G_extcode
        + st.fees.G_copy * ((size + 31) // 32)
        + st.mem_expand_gas(dst, size)
    )
    st.memory.store(dst, _zero_slice(st.world.get_code(addr), src, size))
    st.pc += 1


def _op_extcodehash(st):
    addr = _to_addr(st.stack.pop())
    st.use_gas(st.fees.G_extcodehash)
    if st.world.is_dead(addr):
        st.stack.push(0)
    else:
        st.stack.push(int.from_bytes(st.world.get_code_hash(addr), "big"))
    st.pc += 1


def _op_returndatasize(st):
    st.use_gas(st.fees.G_base)
    st.stack.push(len(st.returndata))
    st.pc += 1


def _op_returndatacopy(st):
    dst = st.stack.pop()
    src = st.stack.pop()
    size = st.stack.pop()
    st.use_gas(_copy_gas(st, dst, size))
    if src + size > len(st.returndata):
        raise ReturnDataOutOfBounds()
    st.memory.store(dst, st.returndata[src : src + size])
    st.pc += 1


def _op_blockhash(st):
    n = st.stack.pop()
    st.use_gas(st.fees.G_blockhash)
    cur = st.block.number
    if cur - 256 <= n < cur:
        h = st.block.get_block_hash(n)
        st.stack.push(int.from_bytes(h, "big") if h else 0)
    else:
        st.stack.push(0)
    st.pc += 1


def _op_pop(st):
    st.use_gas(st.fees.G_base)
    st.stack.pop()
    st.pc += 1


def _op_mload(st):
    off = st.stack.pop()
    st.use_gas(st.fees.G_verylow + st.mem_expand_gas(off, 32))
    st.stack.push(int.from_bytes(st.memory.load(off, 32), "big"))
    st.pc += 1


def _op_mstore(st):
    off = st.stack.pop()
    val = st.stack.pop()
    st.use_gas(st.fees.G_verylow + st.mem_expand_gas(off, 32))
    st.memory.store(off, dw.to_bytes32(val))
    st.pc += 1


def _op_mstore8(st):
    off = st.stack.pop()
    val = st.stack.pop()
    st.use_gas(st.fees.G_verylow + st.mem_expand_gas(off, 1))
    st.memory.store_byte(off, val)
    st.pc += 1


def _op_sload(st):
    key = st.stack.pop()
    st.use_gas(st.fees.G_sload)
    st.stack.push(st.world.get_storage(st.env.owner, key))
    st.pc += 1


def _op_sstore(st):
    if st.env.static:
        raise StaticViolation("SSTORE in static context")
    key = st.stack.pop()
    value = st.stack.pop()
    f = st.fees
    owner = st.env.owner
    if st.config.istanbul:
        # EIP-2200 net gas metering (OpCode.scala:794-912)
        if st.gas <= f.G_sstore_sentry:
            raise OutOfGas("SSTORE sentry")
        current = st.world.get_storage(owner, key)
        if value == current:
            st.use_gas(f.G_sstore_noop)
        else:
            original = st.world.get_original_storage(owner, key)
            if original == current:
                if original == 0:
                    st.use_gas(f.G_sstore_init)
                else:
                    st.use_gas(f.G_sstore_clean)
                    if value == 0:
                        st.refund += f.R_sclear
            else:
                st.use_gas(f.G_sstore_noop)
                if original != 0:
                    if current == 0:
                        st.refund -= f.R_sclear
                    if value == 0:
                        st.refund += f.R_sclear
                if original == value:
                    if original == 0:
                        st.refund += f.G_sstore_init - f.G_sstore_noop
                    else:
                        st.refund += f.G_sstore_clean - f.G_sstore_noop
            st.world.save_storage(owner, key, value)
            st.pc += 1
            return
        st.pc += 1
        return
    # Frontier..Petersburg simple metering
    current = st.world.get_storage(owner, key)
    if current == 0 and value != 0:
        st.use_gas(f.G_sset)
    else:
        st.use_gas(f.G_sreset)
        if current != 0 and value == 0:
            st.refund += f.R_sclear
    st.world.save_storage(owner, key, value)
    st.pc += 1


def _op_jump(st):
    dest = st.stack.pop()
    st.use_gas(st.fees.G_mid)
    if dest not in st.program.valid_jumpdests:
        raise InvalidJump(f"jump to {dest}")
    st.pc = dest


def _op_jumpi(st):
    dest = st.stack.pop()
    cond = st.stack.pop()
    st.use_gas(st.fees.G_high)
    if cond:
        if dest not in st.program.valid_jumpdests:
            raise InvalidJump(f"jumpi to {dest}")
        st.pc = dest
    else:
        st.pc += 1


def _op_jumpdest(st):
    st.use_gas(st.fees.G_jumpdest)
    st.pc += 1


def _mk_push(n):
    def op(st):
        st.use_gas(st.fees.G_verylow)
        data = st.program.slice(st.pc + 1, n)
        st.stack.push(int.from_bytes(data, "big"))
        st.pc += 1 + n
    return op


def _mk_dup(i):
    def op(st):
        st.use_gas(st.fees.G_verylow)
        st.stack.dup(i)
        st.pc += 1
    return op


def _mk_swap(i):
    def op(st):
        st.use_gas(st.fees.G_verylow)
        st.stack.swap(i)
        st.pc += 1
    return op


def _mk_log(ntopics):
    def op(st):
        if st.env.static:
            raise StaticViolation("LOG in static context")
        off = st.stack.pop()
        size = st.stack.pop()
        topics = tuple(
            dw.to_bytes32(st.stack.pop()) for _ in range(ntopics)
        )
        st.use_gas(
            st.fees.G_log
            + st.fees.G_logtopic * ntopics
            + st.fees.G_logdata * size
            + st.mem_expand_gas(off, size)
        )
        data = st.memory.load(off, size)
        st.logs.append(TxLogEntry(st.env.owner, topics, data))
        st.pc += 1
    return op


def _op_return(st):
    off = st.stack.pop()
    size = st.stack.pop()
    st.use_gas(st.fees.G_zero + st.mem_expand_gas(off, size))
    st.output = st.memory.load(off, size)
    st.halted = True
    st.pc += 1


def _op_revert(st):
    off = st.stack.pop()
    size = st.stack.pop()
    st.use_gas(st.fees.G_zero + st.mem_expand_gas(off, size))
    st.output = st.memory.load(off, size)
    st.halted = True
    st.revert = True
    st.pc += 1


def _op_invalid(st):
    raise InvalidOpcode("INVALID (0xfe)")


def _op_selfdestruct(st):
    if st.env.static:
        raise StaticViolation("SELFDESTRUCT in static context")
    ben = _to_addr(st.stack.pop())
    owner = st.env.owner
    f = st.fees
    cost = f.G_selfdestruct
    if st.config.eip150:
        if st.config.eip161:
            if st.world.get_balance(owner) > 0 and st.world.is_dead(ben):
                cost += f.G_newaccount
        elif not st.world.account_exists(ben):
            cost += f.G_newaccount
    st.use_gas(cost)
    # once-per-address refund, tx-scoped with frame-revert semantics:
    # the set lives in the world (copied at checkpoints, unioned on
    # merge), so sibling frames see prior selfdestructs
    if owner not in st.world.selfdestructed:
        st.refund += f.R_selfdestruct
        st.world.selfdestructed.add(owner)
    bal = st.world.get_balance(owner)
    if not st.config.eip161:
        st.world.initialize_if_missing(ben)
    st.world.add_balance(ben, bal)
    # zero the owner afterwards — handles beneficiary == owner (funds
    # destroyed) exactly like the sequential semantics
    st.world.add_balance(owner, -st.world.get_balance(owner))
    st.world.touch(ben)
    st.halted = True


# ------------------------------------------------- call/create family


def _consume_child_gas(st, requested: int) -> int:
    """EIP-150 63/64 rule (EvmConfig sub_gas_cap_divisor)."""
    if st.config.eip150:
        cap = st.gas - st.gas // 64
        child = min(requested, cap)
    else:
        child = requested
    st.use_gas(child)
    return child


def _execute_message(
    config: EvmConfig,
    world,
    block: BlockEnv,
    env: MessageEnv,
    code: bytes,
    gas: int,
    code_address: bytes,
) -> ProgramResult:
    """Run a message call frame: precompile or bytecode
    (Ledger.runVM:710-714 dispatch)."""
    pre = get_precompile(code_address, config)
    if pre is not None:
        gas_fn, run_fn = pre
        cost = gas_fn(env.input_data, config)
        if cost > gas:
            return ProgramResult(0, world, error="OutOfGas:precompile")
        out = run_fn(env.input_data)
        if out is None:
            return ProgramResult(0, world, error="PrecompileFailure")
        return ProgramResult(gas - cost, world, output=out)
    if not code:
        return ProgramResult(gas, world)
    return run(config, world, block, env, Program(code), gas)


def _finish_child(st, result: ProgramResult, out_off: int, out_size: int,
                  success_world) -> None:
    """Common CALL-family postlude: copy output, merge substate,
    return leftover gas, push the status word."""
    if result.error is None:
        out = result.output
        if out and out_size:
            st.memory.store(out_off, out[:out_size])
        st.gas += result.gas_remaining
        if not result.is_revert:
            st.world = success_world
            st.logs.extend(result.logs)
            st.refund += result.refund
            st.stack.push(1)
        else:
            st.stack.push(0)
        if st.config.byzantium:
            st.returndata = out
    else:
        # exceptional child: all child gas consumed, world discarded
        st.stack.push(0)
        if st.config.byzantium:
            st.returndata = b""


def _mk_call(kind):
    """kind: 'call' | 'callcode' | 'delegatecall' | 'staticcall'."""

    has_value = kind in ("call", "callcode")

    def op(st):
        f = st.fees
        gas_req = st.stack.pop()
        to = _to_addr(st.stack.pop())
        value = st.stack.pop() if has_value else 0
        in_off = st.stack.pop()
        in_size = st.stack.pop()
        out_off = st.stack.pop()
        out_size = st.stack.pop()

        if kind == "call" and value != 0 and st.env.static:
            raise StaticViolation("CALL with value in static context")

        cost = f.G_call
        if has_value and value != 0:
            cost += f.G_callvalue
        if kind == "call":
            if st.config.eip161:
                if value != 0 and st.world.is_dead(to):
                    cost += f.G_newaccount
            elif not st.world.account_exists(to):
                cost += f.G_newaccount
        cost += st.mem_expand_gas(in_off, in_size)
        # output expansion on top of whatever input expanded to
        mem_after_in = max(
            st.memory.active_words,
            (in_off + in_size + 31) // 32 if in_size else st.memory.active_words,
        )
        g = f.G_memory
        if out_size:
            out_words = (out_off + out_size + 31) // 32
            if out_words > mem_after_in:
                cost += memory_cost(out_words, g) - memory_cost(mem_after_in, g)
        st.use_gas(cost)
        child_gas = _consume_child_gas(st, gas_req)
        if has_value and value != 0:
            child_gas += f.G_callstipend
        st.memory._expand(in_off, in_size)
        st.memory._expand(out_off, out_size)
        input_data = st.memory.load(in_off, in_size)

        owner = st.env.owner
        if st.env.depth + 1 > MAX_CALL_DEPTH or (
            has_value and value != 0 and st.world.get_balance(owner) < value
        ):
            st.gas += child_gas  # child never ran: gas returned
            st.stack.push(0)
            if st.config.byzantium:
                st.returndata = b""
            st.pc += 1
            return

        child_world = st.world.copy()
        if kind == "call":
            if not st.config.eip161:
                child_world.initialize_if_missing(to)
            child_world.transfer(owner, to, value)
            child_world.touch(to)
            ctx_owner, ctx_caller, ctx_value = to, owner, value
            static = st.env.static
        elif kind == "callcode":
            ctx_owner, ctx_caller, ctx_value = owner, owner, value
            static = st.env.static
        elif kind == "delegatecall":
            ctx_owner, ctx_caller, ctx_value = owner, st.env.caller, st.env.value
            static = st.env.static
        else:  # staticcall
            child_world.touch(to)
            ctx_owner, ctx_caller, ctx_value = to, owner, 0
            static = True

        env = MessageEnv(
            owner=ctx_owner,
            caller=ctx_caller,
            origin=st.env.origin,
            gas_price=st.env.gas_price,
            value=ctx_value,
            input_data=input_data,
            depth=st.env.depth + 1,
            static=static,
        )
        code = st.world.get_code(to)
        result = _execute_message(
            st.config, child_world, st.block, env, code, child_gas, to
        )
        if (
            not result.ok
            and st.config.eip161_patch
            and to == RIPEMD_ADDR
        ):
            # mainnet #2,675,119 compat (OpCode.scala:1425-1436): the
            # failed frame's touch of the ripemd precompile SURVIVES
            # into the parent, so the empty 0x..03 account is deleted
            # at tx end despite the revert
            st.world.touch(to)
        _finish_child(st, result, out_off, out_size, result.world)
        st.pc += 1

    return op


def create_contract(
    config: EvmConfig,
    world,
    block: BlockEnv,
    caller: bytes,
    origin: bytes,
    new_addr: bytes,
    gas: int,
    gas_price: int,
    value: int,
    init_code: bytes,
    depth: int,
) -> Tuple[ProgramResult, bytes]:
    """Shared CREATE/CREATE2/tx-creation body (Ledger.scala:660-706 +
    OpCode CREATE :1395-1455 semantics). The caller has already consumed
    the child gas, incremented the creator nonce and validated balance/
    depth. Returns (result, new_addr)."""
    child = world.copy()
    # EIP-684 collision: existing nonce or code at the target address
    existing = child.get_account(new_addr)
    if existing is not None and (
        existing.nonce != config.account_start_nonce
        or existing.code_hash != EMPTY_CODE_HASH
    ):
        return ProgramResult(0, world, error="CreateCollision"), new_addr

    prior_balance = child.get_balance(new_addr)
    child.create_account(
        new_addr, config.contract_start_nonce, prior_balance
    )
    child.transfer(caller, new_addr, value)

    env = MessageEnv(
        owner=new_addr,
        caller=caller,
        origin=origin,
        gas_price=gas_price,
        value=value,
        input_data=b"",
        depth=depth,
        static=False,
    )
    result = run(config, child, block, env, Program(init_code), gas)
    if result.error is not None or result.is_revert:
        return result, new_addr

    code = result.output
    if config.eip170 and len(code) > config.max_code_size:
        return ProgramResult(0, world, error="CodeSizeLimit"), new_addr
    deposit = len(code) * config.fees.G_codedeposit
    if result.gas_remaining >= deposit:
        result.gas_remaining -= deposit
        result.world.save_code(new_addr, code)
    elif config.fail_on_create_deposit_oog:
        return ProgramResult(0, world, error="OutOfGas:codeDeposit"), new_addr
    else:
        result.world.save_code(new_addr, b"")  # Frontier: keep empty
    return result, new_addr


def _mk_create(is_create2):
    def op(st):
        if st.env.static:
            raise StaticViolation("CREATE in static context")
        f = st.fees
        value = st.stack.pop()
        off = st.stack.pop()
        size = st.stack.pop()
        salt = st.stack.pop() if is_create2 else 0

        cost = f.G_create + st.mem_expand_gas(off, size)
        if is_create2:
            cost += f.G_sha3word * ((size + 31) // 32)
        st.use_gas(cost)
        init_code = st.memory.load(off, size)

        owner = st.env.owner
        if (
            st.env.depth + 1 > MAX_CALL_DEPTH
            or st.world.get_balance(owner) < value
        ):
            st.stack.push(0)
            if st.config.byzantium:
                st.returndata = b""
            st.pc += 1
            return

        child_gas = _consume_child_gas(st, st.gas)
        nonce = st.world.get_nonce(owner)
        st.world.increase_nonce(owner)
        if is_create2:
            new_addr = create2_address(
                owner, dw.to_bytes32(salt), init_code
            )
        else:
            new_addr = contract_address(owner, nonce)

        result, addr = create_contract(
            st.config, st.world, st.block, owner, st.env.origin,
            new_addr, child_gas, st.env.gas_price, value, init_code,
            st.env.depth + 1,
        )
        if result.error is None:
            st.gas += result.gas_remaining
            if result.is_revert:
                st.stack.push(0)
                if st.config.byzantium:
                    st.returndata = result.output
            else:
                st.world = result.world
                st.logs.extend(result.logs)
                st.refund += result.refund
                st.stack.push(int.from_bytes(addr, "big"))
                if st.config.byzantium:
                    st.returndata = b""
        else:
            st.stack.push(0)
            if st.config.byzantium:
                st.returndata = b""
        st.pc += 1

    return op


# ---------------------------------------------------------- dispatch


def _build_table(config: EvmConfig) -> List[Optional[Callable]]:
    t: List[Optional[Callable]] = [None] * 256
    M = dw.MOD

    t[0x00] = lambda st: (_halt(st))
    t[0x01] = _mk_binop("G_verylow", lambda a, b: (a + b) % M)
    t[0x02] = _mk_binop("G_low", lambda a, b: (a * b) % M)
    t[0x03] = _mk_binop("G_verylow", lambda a, b: (a - b) % M)
    t[0x04] = _mk_binop("G_low", lambda a, b: a // b if b else 0)
    t[0x05] = _mk_binop("G_low", dw.sdiv)
    t[0x06] = _mk_binop("G_low", lambda a, b: a % b if b else 0)
    t[0x07] = _mk_binop("G_low", dw.smod)

    def _addmod(st):
        st.use_gas(st.fees.G_mid)
        a, b, n = st.stack.pop(), st.stack.pop(), st.stack.pop()
        st.stack.push((a + b) % n if n else 0)
        st.pc += 1

    def _mulmod(st):
        st.use_gas(st.fees.G_mid)
        a, b, n = st.stack.pop(), st.stack.pop(), st.stack.pop()
        st.stack.push((a * b) % n if n else 0)
        st.pc += 1

    t[0x08] = _addmod
    t[0x09] = _mulmod
    t[0x0A] = _op_exp
    t[0x0B] = _mk_binop("G_low", lambda a, b: dw.signextend(a, b))

    t[0x10] = _mk_binop("G_verylow", lambda a, b: 1 if a < b else 0)
    t[0x11] = _mk_binop("G_verylow", lambda a, b: 1 if a > b else 0)
    t[0x12] = _mk_binop(
        "G_verylow", lambda a, b: 1 if dw.to_signed(a) < dw.to_signed(b) else 0
    )
    t[0x13] = _mk_binop(
        "G_verylow", lambda a, b: 1 if dw.to_signed(a) > dw.to_signed(b) else 0
    )
    t[0x14] = _mk_binop("G_verylow", lambda a, b: 1 if a == b else 0)

    def _iszero(st):
        st.use_gas(st.fees.G_verylow)
        st.stack.push(1 if st.stack.pop() == 0 else 0)
        st.pc += 1

    t[0x15] = _iszero
    t[0x16] = _mk_binop("G_verylow", lambda a, b: a & b)
    t[0x17] = _mk_binop("G_verylow", lambda a, b: a | b)
    t[0x18] = _mk_binop("G_verylow", lambda a, b: a ^ b)

    def _not(st):
        st.use_gas(st.fees.G_verylow)
        st.stack.push(st.stack.pop() ^ dw.MASK)
        st.pc += 1

    t[0x19] = _not
    t[0x1A] = _mk_binop("G_verylow", lambda i, x: dw.byte_at(i, x))
    if config.constantinople:  # EIP-145 shifts
        t[0x1B] = _mk_binop(
            "G_verylow", lambda s, x: (x << s) % M if s < 256 else 0
        )
        t[0x1C] = _mk_binop(
            "G_verylow", lambda s, x: x >> s if s < 256 else 0
        )
        t[0x1D] = _mk_binop("G_verylow", dw.sar)

    t[0x20] = _op_sha3

    t[0x30] = _mk_const(
        "G_base", lambda st: int.from_bytes(st.env.owner, "big")
    )

    def _balance(st):
        addr = _to_addr(st.stack.pop())
        st.use_gas(st.fees.G_balance)
        st.stack.push(st.world.get_balance(addr))
        st.pc += 1

    t[0x31] = _balance
    t[0x32] = _mk_const(
        "G_base", lambda st: int.from_bytes(st.env.origin, "big")
    )
    t[0x33] = _mk_const(
        "G_base", lambda st: int.from_bytes(st.env.caller, "big")
    )
    t[0x34] = _mk_const("G_base", lambda st: st.env.value)
    t[0x35] = _op_calldataload
    t[0x36] = _mk_const("G_base", lambda st: len(st.env.input_data))
    t[0x37] = _op_calldatacopy
    t[0x38] = _mk_const("G_base", lambda st: len(st.program))
    t[0x39] = _op_codecopy
    t[0x3A] = _mk_const("G_base", lambda st: st.env.gas_price)
    t[0x3B] = _op_extcodesize
    t[0x3C] = _op_extcodecopy
    if config.byzantium:
        t[0x3D] = _op_returndatasize
        t[0x3E] = _op_returndatacopy
    if config.constantinople:
        t[0x3F] = _op_extcodehash

    t[0x40] = _op_blockhash
    t[0x41] = _mk_const(
        "G_base", lambda st: int.from_bytes(st.block.beneficiary, "big")
    )
    t[0x42] = _mk_const("G_base", lambda st: st.block.timestamp)
    t[0x43] = _mk_const("G_base", lambda st: st.block.number)
    t[0x44] = _mk_const("G_base", lambda st: st.block.difficulty)
    t[0x45] = _mk_const("G_base", lambda st: st.block.gas_limit)
    if config.istanbul:
        t[0x46] = _mk_const("G_base", lambda st: st.config.chain_id)
        t[0x47] = _mk_const(
            "G_low", lambda st: st.world.get_balance(st.env.owner)
        )

    t[0x50] = _op_pop
    t[0x51] = _op_mload
    t[0x52] = _op_mstore
    t[0x53] = _op_mstore8
    t[0x54] = _op_sload
    t[0x55] = _op_sstore
    t[0x56] = _op_jump
    t[0x57] = _op_jumpi
    t[0x58] = _mk_const("G_base", lambda st: st.pc)
    t[0x59] = _mk_const("G_base", lambda st: st.memory.size())
    t[0x5A] = _mk_const("G_base", lambda st: st.gas)
    t[0x5B] = _op_jumpdest

    for i in range(32):
        t[0x60 + i] = _mk_push(i + 1)
    for i in range(16):
        t[0x80 + i] = _mk_dup(i + 1)
        t[0x90 + i] = _mk_swap(i + 1)
    for i in range(5):
        t[0xA0 + i] = _mk_log(i)

    t[0xF0] = _mk_create(False)
    t[0xF1] = _mk_call("call")
    t[0xF2] = _mk_call("callcode")
    t[0xF3] = _op_return
    if config.homestead:
        t[0xF4] = _mk_call("delegatecall")
    if config.constantinople:
        t[0xF5] = _mk_create(True)
    if config.byzantium:
        t[0xFA] = _mk_call("staticcall")
        t[0xFD] = _op_revert
    t[0xFE] = _op_invalid
    t[0xFF] = _op_selfdestruct
    return t


def _halt(st):
    st.use_gas(st.fees.G_zero)
    st.halted = True
    st.output = b""


# Keyed by the (frozen, hashable) config VALUE — an id() key could be
# silently reused after GC and hand a block the wrong fork's op table.
_TABLE_CACHE = {}


def _table_for(config: EvmConfig):
    table = _TABLE_CACHE.get(config)
    if table is None:
        table = _TABLE_CACHE[config] = _build_table(config)
    return table


# ----------------------------------------------------------------- run


def run(
    config: EvmConfig,
    world,
    block: BlockEnv,
    env: MessageEnv,
    program: Program,
    gas: int,
) -> ProgramResult:
    """VM.run (vm/VM.scala:14-60): interpret until halt/error.

    The caller passes a world it can discard on error (call sites copy
    before invoking).
    """
    st = ProgramState(config, world, block, env, program, gas)
    table = _table_for(config)
    code = program.code
    n = len(code)
    try:
        while not st.halted:
            op = code[st.pc] if 0 <= st.pc < n else 0x00
            fn = table[op]
            if fn is None:
                raise InvalidOpcode(f"0x{op:02x}")
            if _TRACE is not None:
                _TRACE(env.depth, st.pc, op, st.gas, st.stack.items)
            fn(st)
    except StackError as e:
        return ProgramResult(0, world, error=f"Stack:{e}")
    except ProgramError as e:
        return ProgramResult(0, world, error=f"{type(e).__name__}:{e}")
    return ProgramResult(
        gas_remaining=st.gas,
        world=st.world,
        output=st.output,
        logs=st.logs,
        refund=st.refund,
        deletes=set(st.world.selfdestructed),
        is_revert=st.revert,
    )
