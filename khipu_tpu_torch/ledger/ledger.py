"""Block executor: tx validation, serial execution, receipts, rewards,
and the post-execution bit-exactness gate.

Parity: ledger/Ledger.scala:95 —
  executeBlock:230            -> execute_block (the sequential path
                                 :250-271)
  validateAndExecuteTransaction:517 -> _validate_stx + execute_transaction
  prepareProgramContext:660   -> inside execute_transaction
  runVM:710                   -> khipu_tpu_torch.evm.vm
  postExecuteTransactions:463 -> _tx_post (receipts w/ cumulative gas +
                                 bloom, miner fee pay, EIP-161 dead-
                                 account deletion) — folded into the
                                 per-tx loop because sequential
                                 semantics pays the fee of tx i before
                                 tx i+1 runs, and pre-Byzantium receipts
                                 carry the intermediate state root
  payBlockReward:629          -> _pay_rewards
  validateBlockAfterExecution:603-620 -> the gasUsed/stateRoot/
                                 receiptsRoot/bloom gate

The port's counterpart of ``khipu_tpu.ledger.ledger`` carries the serial
fold only. The JAX package's parallel paths (the optimistic merge
executeTransactions_inparallel:337 and the conflict-aware scheduled
executor with its vectorized batch lanes) are not ported yet:
``sync.parallel_tx`` with more than one transaction in a block raises
``NotImplementedError``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Union

from khipu_tpu_torch.base.secp256k1 import HALF_N
from khipu_tpu_torch.config import KhipuConfig
from khipu_tpu_torch.domain.block import Block
from khipu_tpu_torch.domain.receipt import Receipt, TxLogEntry
from khipu_tpu_torch.domain.transaction import SignedTransaction, contract_address
from khipu_tpu_torch.evm.config import EvmConfig, for_block
from khipu_tpu_torch.evm.dispatch import run_create, run_message_call
from khipu_tpu_torch.evm.vm import BlockEnv, MessageEnv
from khipu_tpu_torch.ledger.bloom import bloom_of_logs, bloom_union
from khipu_tpu_torch.ledger.rewards import block_rewards
from khipu_tpu_torch.ledger.world import BlockWorldState


class BlockExecutionError(Exception):
    """BlockExecutionError ADT (Ledger.scala:62-71)."""


class TxValidationError(BlockExecutionError):
    def __init__(self, index: int, reason: str):
        super().__init__(f"tx[{index}]: {reason}")
        self.index = index
        self.reason = reason


class ValidationAfterExecError(BlockExecutionError):
    pass


@dataclass
class TxResult:
    world: BlockWorldState
    gas_used: int
    fee: int
    logs: List[TxLogEntry]
    status: int  # 1 success, 0 failed (EIP-658)
    error: Optional[str] = None  # VM-level error (tx still valid)


@dataclass
class Stats:
    """Per-block perf stats (Ledger.Stats, Ledger.scala:56-58):
    ``exec_seconds`` from the first transaction to the paid rewards,
    ``commit_seconds`` the state-root flush of the post-execution gate
    (the block's trie commit, on the card with a device hasher)."""

    tx_count: int = 0
    gas_used: int = 0
    exec_seconds: float = 0.0
    commit_seconds: float = 0.0


@dataclass
class BlockResult:
    world: BlockWorldState
    receipts: List[Receipt]
    gas_used: int
    stats: Stats


# ------------------------------------------------------------ validation


def _validate_stx(
    stx: SignedTransaction,
    sender: Optional[bytes],
    config: EvmConfig,
    world: BlockWorldState,
    accumulated_gas: int,
    block_gas_limit: int,
    index: int,
) -> None:
    """SignedTransactionValidator semantics (sig/nonce/gas/balance)."""
    tx = stx.tx
    if sender is None:
        raise TxValidationError(index, "unrecoverable signature")
    if config.homestead and stx.s > HALF_N:
        raise TxValidationError(index, "high s (EIP-2)")
    cid = stx.chain_id
    if cid is not None:
        if not config.eip155:
            raise TxValidationError(index, "EIP-155 v before fork")
        if cid != config.chain_id:
            raise TxValidationError(index, f"wrong chain id {cid}")
    nonce = world.get_nonce(sender)
    if tx.nonce != nonce:
        raise TxValidationError(
            index, f"nonce {tx.nonce} != account {nonce}"
        )
    intrinsic = config.intrinsic_gas(tx.payload, tx.is_contract_creation)
    if tx.gas_limit < intrinsic:
        raise TxValidationError(
            index, f"gas limit {tx.gas_limit} < intrinsic {intrinsic}"
        )
    upfront = tx.gas_limit * tx.gas_price + tx.value
    balance = world.get_balance(sender)
    if balance < upfront:
        raise TxValidationError(
            index, f"balance {balance} < upfront {upfront}"
        )
    if accumulated_gas + tx.gas_limit > block_gas_limit:
        raise TxValidationError(index, "cumulative gas above block limit")


# ------------------------------------------------------------- execution


def execute_transaction(
    config: EvmConfig,
    world: BlockWorldState,
    block_env: BlockEnv,
    stx: SignedTransaction,
    sender: bytes,
) -> TxResult:
    """One validated tx against ``world`` (mutates it). Miner fee is
    returned, not paid (see module docstring)."""
    tx = stx.tx
    gas_price = tx.gas_price
    gas_limit = tx.gas_limit

    world.increase_nonce(sender)
    world.add_balance(sender, -(gas_limit * gas_price))  # gas escrow
    intrinsic = config.intrinsic_gas(tx.payload, tx.is_contract_creation)
    gas = gas_limit - intrinsic

    checkpoint = world.copy()
    if tx.is_contract_creation:
        new_addr = contract_address(sender, tx.nonce)
        result, _ = run_create(
            config, world, block_env, sender, sender, new_addr, gas,
            gas_price, tx.value, tx.payload, depth=0,
        )
    else:
        env = MessageEnv(
            owner=tx.to,
            caller=sender,
            origin=sender,
            gas_price=gas_price,
            value=tx.value,
            input_data=tx.payload,
            depth=0,
        )
        result = run_message_call(
            config, world, block_env, env, world.get_code(tx.to), gas,
            tx.to, pre_transfer=True,
        )

    if result.error is not None:
        world = checkpoint
        gas_remaining = 0
        logs: List[TxLogEntry] = []
        status = 0
        err: Optional[str] = result.error
    elif result.is_revert:
        world = checkpoint
        gas_remaining = result.gas_remaining
        logs = []
        status = 0
        err = "Revert"
    else:
        world = result.world
        gas_used_pre = gas_limit - result.gas_remaining
        refund = min(max(result.refund, 0), gas_used_pre // 2)
        gas_remaining = result.gas_remaining + refund
        for addr in sorted(world.selfdestructed):
            world.delete_account(addr)
        world.selfdestructed.clear()
        logs = list(result.logs)
        status = 1
        err = None

    world.add_balance(sender, gas_remaining * gas_price)

    # EIP-161: touched accounts that end the tx dead are deleted.
    # get_account (not _current_account) so the emptiness observation is
    # a RECORDED read: if an earlier parallel tx credited the account,
    # the merge must flag a conflict instead of letting this deletion
    # erase the credit.
    if config.eip161:
        for addr in sorted(world.touched):
            acc = world.get_account(addr)
            if acc is not None and acc.is_empty:
                world.delete_account(addr)
    world.touched.clear()

    gas_used = gas_limit - gas_remaining
    return TxResult(world, gas_used, gas_used * gas_price, logs, status, err)


def _tx_post(
    config: EvmConfig,
    world: BlockWorldState,
    r: TxResult,
    beneficiary: bytes,
    cumulative: int,
    receipts: List[Receipt],
) -> int:
    """Pay the miner fee of one tx and build its receipt — the serial
    per-tx tail of postExecuteTransactions:463."""
    world.add_balance(beneficiary, r.fee)
    world.touch(beneficiary)
    if config.eip161:
        acc = world.get_account(beneficiary)
        if acc is not None and acc.is_empty:
            world.delete_account(beneficiary)
    world.touched.discard(beneficiary)
    cumulative += r.gas_used
    bloom = bloom_of_logs(r.logs)
    if config.byzantium:
        post: Union[bytes, int] = r.status
    else:
        post = world.root_hash  # intermediate root, sequential-exact
    receipts.append(Receipt(post, cumulative, bloom, tuple(r.logs)))
    return cumulative


def execute_block(
    block: Block,
    parent_state_root: bytes,
    make_world: Callable[[bytes], BlockWorldState],
    khipu_config: KhipuConfig,
    validate: bool = True,
    check_root: bool = True,
    hasher=None,
) -> BlockResult:
    """Execute every tx of a block and gate the result against the
    header (executeBlock:230 + validateBlockAfterExecution:603-620).

    ``make_world(state_root)`` builds a fresh world at a root — the
    Blockchain facade provides it. Raises BlockExecutionError.
    """
    header = block.header
    bc = khipu_config.blockchain
    config = for_block(header.number, bc)
    if validate and (
        header.number == bc.dao_fork_block_number
        and bc.dao_fork_block_hash is not None
        and header.hash != bc.dao_fork_block_hash
    ):
        # fork-block identity: replaying the OTHER side's chain must
        # fail here, not at some downstream root mismatch
        # (ForkResolver.scala:20-24). Draft blocks (validate=False,
        # chain builder) have non-final hashes and skip this.
        raise BlockExecutionError(
            f"block {header.number} hash {header.hash.hex()} is not the "
            f"configured DAO fork block {bc.dao_fork_block_hash.hex()}"
        )
    if (
        header.number == bc.dao_fork_block_number
        and bc.dao_drain_list
        and bc.dao_refund_contract is not None
    ):
        # irregular state change: every world built at the parent root
        # sees the drain applied before any tx (each optimistic
        # parallel attempt snapshots the SAME post-drain pre-state)
        inner_make = make_world
        refund = bc.dao_refund_contract
        drain = bc.dao_drain_list

        def make_world(root, _inner=inner_make):
            w = _inner(root)
            if root == parent_state_root:
                for addr in drain:
                    bal = w.get_balance(addr)
                    w.transfer(addr, refund, bal)
            return w

    block_env = BlockEnv(
        number=header.number,
        timestamp=header.unix_timestamp,
        difficulty=header.difficulty,
        gas_limit=header.gas_limit,
        beneficiary=header.beneficiary,
        get_block_hash=lambda n: None,
    )
    # BLOCKHASH resolution comes from the world factory's chain access
    probe = make_world(parent_state_root)
    block_env.get_block_hash = probe.get_block_hash
    txs = list(block.body.transactions)
    from khipu_tpu_torch.domain.transaction import recover_senders

    recover_senders(txs)  # one native batch call; caches per-tx
    senders = [stx.sender for stx in txs]
    t0 = time.perf_counter()
    stats = Stats(tx_count=len(txs))

    traced = khipu_config.sync.debug_trace_at == header.number
    if traced:
        # debug-trace-at disables parallelism for that block
        # (Ledger.executeBlock:232) and prints one line per opcode
        from khipu_tpu_torch.evm.vm import set_trace

        def _trace(depth, pc, op, gas, stack):
            top = hex(stack[-1]) if stack else "-"
            print(
                f"[trace] 0x{op:02x} | pc {pc} | depth {depth} | "
                f"gas {gas} | stack[{len(stack)}] top {top}"
            )

        set_trace(_trace)
    if khipu_config.sync.parallel_tx and len(txs) > 1 and not traced:
        raise NotImplementedError(
            "parallel_tx with more than one transaction a block needs the "
            "scheduled and optimistic executors (ledger/schedule.py, "
            "batch_exec.py, batch_call.py), which khipu_tpu_torch has not "
            "ported yet (ROADMAP A: parallel and scheduled execution); "
            "set sync.parallel_tx=False"
        )
    try:
        world, receipts, gas_used = _execute_sequential(
            config, block_env, txs, senders, parent_state_root,
            make_world, header,
        )
    finally:
        if traced:
            from khipu_tpu_torch.evm.vm import set_trace

            set_trace(None)

    _pay_rewards(world, block, khipu_config)
    stats.gas_used = gas_used
    stats.exec_seconds = time.perf_counter() - t0

    if validate:
        _validate_after(block, world, receipts, gas_used, check_root,
                        hasher, stats)
    return BlockResult(world, receipts, gas_used, stats)


def _execute_sequential(
    config, block_env, txs, senders, parent_root, make_world, header,
):
    """Serial fold (the :250-271 fallback path)."""
    world = make_world(parent_root)
    receipts: List[Receipt] = []
    cumulative = 0
    accumulated_gas = 0
    for i in range(len(txs)):
        _validate_stx(
            txs[i], senders[i], config, world, accumulated_gas,
            header.gas_limit, i,
        )
        r = execute_transaction(config, world, block_env, txs[i], senders[i])
        world = r.world  # call frames fork copies; adopt the final one
        accumulated_gas += r.gas_used
        cumulative = _tx_post(
            config, world, r, header.beneficiary, cumulative, receipts
        )
    return world, receipts, cumulative


def _pay_rewards(world: BlockWorldState, block: Block, khipu_config) -> None:
    """payBlockReward (Ledger.scala:629) + EIP-161 touch semantics."""
    bc = khipu_config.blockchain
    header = block.header
    miner_reward, ommer_rewards = block_rewards(
        header.number, [o.number for o in block.body.ommers], bc
    )
    world.add_balance(header.beneficiary, miner_reward)
    world.touch(header.beneficiary)
    config = for_block(header.number, bc)
    for ommer, reward in zip(block.body.ommers, ommer_rewards):
        if reward:
            world.add_balance(ommer.beneficiary, reward)
            world.touch(ommer.beneficiary)
    if config.eip161:
        for addr in [header.beneficiary] + [
            o.beneficiary for o in block.body.ommers
        ]:
            acc = world.get_account(addr)
            if acc is not None and acc.is_empty:
                world.delete_account(addr)
    world.touched.clear()


def _validate_after(
    block: Block, world: BlockWorldState, receipts: List[Receipt],
    gas_used: int, check_root: bool = True, hasher=None,
    stats: Optional[Stats] = None,
) -> None:
    """The bit-exactness gate (Ledger.scala:603-620). ``check_root``
    False defers the state-root comparison to the caller (window mode
    checks all roots at finalize, after ONE batched device pass)."""
    from khipu_tpu_torch.validators.roots import receipts_root

    header = block.header
    if gas_used != header.gas_used:
        raise ValidationAfterExecError(
            f"block {header.number}: gasUsed {gas_used} != header "
            f"{header.gas_used}"
        )
    if check_root:
        # flush IN PLACE (not on a copy): the block's execution is
        # complete, and world.flush() is accumulate-safe so the caller's
        # subsequent persist() reuses this work instead of repeating the
        # whole materialize+insert pass (the former root_hash-on-a-copy
        # doubled the per-block trie cost). ``hasher`` must be the same
        # one the caller will persist with — otherwise the device-commit
        # path would be silently bypassed here.
        t0 = time.perf_counter()
        root = world.flush(hasher).account_trie.root_hash
        if stats is not None:
            stats.commit_seconds = time.perf_counter() - t0
        if root != header.state_root:
            raise ValidationAfterExecError(
                f"block {header.number}: stateRoot {root.hex()} != header "
                f"{header.state_root.hex()}"
            )
    rroot = receipts_root(receipts)
    if rroot != header.receipts_root:
        raise ValidationAfterExecError(
            f"block {header.number}: receiptsRoot {rroot.hex()} != "
            f"header {header.receipts_root.hex()}"
        )
    bloom = bloom_union(r.logs_bloom for r in receipts)
    if bloom != header.logs_bloom:
        raise ValidationAfterExecError(
            f"block {header.number}: logsBloom mismatch"
        )
