"""Block executor: tx validation, execution, parallel merge, receipts,
rewards, and the post-execution bit-exactness gate.

Parity: ledger/Ledger.scala:95 —
  executeBlock:230            -> execute_block (parallel attempt,
                                 sequential fallback :250-271)
  executeTransactions_inparallel:337 -> _execute_optimistic (fresh
                                 world per tx from the parent root
                                 :354, serial merge + re-execute
                                 :393-434); _execute_scheduled is the
                                 conflict-aware front end (schedule.py
                                 plans, batch_exec.py vectorizes the
                                 plain-transfer batches, optimistic is
                                 the misprediction fallback)
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

The miner fee is paid serially in the merge loop (never inside a
parallel tx world): txs that *read* the coinbase conflict and re-run
serially, every other pair of txs merges commutatively.

Parallelism note: worker threads give the merge algebra real
concurrency but CPython's GIL serializes the interpreter itself; CPU
parallelism for the Python EVM arrives with free-threaded builds or the
native EVM (the algebra and its tests are identical either way). No
worker thread touches the card: with ``sync.exec_device`` the scheduled
executor's row validation launches on the calling thread, and a caller
whose worlds read through the device mirror passes ``exec_pool=False``,
which runs the optimistic attempts on the calling thread too.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Set, Tuple, Union

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
from khipu_tpu_torch.observability.journey import JOURNEY
from khipu_tpu_torch.observability.profiler import HOST, LEDGER


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
    """Per-block perf stats (Ledger.Stats, Ledger.scala:56-58).

    ``parallel_count`` counts txs that merged without serial re-run
    (optimistic path) or executed inside a scheduled batch;
    ``conflict_count`` counts serial re-executions (optimistic) or
    predicted txs a conflict edge pushed past batch 0 (scheduled) —
    the same "how contended was this block" signal either way.
    ``exec_seconds`` runs from the first transaction to the paid
    rewards, ``commit_seconds`` is the state-root flush of the
    post-execution gate (the block's trie commit, on the card with a
    device hasher).
    """

    tx_count: int = 0
    parallel_count: int = 0
    conflict_count: int = 0
    gas_used: int = 0
    exec_seconds: float = 0.0
    commit_seconds: float = 0.0
    fast_path_txs: int = 0  # txs through the vectorized batch executor
    residue_txs: int = 0  # txs through the serial interpreter residue
    mispredicted_txs: int = 0  # scheduled attempts discarded post-hoc

    @property
    def parallel_rate(self) -> float:
        return self.parallel_count / self.tx_count if self.tx_count else 1.0


# Process-wide executor pool for the optimistic path: one block per
# driver at a time uses it, and rebuilding a ThreadPoolExecutor per
# block (the old `with` form) paid thread spawn+join on EVERY block.
# Sized from the first caller's config; resized only if the width
# changes; shut down via ServiceBoard.shutdown() (and tests).
_EXEC_POOL: Optional[ThreadPoolExecutor] = None
_EXEC_POOL_WIDTH = 0
_EXEC_POOL_LOCK = threading.Lock()


def _exec_pool(workers: int) -> ThreadPoolExecutor:
    global _EXEC_POOL, _EXEC_POOL_WIDTH
    with _EXEC_POOL_LOCK:
        if _EXEC_POOL is None or _EXEC_POOL_WIDTH != workers:
            if _EXEC_POOL is not None:
                _EXEC_POOL.shutdown(wait=False)
            _EXEC_POOL = ThreadPoolExecutor(
                max_workers=workers, thread_name_prefix="khipu-exec"
            )
            _EXEC_POOL_WIDTH = workers
        return _EXEC_POOL


def shutdown_exec_pool() -> None:
    global _EXEC_POOL, _EXEC_POOL_WIDTH
    with _EXEC_POOL_LOCK:
        if _EXEC_POOL is not None:
            _EXEC_POOL.shutdown(wait=True)
            _EXEC_POOL = None
            _EXEC_POOL_WIDTH = 0


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
    exec_pool: bool = True,
    device=None,
) -> BlockResult:
    """Execute every tx of a block and gate the result against the
    header (executeBlock:230 + validateBlockAfterExecution:603-620).

    ``make_world(state_root)`` builds a fresh world at a root — the
    Blockchain facade provides it. Raises BlockExecutionError.

    With ``sync.parallel_tx`` a block of more than one transaction runs
    the scheduled executor (Byzantium+ with ``sync.scheduled_tx``) or
    the optimistic one; ``exec_pool=False`` runs the optimistic
    attempts on this thread. ``device`` is where the scheduled
    executor's row validation runs when ``sync.exec_device`` allows it
    (``None`` means the card).
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
    rewards_paid = False
    validated_scheduled = False
    try:
        if khipu_config.sync.parallel_tx and len(txs) > 1 and not traced:
            world = receipts = gas_used = None
            # pre-Byzantium receipts embed intermediate state roots, so
            # out-of-index-order batch execution would corrupt them —
            # the scheduler only runs where receipts carry status codes
            if khipu_config.sync.scheduled_tx and config.byzantium:
                from khipu_tpu_torch.ledger.schedule import (
                    EXEC_GAUGES,
                    LEARNER,
                    Misprediction,
                )

                trusted_used = set()
                try:
                    world, receipts, gas_used, trusted_used = (
                        _execute_scheduled(
                            config, block_env, txs, senders,
                            parent_state_root, make_world, header,
                            stats, khipu_config.sync, device,
                        )
                    )
                    if trusted_used and validate:
                        # commit-or-discard for the vectorized trusted
                        # lane: prove the header oracle NOW, while the
                        # whole-block optimistic fallback is still
                        # available — a trusted template that produces
                        # a wrong root demotes (never oscillates back)
                        # and the block re-runs without it, bit-exact
                        _pay_rewards(world, block, khipu_config)
                        rewards_paid = True
                        stats.exec_seconds = time.perf_counter() - t0
                        _validate_after(
                            block, world, receipts, gas_used,
                            check_root, hasher, stats,
                        )
                        validated_scheduled = True
                except (Misprediction, TxValidationError) as e:
                    # the scheduled attempt is void: discard its world
                    # AND its stats, then re-run the whole block on the
                    # optimistic path, which owns the authoritative
                    # outcome (correctness never depends on prediction)
                    if isinstance(e, Misprediction):
                        stats.mispredicted_txs += 1
                        EXEC_GAUGES["mispredictions"] += 1
                        if JOURNEY.enabled and e.index < len(txs):
                            JOURNEY.record(txs[e.index].hash,
                                           "mispredict",
                                           reason=e.detail,
                                           block=header.number)
                    EXEC_GAUGES["fallbacks"] += 1
                    if JOURNEY.enabled:
                        for stx in txs:
                            JOURNEY.record(stx.hash, "execute",
                                           lane="serial-fallback",
                                           rerun=True,
                                           block=header.number)
                    stats.parallel_count = 0
                    stats.conflict_count = 0
                    stats.fast_path_txs = 0
                    stats.residue_txs = 0
                    world = None
                    rewards_paid = False
                except ValidationAfterExecError:
                    if not trusted_used:
                        raise  # scheduled-but-unvectorized roots are
                        # authoritative — this would be a real bug
                    for ch in trusted_used:
                        LEARNER.demote(ch)
                    stats.mispredicted_txs += 1
                    EXEC_GAUGES["mispredictions"] += 1
                    EXEC_GAUGES["fallbacks"] += 1
                    if JOURNEY.enabled:
                        for stx in txs:
                            JOURNEY.record(stx.hash, "execute",
                                           lane="serial-fallback",
                                           rerun=True,
                                           block=header.number)
                    stats.parallel_count = 0
                    stats.conflict_count = 0
                    stats.fast_path_txs = 0
                    stats.residue_txs = 0
                    world = None
                    rewards_paid = False
                    validated_scheduled = False
            if world is None:
                world, receipts, gas_used = _execute_optimistic(
                    config, block_env, txs, senders, parent_state_root,
                    make_world, header,
                    khipu_config.sync.tx_workers if exec_pool else 1,
                    stats,
                )
        else:
            world, receipts, gas_used = _execute_sequential(
                config, block_env, txs, senders, parent_state_root,
                make_world, header,
            )
    finally:
        if traced:
            from khipu_tpu_torch.evm.vm import set_trace

            set_trace(None)

    if not rewards_paid:
        _pay_rewards(world, block, khipu_config)
        stats.exec_seconds = time.perf_counter() - t0
    stats.gas_used = gas_used

    if validate and not validated_scheduled:
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


def _execute_scheduled(
    config, block_env, txs, senders, parent_root, make_world, header,
    stats: Stats, sync_cfg=None, device=None,
):
    """Conflict-aware scheduled execution (schedule.plan_block) on ONE
    merged world — zero merge conflicts by construction.

    Steps run in plan order: each batch's plain transfers go through
    the vectorized transfer executor, its TRUSTED templated calls
    through the vectorized call executor (batch_call.py — the learner
    promoted their code hash after TRUST_AFTER exact checked
    confirmations), remaining template calls through the interpreter
    with their ACTUAL footprint captured and checked against the
    prediction (each successful checked run feeding LEARNER.confirm);
    a residue tx is a barrier — every earlier tx's fee posts first
    (post_through), so it observes the exact sequential state.
    Receipts, fees, and the cumulative block-gas rule are applied
    strictly in index order regardless of execution order; no
    predicted tx may touch the beneficiary (the planner routes those
    to the residue), so deferring fee posting is invisible.

    Returns (world, receipts, gas_used, trusted_used) where
    ``trusted_used`` is the set of code hashes whose calls executed
    vectorized — execute_block's header-oracle backstop demotes them
    all if the block root comes out wrong.

    Raises schedule.Misprediction or TxValidationError to demand the
    whole-block optimistic fallback (caller: execute_block).
    """
    from khipu_tpu_torch.ledger.batch_call import execute_call_batch
    from khipu_tpu_torch.ledger.batch_exec import execute_fast_batch
    from khipu_tpu_torch.ledger.schedule import (
        CALL,
        EMPTY_CODE_HASH,
        EXEC_GAUGES,
        LEARNER,
        Misprediction,
        Step,
        Template,
        _apply_rules,
        _arg_words,
        footprint_ok,
        plan_block,
    )

    merged = make_world(parent_root)
    plan = plan_block(
        txs, senders, header.beneficiary, merged.get_code_hash, LEARNER
    )
    if merged.touched:
        # touch marks set before the first transaction (the DAO drain's
        # transfers in make_world): every other executor sweeps them at
        # the end of the block's first transaction, and a fast or call
        # batch drops marks without a sweep. So tx 0 runs first, alone,
        # through the interpreter, whose end-of-tx sweep covers them
        # exactly as there. It has no predecessor, so running it ahead
        # of its batch keeps every precedence the plan holds
        plan.steps = [Step("residue", [0])] + [
            Step(step.kind, [i for i in step.indices if i != 0])
            for step in plan.steps if step.indices != [0]
        ]
    stats.conflict_count += plan.conflicted
    trusted_used: Set[bytes] = set()

    # device validation of the gathered row tiles (K6 on the card) —
    # only when the sync config opts in AND the adaptive probe agrees
    # the device round trip pays for itself, or is switched off. Host
    # numpy is the default; with the device on, its errors propagate
    device_validate = None
    if sync_cfg is not None and getattr(sync_cfg, "exec_device", False):
        from khipu_tpu_torch.sync.adaptive import exec_device_allowed

        if exec_device_allowed(sync_cfg, device):
            from khipu_tpu_torch.trie.fused import fused_exec_validate

            def device_validate(tx_nonces, acct_nonces, balances,
                                upfronts):
                return fused_exec_validate(tx_nonces, acct_nonces,
                                           balances, upfronts, device)

    receipts: List[Receipt] = []
    outcomes: List[Optional[TxResult]] = [None] * len(txs)
    cumulative = 0
    accumulated_gas = 0
    posted = 0

    def post_through(limit: int) -> None:
        """Post fees + receipts for txs [posted, limit) in index order
        (they have all executed). The cumulative block-gas rule (YP
        eq. 58) is enforced HERE, against the true running total —
        batch execution validated with accumulated_gas=0, exactly like
        the optimistic pass."""
        nonlocal cumulative, accumulated_gas, posted
        while posted < limit:
            r = outcomes[posted]
            if accumulated_gas + txs[posted].tx.gas_limit > header.gas_limit:
                raise TxValidationError(
                    posted, "cumulative gas above block limit"
                )
            accumulated_gas += r.gas_used
            cumulative = _tx_post(
                config, merged, r, header.beneficiary, cumulative, receipts
            )
            posted += 1

    def run_captured(i: int, accumulated: int) -> Dict[str, Set]:
        """Validate + execute tx i on the merged world with fresh
        reads/written dicts swapped in, so the tx's ACTUAL footprint
        is observable. Adopts the result world as ``merged``, unions
        the captured sets back, and returns them. Exploits copy()
        semantics: call-frame checkpoints share ``reads`` by reference
        and copy ``written`` — so reads survive reverts (as required)
        and the final world's ``written`` is the tx's true write set."""
        nonlocal merged
        saved_reads, saved_written = merged.reads, merged.written
        merged.reads = {k: set() for k in saved_reads}
        merged.written = {k: set() for k in saved_written}
        _validate_stx(
            txs[i], senders[i], config, merged, accumulated,
            header.gas_limit, i,
        )
        r = execute_transaction(config, merged, block_env, txs[i], senders[i])
        world = r.world  # call frames fork copies; adopt the final one
        captured = {"reads": world.reads, "written": world.written}
        for cat in saved_reads:
            saved_reads[cat] |= world.reads[cat]
            saved_written[cat] |= world.written[cat]
        world.reads = saved_reads
        world.written = saved_written
        merged = world
        outcomes[i] = r
        return captured

    for step in plan.steps:
        if step.kind == "residue":
            i = step.indices[0]
            post_through(i)  # the residue sees exact sequential state
            tx = txs[i].tx
            code_hash = (
                merged.get_code_hash(tx.to) if tx.to is not None else None
            )
            t_run = time.perf_counter()
            captured = run_captured(i, accumulated_gas)
            # host-side classification event: per-tx interpreter time,
            # the residue against the vectorized batches
            LEDGER.record("exec.residue", HOST, 0,
                          duration=time.perf_counter() - t_run)
            stats.residue_txs += 1
            if JOURNEY.enabled:
                JOURNEY.record(txs[i].hash, "execute",
                               lane="residue", index=i)
            if (
                code_hash is not None
                and code_hash != EMPTY_CODE_HASH
                and senders[i] is not None
                and outcomes[i].error is None
                and outcomes[i].status == 1
            ):
                # teach the learner from successful template-shaped
                # calls only — error/revert paths have partial
                # footprints that would under-predict
                LEARNER.observe(
                    code_hash, senders[i], tx.to, tx.payload,
                    captured["reads"], captured["written"],
                    code=merged.get_code(tx.to),
                )
            post_through(i + 1)
            continue
        fast_items = []
        call_items = []
        for i in step.indices:
            if plan.predicted[i].kind == CALL:
                if i in plan.trusted:
                    code_hash, tpl = plan.trusted[i]
                    call_items.append(
                        (i, txs[i], senders[i], code_hash, tpl)
                    )
                    continue
                pred = plan.predicted[i]
                tx_i = txs[i].tx
                code_hash = merged.get_code_hash(tx_i.to)
                # pre-state snapshot of every predicted slot, so a
                # successful checked run can teach the learner this
                # call's storage EFFECTS (toward the trusted lane)
                confirm_keys = pre = original = None
                tpl = LEARNER.lookup(code_hash)
                if (isinstance(tpl, Template) and tpl.vectorizable
                        and tpl.scan is not None and tx_i.value == 0):
                    keys = _apply_rules(
                        tpl.rules,
                        int.from_bytes(senders[i], "big"),
                        _arg_words(tx_i.payload),
                    )
                    if keys is not None:
                        confirm_keys = keys
                        pre = {
                            k: merged.get_storage(tx_i.to, k)
                            for k in keys
                        }
                        original = {
                            k: merged.get_original_storage(tx_i.to, k)
                            for k in keys
                        }
                t_run = time.perf_counter()
                captured = run_captured(i, 0)
                # checked template calls run the interpreter too: the
                # residue's cost bucket
                LEDGER.record("exec.residue", HOST, 0,
                              duration=time.perf_counter() - t_run)
                if not footprint_ok(
                    pred, captured["reads"], captured["written"]
                ):
                    LEARNER.demote(code_hash)
                    raise Misprediction(
                        i, "actual footprint escaped prediction"
                    )
                stats.parallel_count += 1
                EXEC_GAUGES["checked_call_txs"] += 1
                if JOURNEY.enabled:
                    JOURNEY.record(txs[i].hash, "execute",
                                   lane="checked", index=i)
                if (confirm_keys is not None
                        and outcomes[i].error is None
                        and outcomes[i].status == 1):
                    LEARNER.confirm(
                        code_hash, senders[i], tx_i.payload,
                        tx_i.value, config.fees,
                        config.intrinsic_gas(tx_i.payload, False),
                        tx_i.gas_limit, pre,
                        {k: merged.get_storage(tx_i.to, k)
                         for k in confirm_keys},
                        original, outcomes[i].gas_used,
                    )
            else:
                fast_items.append((i, txs[i], senders[i]))
        if call_items:
            t_run = time.perf_counter()
            results = execute_call_batch(
                config, merged, call_items,
                device_validate=device_validate,
            )
            # the vectorized templated calls join the transfer batches
            # in the exec.batch cost bucket
            LEDGER.record("exec.batch", HOST, 0,
                          duration=time.perf_counter() - t_run)
            for (i, _, _, ch, _), r in zip(call_items, results):
                outcomes[i] = r
                trusted_used.add(ch)
            stats.fast_path_txs += len(call_items)
            stats.parallel_count += len(call_items)
            EXEC_GAUGES["vector_call_txs"] += len(call_items)
        if fast_items:
            t_run = time.perf_counter()
            results = execute_fast_batch(
                config, merged, fast_items,
                device_validate=device_validate,
            )
            # host-side classification event: vectorized fast-path time
            # a batch
            LEDGER.record("exec.batch", HOST, 0,
                          duration=time.perf_counter() - t_run)
            for (i, _, _), r in zip(fast_items, results):
                outcomes[i] = r
            stats.fast_path_txs += len(fast_items)
            stats.parallel_count += len(fast_items)
    post_through(len(txs))
    return merged, receipts, cumulative, trusted_used


def _run_one(
    config: EvmConfig,
    make_world: Callable[[], BlockWorldState],
    block_env: BlockEnv,
    stx: SignedTransaction,
    sender: Optional[bytes],
    index: int,
    block_gas_limit: int,
) -> Union[TxResult, TxValidationError]:
    """Parallel work unit: fresh world from the parent root
    (Ledger.scala:354), validate against the parent snapshot (the merge
    decides whether that was legitimate), execute."""
    world = make_world()
    try:
        _validate_stx(stx, sender, config, world, 0, block_gas_limit, index)
    except TxValidationError as e:
        e.world = world  # type: ignore[attr-defined]
        return e
    return execute_transaction(config, world, block_env, stx, sender)


def _execute_optimistic(
    config, block_env, txs, senders, parent_root, make_world, header,
    workers, stats: Stats,
):
    """Optimistic parallel execution + serial merge (P1,
    Ledger.scala:337-461) — the oracle the scheduled path falls back
    to on any misprediction, and the default for pre-Byzantium blocks.
    ``workers`` 1 runs the attempts on the calling thread."""
    import os

    if workers > 1 and (os.cpu_count() or 1) > 1:
        pool = _exec_pool(workers)
        futures = [
            pool.submit(
                _run_one, config, lambda: make_world(parent_root),
                block_env, txs[i], senders[i], i, header.gas_limit,
            )
            for i in range(len(txs))
        ]
        outcomes = [f.result() for f in futures]
    else:
        # one core or one worker: run the SAME optimistic attempts
        # inline (identical snapshot + merge algebra; parallel_count/
        # conflict semantics unchanged)
        outcomes = [
            _run_one(
                config, lambda: make_world(parent_root), block_env,
                txs[i], senders[i], i, header.gas_limit,
            )
            for i in range(len(txs))
        ]

    merged = make_world(parent_root)
    receipts: List[Receipt] = []
    cumulative = 0
    accumulated_gas = 0

    def re_execute(i: int) -> TxResult:
        stats.conflict_count += 1
        _validate_stx(
            txs[i], senders[i], config, merged, accumulated_gas,
            header.gas_limit, i,
        )
        return execute_transaction(
            config, merged, block_env, txs[i], senders[i]
        )

    for i, out in enumerate(outcomes):
        if isinstance(out, TxValidationError):
            if _reads_conflict(merged, out.world) is None:
                raise out  # invalid against true sequential state too
            r = re_execute(i)  # stale snapshot — retry on merged world
            merged = r.world
        else:
            # the parallel pass validated with accumulated_gas=0 — the
            # cumulative block-gas rule (YP eq. 58) must be re-checked
            # against the true running total before accepting the merge
            if accumulated_gas + txs[i].tx.gas_limit > header.gas_limit:
                raise TxValidationError(
                    i, "cumulative gas above block limit"
                )
            conflict = merged.merge(out.world)
            if conflict is None:
                stats.parallel_count += 1
                r = out
            else:
                r = re_execute(i)
                merged = r.world
        accumulated_gas += r.gas_used
        cumulative = _tx_post(
            config, merged, r, header.beneficiary, cumulative, receipts
        )
    return merged, receipts, cumulative


def _reads_conflict(merged: BlockWorldState, tx_world) -> Optional[Set]:
    """Did tx_world read anything merged has written? None = no."""
    conflicts: Set = set()
    for cat in tx_world.reads:
        conflicts |= tx_world.reads[cat] & merged.written[cat]
    return conflicts or None


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
