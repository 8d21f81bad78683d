"""Vectorized fast-path executor for a predicted-disjoint transfer batch.

One scheduled batch of plain value transfers (schedule.FAST) executes
as a single gather -> validate -> update -> scatter pass over account
rows instead of N trips through the interpreter:

* gather   — sender nonce/balance rows out of the merged world (these
  go through get_nonce/get_balance so the emptiness/nonce observations
  stay RECORDED reads, same as the interpreter's validation probe);
* validate — one vectorized numpy pass: nonce equality plus a 256-bit
  limb-lexicographic balance >= upfront compare across the whole batch
  (uint64×4 big-endian limbs), or, with ``sync.exec_device``, the
  same compare as one launch of the row validation kernel
  (``trie/fused.py::fused_exec_validate``, K6 on the card);
* scatter  — per-row deltas applied through the world's commutative
  API (increase_nonce / add_balance), preserving the exact write-log,
  delta, and creation-mark bookkeeping the serial interpreter produces.

Bit-exactness contract (pinned by the oracle sweep in tests): for a
plain transfer — ``to`` has empty code and is not a precompile,
``payload == b""``, ``value > 0``, ``sender != to`` — the interpreter
reduces to: nonce+1, sender -(value + 21000*gas_price), recipient
+value, gas_used = intrinsic = 21000, full gas refund, status 1, no
logs. Its EIP-161 sweep can never delete here (the sender ends with
nonce >= 1, the recipient with balance > 0), so the sweep + touch +
clear sequence is a provable no-op and is elided.

The scheduler only promises DISJOINTNESS, not validity: any
validation failure raises TxValidationError and any broken
precondition (code appeared at ``to`` mid-block via an internal
CREATE, out-of-range field) raises schedule.Misprediction — in both
cases the caller discards the scheduled attempt and re-runs the whole
block on the optimistic path, which owns the authoritative error.

``fault_point("ledger.batch")`` fires per row inside the scatter loop
so chaos tests can kill the process mid-batch: the half-scattered
world is memory-only and dies with the driver; recovery re-executes
the block from the journal serially, bit-exact.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from khipu_tpu_torch.base.secp256k1 import HALF_N
from khipu_tpu_torch.chaos.plan import fault_point
from khipu_tpu_torch.domain.account import EMPTY_CODE_HASH
from khipu_tpu_torch.ledger.schedule import Misprediction
from khipu_tpu_torch.observability.journey import JOURNEY

_U64 = (1 << 64) - 1
_U256 = 1 << 256


def _limbs(values: List[int]) -> np.ndarray:
    """(n, 4) uint64 big-endian limb rows of 256-bit values."""
    out = np.empty((len(values), 4), dtype=np.uint64)
    for i, v in enumerate(values):
        out[i, 0] = (v >> 192) & _U64
        out[i, 1] = (v >> 128) & _U64
        out[i, 2] = (v >> 64) & _U64
        out[i, 3] = v & _U64
    return out


def _ge_limbs(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Vectorized lexicographic a >= b over (n, 4) big-endian limbs."""
    ge = np.zeros(len(a), dtype=bool)
    decided = np.zeros(len(a), dtype=bool)
    for j in range(4):
        gt = a[:, j] > b[:, j]
        lt = a[:, j] < b[:, j]
        ge |= ~decided & gt
        decided |= gt | lt
    return ge | ~decided  # undecided after 4 limbs == equal


# ---- shared gather -> validate skeleton (used by batch_call too) ----


def check_tx_scalars(config, index: int, stx, intrinsic: int) -> None:
    """Scalar signature/intrinsic validation for one batched tx —
    the non-row-data prefix of _validate_stx, shared by the transfer
    and templated-call batch executors."""
    from khipu_tpu_torch.ledger.ledger import TxValidationError

    tx = stx.tx
    if config.homestead and stx.s > HALF_N:
        raise TxValidationError(index, "high s (EIP-2)")
    cid = stx.chain_id
    if cid is not None:
        if not config.eip155:
            raise TxValidationError(index, "EIP-155 v before fork")
        if cid != config.chain_id:
            raise TxValidationError(index, f"wrong chain id {cid}")
    if tx.gas_limit < intrinsic:
        raise TxValidationError(
            index, f"gas limit {tx.gas_limit} < intrinsic {intrinsic}"
        )


def gather_validate_rows(world, rows, device_validate=None) -> None:
    """Gather every sender's nonce/balance row out of ``world``
    (recorded reads, same as the interpreter's validation probe) and
    validate the whole batch in one vectorized pass: nonce equality
    plus the 256-bit limb-lexicographic balance >= upfront compare.

    ``rows`` is [(tx_index, stx, sender, upfront), ...]. When
    ``device_validate`` is given (``trie/fused.py::fused_exec_validate``
    on the replay's device, gated by ``adaptive.exec_device_allowed``),
    the compare runs there and the host numpy pass does not run: an
    error from it propagates and stops the block. Without it, the host
    numpy pass decides.
    """
    from khipu_tpu_torch.ledger.ledger import TxValidationError

    tx_nonces = []
    acct_nonces = []
    balances = []
    upfronts = []
    for index, stx, sender, upfront in rows:
        tx = stx.tx
        nonce = world.get_nonce(sender)
        balance = world.get_balance(sender)
        if (tx.nonce > _U64 or nonce > _U64 or balance >= _U256
                or upfront >= _U256):
            raise Misprediction(index, "field exceeds device row width")
        tx_nonces.append(tx.nonce)
        acct_nonces.append(nonce)
        balances.append(balance)
        upfronts.append(upfront)

    if device_validate is not None:
        ok = np.asarray(device_validate(
            tx_nonces, acct_nonces, balances, upfronts
        ), dtype=bool)
    else:
        nonce_ok = np.array(tx_nonces, dtype=np.uint64) == np.array(
            acct_nonces, dtype=np.uint64
        )
        balance_ok = _ge_limbs(_limbs(balances), _limbs(upfronts))
        ok = nonce_ok & balance_ok
    if not bool(ok.all()):
        i = int(np.argmin(ok))
        index, stx, _, _ = rows[i]
        if stx.tx.nonce != acct_nonces[i]:
            raise TxValidationError(
                index,
                f"nonce {stx.tx.nonce} != account {acct_nonces[i]}",
            )
        raise TxValidationError(
            index,
            f"balance {balances[i]} < upfront {upfronts[i]}",
        )


def execute_fast_batch(
    config, world, items: Sequence[Tuple[int, object, bytes]],
    device_validate=None,
) -> List["TxResult"]:
    """Execute one disjoint batch of plain transfers against ``world``
    (the block's merged world — mutated in place). ``items`` is
    [(tx_index, stx, sender), ...]; results come back in batch order
    with world=``world`` (the batch shares it, like the serial fold).
    """
    from khipu_tpu_torch.ledger.ledger import TxResult

    intrinsic = config.intrinsic_gas(b"", False)

    # ---- scalar signature/intrinsic checks (cheap, non-row data)
    for index, stx, sender in items:
        check_tx_scalars(config, index, stx, intrinsic)
        # the planner probed the PARENT state for code; an internal
        # CREATE earlier this block can deposit code mid-chain — the
        # merged world is the authority
        if world.get_code_hash(stx.tx.to) != EMPTY_CODE_HASH:
            raise Misprediction(index, "code appeared at transfer target")

    # ---- gather + validate: one vectorized pass over the whole batch
    gather_validate_rows(world, [
        (index, stx, sender,
         stx.tx.gas_limit * stx.tx.gas_price + stx.tx.value)
        for index, stx, sender in items
    ], device_validate=device_validate)

    # ---- scatter: per-row commutative deltas (exact interpreter net
    # effect: nonce+1, sender -(value + gas*price), recipient +value)
    results: List[TxResult] = []
    for index, stx, sender in items:
        fault_point("ledger.batch")
        tx = stx.tx
        fee = intrinsic * tx.gas_price
        world.increase_nonce(sender)
        world.add_balance(sender, -(tx.value + fee))
        world.add_balance(tx.to, tx.value)
        results.append(
            TxResult(world, intrinsic, fee, [], 1, None)
        )
    # the elided EIP-161 sweep's ONLY residual obligation: drop this
    # batch's touch marks, like execute_transaction's end-of-tx clear —
    # a stale mark would leak into the NEXT interpreter tx's sweep,
    # whose get_account probes would then escape that tx's predicted
    # footprint
    world.touched.clear()
    if JOURNEY.enabled:
        for index, stx, _sender in items:
            JOURNEY.record(stx.hash, "execute",
                           lane="vector-transfer", index=index)
    return results
