"""Vectorized executor for a disjoint batch of TRUSTED templated calls.

The second half of the execute fast path: where batch_exec.py turns a
batch of plain transfers into one gather -> validate -> scatter pass,
this module does the same for ERC-20-shaped contract calls whose code
hash earned the TRUSTED lane in schedule.TemplateLearner — bytecode
that passed the static purity scan (straight-line, whitelisted,
provably constant non-SSTORE gas) and whose per-slot storage effects
survived TRUST_AFTER checked interpreter confirmations, including an
exact gas cross-check. For such a call the interpreter's entire net
effect is a closed form over (sender, calldata, gathered slot values):

* slot keys   — the template's write rules, with every mapping-form
  keccak already precomputed by plan_block's single native
  keccak256_batch call (the per-call hash cost collapses into one
  batched crossing per block);
* new values  — the learned effect (``old ± arg_i`` / ``arg_i`` /
  ``old + c`` / ``c``, mod 2^256) applied to the gathered current
  value;
* gas_used    — schedule.predict_call_gas: the scan's static gas plus
  EIP-2200 SSTORE dynamics recomputed from (original, current, new)
  per slot, refund cap and all — bit-exact against vm._op_sstore;
* account net — nonce+1, sender -(gas_used * gas_price); trusted
  templates are value-0 only, so there is no value transfer, the
  EIP-161 sweep is a provable no-op (the target carries code, the
  sender ends with nonce >= 1), and logs are empty (LOG opcodes are
  not in the purity whitelist).

The scheduler guarantees DISJOINTNESS (same-sender and same-slot
calls land in different batches), so gathering every row before
scattering any delta is exact. Everything else is a PRECONDITION the
merged world must still witness: the code hash unchanged mid-block,
every write rule resolvable and collision-free for THIS calldata, the
effect's argument present, and a gas limit clearing the EIP-2200
sentry margin. Any miss raises schedule.Misprediction and the caller
re-runs the whole block on the optimistic path — correctness never
depends on the template being right, and the header oracle
(_validate_after) backstops the whole lane by demoting every trusted
template used in a block whose root comes out wrong.

``fault_point("ledger.batch")`` fires per row in the scatter loop,
same as the transfer batch: a mid-batch crash leaves only a
memory-only world that dies with the driver.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from khipu_tpu_torch.chaos.plan import fault_point
from khipu_tpu_torch.observability.journey import JOURNEY
from khipu_tpu_torch.ledger.batch_exec import (
    check_tx_scalars,
    gather_validate_rows,
)
from khipu_tpu_torch.ledger.schedule import (
    Misprediction,
    _apply_rule,
    _arg_words,
    apply_effect,
    predict_call_gas,
)


def execute_call_batch(
    config, world, items: Sequence[Tuple[int, object, bytes, bytes, object]],
    device_validate=None,
) -> List["TxResult"]:
    """Execute one disjoint batch of trusted templated calls against
    ``world`` (the block's merged world — mutated in place). ``items``
    is [(tx_index, stx, sender, code_hash, template), ...] from
    plan.trusted; results come back in batch order.
    """
    from khipu_tpu_torch.ledger.ledger import TxResult

    fees = config.fees
    rows = []  # (index, stx, sender, upfront) for the shared validator
    staged = []  # (gas_used, [(slot_key, current, new), ...]) per item

    # ---- gather: resolve slot keys, current/original values, learned
    # effects, and the exact gas prediction for every call
    for index, stx, sender, code_hash, tpl in items:
        tx = stx.tx
        intrinsic = config.intrinsic_gas(tx.payload, False)
        check_tx_scalars(config, index, stx, intrinsic)
        if tx.value != 0:
            # trusted_for() refuses value calls at plan time; a value
            # here means the routing snapshot is stale
            raise Misprediction(index, "value call in trusted lane")
        if world.get_code_hash(tx.to) != code_hash:
            raise Misprediction(index, "code changed at call target")
        sender_i = int.from_bytes(sender, "big")
        args = _arg_words(tx.payload)
        writes: List[Tuple[int, int, int]] = []
        slot_rows: List[Tuple[int, int, int]] = []
        seen_keys = set()
        for rule, cands in zip(tpl.write_rules, tpl.effects):
            key = _apply_rule(rule, sender_i, args)
            if key is None:
                raise Misprediction(index, "write rule unresolvable")
            if key in seen_keys:
                # two write rules collapsed onto one slot for THIS
                # calldata — the learned per-rule effects don't compose
                raise Misprediction(index, "write rules collide in one tx")
            seen_keys.add(key)
            current = world.get_storage(tx.to, key)
            original = world.get_original_storage(tx.to, key)
            new = apply_effect(cands[0], current, args)
            if new is None:
                raise Misprediction(index, "effect argument missing")
            slot_rows.append((original, current, new))
            writes.append((key, current, new))
        gas_used = predict_call_gas(
            tpl.scan, fees, intrinsic, tx.gas_limit, slot_rows
        )
        if gas_used is None:
            raise Misprediction(index, "gas limit inside the sentry margin")
        rows.append((index, stx, sender, tx.gas_limit * tx.gas_price))
        staged.append((gas_used, writes))

    # ---- validate: one vectorized nonce/balance pass (host numpy or,
    # with sync.exec_device, the row validation kernel)
    gather_validate_rows(world, rows, device_validate=device_validate)

    # ---- scatter: per-row commutative deltas + net storage writes
    # (exact interpreter net effect: nonce+1, sender -gas_used*price,
    # SSTORE only where the value actually changes — the EIP-2200 noop
    # path never calls save_storage)
    results: List[TxResult] = []
    for (index, stx, sender, _ch, _tpl), (gas_used, writes) in zip(
            items, staged):
        fault_point("ledger.batch")
        tx = stx.tx
        fee = gas_used * tx.gas_price
        world.increase_nonce(sender)
        world.add_balance(sender, -fee)
        for key, current, new in writes:
            if new != current:
                world.save_storage(tx.to, key, new)
        results.append(TxResult(world, gas_used, fee, [], 1, None))
    # end-of-batch touched clear, mirroring execute_transaction's
    # end-of-tx clear: the elided EIP-161 sweep is a proven no-op, but
    # a stale touch mark would surface in the NEXT interpreter tx's
    # sweep as an out-of-footprint account read
    world.touched.clear()
    if JOURNEY.enabled:
        for index, stx, _sender, _ch, _tpl in items:
            JOURNEY.record(stx.hash, "execute",
                           lane="vector-call", index=index)
    return results
