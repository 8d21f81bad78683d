"""Conflict-aware static transaction scheduling (the execute stage).

The paper's first research claim — ~80% of a block's transactions
execute in parallel — was reproduced only structurally by the
optimistic path (ledger._execute_optimistic): every tx runs against a
parent-root snapshot and conflicts are discovered AFTER the fact, in
the serial merge. This module inverts that: predict each tx's
read/write footprint BEFORE execution, pack predicted-disjoint txs
into maximal batches via greedy precedence-respecting coloring, and
route everything unpredictable to a serial residue. Batches then
execute with zero merge conflicts BY CONSTRUCTION (the fast path
skips the snapshot+merge machinery entirely); a post-hoc comparison
of actual vs predicted touched sets catches every misprediction and
falls the whole block back to the optimistic path — correctness never
depends on a prediction being right (Block-STM-style scheduled OCC,
but scheduling conflicts away up front instead of aborting into
them).

Footprint algebra (mirrors the world's merge categories):

* ``acct_r``  — account-state reads (nonce/balance/existence). The
  validation nonce+balance probe and the EIP-161 emptiness sweep.
* ``acct_w``  — ABSOLUTE account writes (save/delete). Predicted tx
  shapes never produce these; anything that would is residue.
* ``acct_d``  — commutative delta writes (add_balance /
  increase_nonce). D∩D overlaps are NOT conflicts — two credits to
  one address commute exactly, the same rule the optimistic merge
  applies (world.add_balance records no read).
* ``slots``   — (address, key) storage cells, treated read+write
  (SSTORE is last-writer, never commutative).
* ``code_r``  — code reads. Nothing in predicted-land writes code
  (creations are residue barriers), so code reads never conflict;
  the set only participates in the misprediction ⊆ check.

Two predicted txs conflict when a read meets a write/delta, a write
meets anything, or storage slots intersect. Conflicting pairs keep
index order (a later conflicting tx is assigned a strictly greater
batch), so every non-commutative effect is applied in sequential
order and everything else commutes — the scheduled block is bit-exact
against the serial fold.

ERC-20-style calls are predicted by a per-code-hash TEMPLATE LEARNER:
the first call to an unknown code hash runs in the residue with its
footprint captured; every observed storage slot must derive from the
tx's own fields (int(sender), int(arg_i), a small literal slot, or
the Solidity mapping form keccak(pad32(x) ++ pad32(k))) for the code
hash to earn a template. Underivable slots (state-dependent indexing)
mark the hash OPAQUE — permanently residue. A template whose
prediction a later tx violates is demoted to opaque and the block
falls back.

Templated calls graduate through a three-phase trust protocol:

  unknown ──observe──▶ template (checked) ──confirm×N──▶ trusted
     │                     │
     └──underivable──▶ opaque ◀──footprint escape (demote)──┘

* CHECKED — the call still runs the interpreter, its actual footprint
  is verified (⊆) against the prediction, and each run teaches the
  learner the call's storage EFFECTS: for every written slot, the set
  of effect forms (``new = old ± arg_i`` / ``arg_i`` / ``old + c`` /
  ``c``, mod 2^256) consistent with ALL observations so far, plus an
  exact gas prediction cross-checked against the interpreter's actual
  gas_used. Candidate elimination across observations converges on
  the true effect; any inconsistency permanently pins the template to
  the checked lane (still parallel, never vectorized — no
  oscillation).
* TRUSTED — after ``TRUST_AFTER`` consecutive exact confirmations and
  a successful static purity scan of the bytecode (straight-line,
  whitelisted opcodes, provably constant non-SSTORE gas), a disjoint
  batch of calls executes as ONE vectorized pass in
  ledger/batch_call.py: derived slot keys from one native
  keccak256_batch call, gathered slot/balance rows, vectorized
  precondition validation, net storage deltas + EIP-2200 gas applied
  bit-exactly. The ``_validate_after`` header oracle backstops the
  whole scheme: a trusted template that ever produces a wrong root
  demotes and the block re-runs optimistically.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from khipu_tpu_torch.base.keccak import keccak256
from khipu_tpu_torch.domain.account import EMPTY_CODE_HASH
from khipu_tpu_torch.domain.transaction import contract_address
from khipu_tpu_torch.ledger.world import (
    ON_ACCOUNT,
    ON_ADDRESS,
    ON_CODE,
    ON_STORAGE,
)
from khipu_tpu_torch.observability.journey import JOURNEY
from khipu_tpu_torch.observability.registry import REGISTRY

# one registry family for the whole execute stage (the port's own
# registry: nothing here shares or resets a gauge of the JAX package)
EXEC_GAUGES = REGISTRY.gauge_group("khipu_exec_batch", {
    "planned_blocks": 0,
    "fast_txs": 0,
    "call_txs": 0,
    "residue_txs": 0,
    "batches": 0,
    "max_batch_width": 0,
    "mispredictions": 0,
    "fallbacks": 0,
    "templates": 0,
    "opaque_codes": 0,
    "vector_call_txs": 0,  # trusted templated calls, vectorized
    "checked_call_txs": 0,  # templated calls still interpreter-run
    "trusted_templates": 0,  # templates promoted to the trusted lane
    "effect_retirements": 0,  # templates pinned to checked forever
}, help="conflict-aware execute-stage scheduler (ledger/schedule.py)")


class Misprediction(Exception):
    """A predicted tx touched state outside its predicted footprint —
    the scheduled execution is discarded and the block re-runs on the
    optimistic path (which never trusts predictions)."""

    def __init__(self, index: int, detail: str):
        super().__init__(f"tx[{index}]: {detail}")
        self.index = index
        self.detail = detail


# classification kinds
FAST = "fast"  # plain value transfer -> vectorized batch executor
CALL = "call"  # learned template call -> interpreter, footprint-checked
RESIDUE = "residue"  # serial barrier on the merged world

# precompile / reserved address range routed to the residue: precompile
# dispatch keys on code_address, so a "plain transfer" to 0x01..0x09
# actually runs a precompile
_RESERVED_ADDR_MAX = 0xFFFF



@dataclass(frozen=True)
class Predicted:
    """A tx's predicted footprint in the conflict algebra above."""

    kind: str
    acct_r: frozenset
    acct_d: frozenset
    slots: frozenset  # of (address, key) — read+write
    code_r: frozenset
    acct_w: frozenset = frozenset()


@dataclass
class Step:
    kind: str  # "batch" | "residue"
    indices: List[int]


@dataclass
class Plan:
    steps: List[Step] = field(default_factory=list)
    predicted: Dict[int, Predicted] = field(default_factory=dict)
    # tx index -> (code_hash, Template) for calls whose template earned
    # the TRUSTED lane at plan time (snapshot — mid-block confirmations
    # never change a block's own routing, so replay is deterministic)
    trusted: Dict[int, tuple] = field(default_factory=dict)
    n_fast: int = 0
    n_call: int = 0
    n_residue: int = 0
    conflicted: int = 0  # predicted txs pushed past batch 0 by an edge
    max_width: int = 0


# ----------------------------------------------------- template learner


_OPAQUE = "opaque"

U256 = 1 << 256

# checked-interpreter confirmations (footprint + effects + exact gas)
# required before a template's calls may execute vectorized
TRUST_AFTER = 2


# --------------------------------------------------- static purity scan
#
# A template is only TRUSTABLE when its bytecode provably reduces to a
# straight-line sequence of whitelisted opcodes: no control flow, no
# calls/creates/logs/env reads, every memory offset a compile-time
# constant. Such a program always runs to STOP, touches storage through
# a statically known number of SSTOREs, and burns a statically known
# amount of non-SSTORE gas — exactly what the vectorized executor needs
# to reproduce the interpreter bit-for-bit (EIP-2200's SSTORE dynamic
# costs are recomputed per call from the gathered slot values).

_DYN = None  # stack sentinel: value unknown at scan time

# binops: opcode -> (fee attr, fold fn or None); fold fns are copied
# verbatim from vm._build_table so constant folding can never disagree
# with the interpreter
_SCAN_BINOPS: Dict[int, tuple] = {
    0x01: ("G_verylow", lambda a, b: (a + b) % U256),
    0x02: ("G_low", lambda a, b: (a * b) % U256),
    0x03: ("G_verylow", lambda a, b: (a - b) % U256),
    0x04: ("G_low", lambda a, b: a // b if b else 0),
    0x05: ("G_low", None),  # SDIV
    0x06: ("G_low", lambda a, b: a % b if b else 0),
    0x07: ("G_low", None),  # SMOD
    0x0B: ("G_low", None),  # SIGNEXTEND
    0x10: ("G_verylow", lambda a, b: 1 if a < b else 0),
    0x11: ("G_verylow", lambda a, b: 1 if a > b else 0),
    0x12: ("G_verylow", None),  # SLT
    0x13: ("G_verylow", None),  # SGT
    0x14: ("G_verylow", lambda a, b: 1 if a == b else 0),
    0x16: ("G_verylow", lambda a, b: a & b),
    0x17: ("G_verylow", lambda a, b: a | b),
    0x18: ("G_verylow", lambda a, b: a ^ b),
    0x1A: ("G_verylow", None),  # BYTE
    0x1B: ("G_verylow", lambda s, x: (x << s) % U256 if s < 256 else 0),
    0x1C: ("G_verylow", lambda s, x: x >> s if s < 256 else 0),
    0x1D: ("G_verylow", None),  # SAR
}

# zero-pop environment reads whose VALUE is fixed for a given
# (code, sender, args, value) — block-context reads (NUMBER, TIMESTAMP,
# COINBASE, ...) are deliberately absent: they'd make learned effects
# block-dependent
_SCAN_ENV = {
    0x30: "G_base",  # ADDRESS
    0x32: "G_base",  # ORIGIN
    0x33: "G_base",  # CALLER
    0x34: "G_base",  # CALLVALUE
    0x36: "G_base",  # CALLDATASIZE
    0x38: "G_base",  # CODESIZE
    0x3A: "G_base",  # GASPRICE
}

_SCAN_MAX_CODE = 4096
_SCAN_MAX_STACK = 1024


@dataclass(frozen=True)
class PureScan:
    """Static gas profile of a straight-line whitelisted program."""

    gas_counts: Tuple[Tuple[str, int], ...]  # (FeeSchedule attr, count)
    extra_gas: int  # constant non-attr gas (EXP byte terms)
    mem_steps: Tuple[Tuple[int, int], ...]  # (words before, words after)
    n_sstores: int


def scan_pure_code(code: bytes) -> Optional[PureScan]:
    """Prove ``code`` straight-line + whitelisted, or return None.

    Runs a const-tracking stack simulation: PUSH immediates and
    constant arithmetic stay exact ints on the scan stack (so memory
    offsets, SHA3 sizes, and EXP exponents can be proven constant);
    anything data-dependent becomes the _DYN sentinel. Every gas
    charge the interpreter would make — except SSTORE's EIP-2200
    dynamic cost — is accumulated statically."""
    if not code or len(code) > _SCAN_MAX_CODE:
        return None
    stack: List[Optional[int]] = []
    counts: Dict[str, int] = {}
    mem_steps: List[Tuple[int, int]] = []
    words = 0
    extra = 0
    n_sstores = 0

    def charge(attr: str) -> None:
        counts[attr] = counts.get(attr, 0) + 1

    def mem(off: int, size: int) -> None:
        nonlocal words
        if size == 0:
            return
        nw = (off + size + 31) // 32
        if nw > words:
            mem_steps.append((words, nw))
            words = nw

    def pop() -> Optional[int]:
        return stack.pop()

    pc, n = 0, len(code)
    while pc < n:
        op = code[pc]
        if len(stack) > _SCAN_MAX_STACK:
            return None
        try:
            if op == 0x00:  # STOP (G_zero == 0)
                break
            if 0x60 <= op <= 0x7F:  # PUSH1..32 (slice zero-pads)
                width = op - 0x5F
                imm = code[pc + 1:pc + 1 + width]
                stack.append(
                    int.from_bytes(imm + b"\x00" * (width - len(imm)),
                                   "big"))
                charge("G_verylow")
                pc += 1 + width
                continue
            if 0x80 <= op <= 0x8F:  # DUP1..16
                stack.append(stack[-(op - 0x7F)])
                charge("G_verylow")
            elif 0x90 <= op <= 0x9F:  # SWAP1..16
                d = op - 0x8F
                stack[-1], stack[-1 - d] = stack[-1 - d], stack[-1]
                charge("G_verylow")
            elif op in _SCAN_BINOPS:
                attr, fn = _SCAN_BINOPS[op]
                a, b = pop(), pop()
                stack.append(
                    fn(a, b)
                    if fn is not None and a is not None and b is not None
                    else _DYN)
                charge(attr)
            elif op in (0x08, 0x09):  # ADDMOD / MULMOD
                a, b, m = pop(), pop(), pop()
                if None in (a, b, m):
                    stack.append(_DYN)
                elif op == 0x08:
                    stack.append((a + b) % m if m else 0)
                else:
                    stack.append((a * b) % m if m else 0)
                charge("G_mid")
            elif op == 0x0A:  # EXP — gas needs a constant exponent
                a, e = pop(), pop()
                if e is None:
                    return None
                charge("G_exp")
                nbytes = (e.bit_length() + 7) // 8
                extra_attr = ("G_expbyte", nbytes)
                counts[extra_attr[0]] = (
                    counts.get(extra_attr[0], 0) + nbytes)
                stack.append(
                    pow(a, e, U256) if a is not None else _DYN)
            elif op == 0x15:  # ISZERO
                a = pop()
                stack.append(_DYN if a is None else (1 if a == 0 else 0))
                charge("G_verylow")
            elif op == 0x19:  # NOT
                a = pop()
                stack.append(_DYN if a is None else a ^ (U256 - 1))
                charge("G_verylow")
            elif op == 0x20:  # SHA3 — constant offset+size only
                off, size = pop(), pop()
                if off is None or size is None:
                    return None
                charge("G_sha3")
                counts["G_sha3word"] = (
                    counts.get("G_sha3word", 0) + (size + 31) // 32)
                mem(off, size)
                stack.append(_DYN)
            elif op in _SCAN_ENV:
                charge(_SCAN_ENV[op])
                stack.append(_DYN)
            elif op == 0x35:  # CALLDATALOAD (flat gas, any offset)
                pop()
                stack.append(_DYN)
                charge("G_verylow")
            elif op == 0x50:  # POP
                pop()
                charge("G_base")
            elif op == 0x51:  # MLOAD — constant offset only
                off = pop()
                if off is None:
                    return None
                mem(off, 32)
                stack.append(_DYN)
                charge("G_verylow")
            elif op in (0x52, 0x53):  # MSTORE / MSTORE8
                off, _val = pop(), pop()
                if off is None:
                    return None
                mem(off, 32 if op == 0x52 else 1)
                charge("G_verylow")
            elif op == 0x54:  # SLOAD
                pop()
                stack.append(_DYN)
                charge("G_sload")
            elif op == 0x55:  # SSTORE — dynamic cost, counted
                pop()
                pop()
                n_sstores += 1
            elif op == 0x5B:  # JUMPDEST (inert without jumps)
                charge("G_jumpdest")
            else:
                return None  # control flow / calls / logs / env: impure
        except IndexError:
            return None  # stack underflow — interpreter would error
        pc += 1
    return PureScan(
        gas_counts=tuple(sorted(counts.items())),
        extra_gas=extra,
        mem_steps=tuple(mem_steps),
        n_sstores=n_sstores,
    )


def scan_static_gas(scan: PureScan, fees) -> int:
    """Non-SSTORE execution gas of one run, under ``fees``."""
    from khipu_tpu_torch.evm.memory import memory_cost

    gas = scan.extra_gas
    for attr, count in scan.gas_counts:
        gas += getattr(fees, attr) * count
    g = fees.G_memory
    for before, after in scan.mem_steps:
        gas += memory_cost(after, g) - memory_cost(before, g)
    return gas


def predict_call_gas(
    scan: PureScan, fees, intrinsic: int, gas_limit: int,
    slot_rows: Sequence[Tuple[int, int, int]],
) -> Optional[int]:
    """Exact gas_used of one templated call, or None when the gas
    envelope can't be proven (too close to OOG / the EIP-2200 sentry).

    ``slot_rows`` is one (original, current, new) triple per SSTORE —
    the write rules resolved against the gathered world state. Gas and
    refunds replicate vm._op_sstore's Istanbul metering exactly; the
    refund cap and the final gas_used mirror execute_transaction."""
    exec_gas = scan_static_gas(scan, fees)
    refund = 0
    for original, current, new in slot_rows:
        if new == current:
            exec_gas += fees.G_sstore_noop
        elif original == current:
            if original == 0:
                exec_gas += fees.G_sstore_init
            else:
                exec_gas += fees.G_sstore_clean
                if new == 0:
                    refund += fees.R_sclear
        else:
            exec_gas += fees.G_sstore_noop
            if original != 0:
                if current == 0:
                    refund -= fees.R_sclear
                if new == 0:
                    refund += fees.R_sclear
            if original == new:
                if original == 0:
                    refund += fees.G_sstore_init - fees.G_sstore_noop
                else:
                    refund += fees.G_sstore_clean - fees.G_sstore_noop
    gas_pre = intrinsic + exec_gas
    # conservative sentry/OOG margin: remaining gas after ALL exec
    # charges must still clear the EIP-2200 sentry, so no SSTORE can
    # trip it and the frame can never run dry mid-program
    if gas_limit - gas_pre <= fees.G_sstore_sentry:
        return None
    refund_capped = min(max(refund, 0), gas_pre // 2)
    return gas_pre - refund_capped


# ------------------------------------------------------- effect algebra


def _effect_candidates(old: int, new: int,
                       args: Sequence[Optional[int]]) -> List[tuple]:
    """Every effect form consistent with one (old -> new) observation,
    in preference order (arg-parameterized before constant forms, so
    candidate elimination converges on the general rule)."""
    out: List[tuple] = []
    for i, a in enumerate(args):
        if a is not None and new == (old + a) % U256:
            out.append(("old_add_arg", i))
    for i, a in enumerate(args):
        if a is not None and new == (old - a) % U256:
            out.append(("old_sub_arg", i))
    for i, a in enumerate(args):
        if a is not None and new == a:
            out.append(("arg", i))
    out.append(("old_add_const", (new - old) % U256))
    out.append(("const", new))
    return out


def apply_effect(eff: tuple, old: int,
                 args: Sequence[Optional[int]]) -> Optional[int]:
    """New slot value under ``eff``, or None when an arg is absent."""
    tag = eff[0]
    if tag == "old_add_const":
        return (old + eff[1]) % U256
    if tag == "const":
        return eff[1]
    i = eff[1]
    if i >= len(args) or args[i] is None:
        return None
    if tag == "old_add_arg":
        return (old + args[i]) % U256
    if tag == "old_sub_arg":
        return (old - args[i]) % U256
    return args[i]  # "arg"


def _effect_matches(eff: tuple, old: int, new: int,
                    args: Sequence[Optional[int]]) -> bool:
    return apply_effect(eff, old, args) == new


# ------------------------------------------------- slot derivation rules


@dataclass(frozen=True)
class Template:
    """Slot derivation rules + learned effects for one code hash.

    ``rules`` reproduce every predicted slot from the CALLING tx's own
    fields. ``write_rules`` is the subset carrying storage writes; once
    ``effects`` (per-write-rule candidate lists) survive TRUST_AFTER
    checked confirmations and the bytecode passed the purity scan, the
    template is TRUSTED and its calls execute vectorized."""

    rules: Tuple[tuple, ...]
    write_rules: Tuple[tuple, ...] = ()
    effects: Optional[Tuple[Tuple[tuple, ...], ...]] = None
    confirmations: int = 0
    scan: Optional[PureScan] = None
    vectorizable: bool = True  # False pins the template to checked

    def trusted_for(self, value: int,
                    args: Sequence[Optional[int]]) -> bool:
        """May a call with this (value, args) take the vectorized lane?"""
        if (not self.vectorizable or self.scan is None
                or self.confirmations < TRUST_AFTER or value != 0
                or self.effects is None
                or self.scan.n_sstores != len(self.write_rules)):
            return False
        for cands in self.effects:
            if not cands or apply_effect(cands[0], 0, args) is None:
                return False
        return True


def _pad32(v: int) -> bytes:
    return v.to_bytes(32, "big")


_ARG_LIMIT = 8  # words probed per framing (raw + ABI selector-skipped)


def _arg_words(payload: bytes,
               limit: int = _ARG_LIMIT) -> List[Optional[int]]:
    """Calldata as CALLDATALOAD-style 32-byte words (zero right-pad)
    under two framings: indices [0, limit) read from offset 0 (raw
    word-aligned payloads, the fixture convention) and indices
    [limit, 2*limit) from offset 4 (ABI calldata behind a function
    selector). Indices the payload doesn't cover are None — a rule
    referencing one is unpredictable for that tx (matches the old
    length-truncated behavior exactly for the raw framing)."""
    args: List[Optional[int]] = [None] * (2 * limit)
    for i in range(min(limit, (len(payload) + 31) // 32)):
        args[i] = int.from_bytes(
            payload[32 * i:32 * i + 32].ljust(32, b"\x00"), "big")
    if len(payload) > 4:
        abi = payload[4:]
        for i in range(min(limit, (len(abi) + 31) // 32)):
            args[limit + i] = int.from_bytes(
                abi[32 * i:32 * i + 32].ljust(32, b"\x00"), "big")
    return args


_MAP_SLOTS = 4  # mapping base slots probed for the keccak derivation
_CONST_SLOT_MAX = 0x10000  # literal-slot rule ceiling (Solidity value
# slots are tiny literals; real derived keys are ~uniform 256-bit)


def _derive_rules(slot: int, sender_i: int,
                  args: Sequence[Optional[int]]) -> List[tuple]:
    """Every derivation rule that reproduces ``slot`` from this tx."""
    rules = []
    if slot == sender_i:
        rules.append(("caller",))
    for i, a in enumerate(args):
        if a is not None and slot == a:
            rules.append(("arg", i))
    for k in range(_MAP_SLOTS):
        if slot == int.from_bytes(
                keccak256(_pad32(sender_i) + _pad32(k)), "big"):
            rules.append(("map_caller", k))
    for i, a in enumerate(args):
        if a is None:
            continue
        for k in range(_MAP_SLOTS):
            if slot == int.from_bytes(
                    keccak256(_pad32(a) + _pad32(k)), "big"):
                rules.append(("map_arg", i, k))
    if slot < _CONST_SLOT_MAX:
        rules.append(("const", slot))
    return rules


def _apply_rule(rule: tuple, sender_i: int,
                args: Sequence[Optional[int]],
                keccak_memo: Optional[Dict[bytes, bytes]] = None,
                ) -> Optional[int]:
    """Predicted slot key for one rule, or None when an arg index is
    absent from this calldata. ``keccak_memo`` (preimage -> digest)
    lets plan_block precompute every mapping key of a block in ONE
    native keccak256_batch call."""
    tag = rule[0]
    if tag == "caller":
        return sender_i
    if tag == "const":
        return rule[1]
    if tag == "arg":
        i = rule[1]
        if i >= len(args) or args[i] is None:
            return None
        return args[i]
    if tag == "map_caller":
        pre = _pad32(sender_i) + _pad32(rule[1])
    else:  # map_arg
        i = rule[1]
        if i >= len(args) or args[i] is None:
            return None
        pre = _pad32(args[i]) + _pad32(rule[2])
    if keccak_memo is not None:
        digest = keccak_memo.get(pre)
        if digest is not None:
            return int.from_bytes(digest, "big")
    return int.from_bytes(keccak256(pre), "big")


def _apply_rules(rules: Tuple[tuple, ...], sender_i: int,
                 args: Sequence[Optional[int]],
                 keccak_memo: Optional[Dict[bytes, bytes]] = None,
                 ) -> Optional[frozenset]:
    """Predicted slot keys for a new tx, or None when a rule's arg
    index is absent from this calldata (prediction impossible)."""
    slots = set()
    for rule in rules:
        key = _apply_rule(rule, sender_i, args, keccak_memo)
        if key is None:
            return None
        slots.add(key)
    return frozenset(slots)


def _map_preimages(rules: Tuple[tuple, ...], sender_i: int,
                   args: Sequence[Optional[int]]) -> List[bytes]:
    """The keccak preimages _apply_rules would hash for this tx."""
    out = []
    for rule in rules:
        if rule[0] == "map_caller":
            out.append(_pad32(sender_i) + _pad32(rule[1]))
        elif rule[0] == "map_arg":
            i = rule[1]
            if i < len(args) and args[i] is not None:
                out.append(_pad32(args[i]) + _pad32(rule[2]))
    return out


# rule preference when one written slot matches several derivations:
# semantic derivations first (they generalize), literal slots last
_RULE_PREFERENCE = ("caller", "map_caller", "map_arg", "arg", "const")


def _preferred_rule(matched: List[tuple]) -> tuple:
    return min(
        matched, key=lambda r: _RULE_PREFERENCE.index(r[0])
    )


class TemplateLearner:
    """Per-code-hash slot templates, learned from residue executions.

    Thread-safe; process-global by default (templates are properties
    of bytecode, not of a chain). A misprediction demotes the hash to
    opaque forever — the learner never oscillates; a template whose
    effects or gas ever disagree with a checked interpreter run is
    permanently pinned to the checked lane (vectorizable=False), which
    is equally oscillation-free."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._entries: Dict[bytes, object] = {}

    def lookup(self, code_hash: bytes) -> Optional[object]:
        """Template, the string "opaque", or None (never observed)."""
        with self._lock:
            return self._entries.get(code_hash)

    def demote(self, code_hash: bytes) -> None:
        with self._lock:
            if self._entries.get(code_hash) is not _OPAQUE:
                self._entries[code_hash] = _OPAQUE
                EXEC_GAUGES["opaque_codes"] += 1

    def observe(self, code_hash: bytes, sender: bytes, to: bytes,
                payload: bytes, reads: Dict[str, set],
                written: Dict[str, set],
                code: Optional[bytes] = None) -> None:
        """Learn from one residue execution's captured footprint. Only
        ever PROMOTES unknown -> template/opaque; an existing verdict
        stands (demotions happen solely through demote()). ``code``
        (the target's bytecode) feeds the purity scan; without it the
        template can still earn the checked lane, never the trusted
        one."""
        with self._lock:
            if code_hash in self._entries:
                return
        verdict: object = _OPAQUE
        ok = (
            not written[ON_CODE]
            and not written[ON_ADDRESS]
            and reads[ON_ACCOUNT] <= {sender, to}
            and reads[ON_ADDRESS] <= {sender, to}
            and written[ON_ACCOUNT] <= {sender, to}
            and reads[ON_CODE] <= {to}
        )
        if ok:
            sender_i = int.from_bytes(sender, "big")
            args = _arg_words(payload)
            rules: List[tuple] = []
            write_rules: List[tuple] = []
            for addr, key in reads[ON_STORAGE] | written[ON_STORAGE]:
                if addr != to:
                    ok = False
                    break
                matched = _derive_rules(key, sender_i, args)
                if not matched:
                    ok = False
                    break
                for r in matched:
                    if r not in rules:
                        rules.append(r)
                if (addr, key) in written[ON_STORAGE]:
                    wr = _preferred_rule(matched)
                    if wr in write_rules:
                        # two written slots collapse onto one rule:
                        # the effect model can't tell them apart
                        ok = False
                        break
                    write_rules.append(wr)
            if ok:
                # canonical rule order: whichever racing observer lands
                # first, the stored template is identical — concurrent
                # observation must not make replay behavior depend on
                # thread arrival (slot ints differ per observer, so
                # footprint-set iteration order is NOT canonical)
                verdict = Template(
                    rules=tuple(sorted(rules)),
                    write_rules=tuple(sorted(write_rules)),
                    scan=scan_pure_code(code) if code else None,
                )
        with self._lock:
            if code_hash not in self._entries:
                self._entries[code_hash] = verdict
                EXEC_GAUGES[
                    "templates" if verdict is not _OPAQUE
                    else "opaque_codes"
                ] += 1

    def confirm(self, code_hash: bytes, sender: bytes,
                payload: bytes, value: int, fees, intrinsic: int,
                gas_limit: int, pre: Dict[int, int],
                post: Dict[int, int], original: Dict[int, int],
                gas_used: int) -> None:
        """Digest one CHECKED interpreter run that already passed the
        footprint ⊆ check. Intersects the per-write-rule effect
        candidates with this observation and cross-checks the gas
        model; an exact match counts toward TRUST_AFTER, any
        disagreement permanently pins the template to the checked
        lane. ``pre``/``post``/``original`` map every predicted slot
        key to its value before / after the tx / at block start."""
        with self._lock:
            tpl = self._entries.get(code_hash)
        if not isinstance(tpl, Template) or not tpl.vectorizable:
            return
        if value != 0:
            return  # effects are only modeled for value-0 calls
        sender_i = int.from_bytes(sender, "big")
        args = _arg_words(payload)
        # resolve EVERY write-rule key before judging any effect: a
        # self-transfer-style calldata collapses two rules onto one
        # slot — that observation can't be modeled (skip it, it's no
        # evidence against the template), and the collision must be
        # seen before the first rule's effect match gets a vote
        keys: List[int] = []
        write_keys: Set[int] = set()
        for rule in tpl.write_rules:
            key = _apply_rule(rule, sender_i, args)
            if key is None or key in write_keys:
                return
            write_keys.add(key)
            keys.append(key)
        retire = False
        new_effects: List[Tuple[tuple, ...]] = []
        slot_rows: List[Tuple[int, int, int]] = []
        for idx, key in enumerate(keys):
            old, new = pre[key], post[key]
            cands = (
                tpl.effects[idx] if tpl.effects is not None
                else tuple(_effect_candidates(old, new, args))
            )
            cands = tuple(
                c for c in cands if _effect_matches(c, old, new, args)
            )
            if not cands:
                retire = True
                break
            new_effects.append(cands)
            slot_rows.append((original[key], old, new))
        if not retire:
            # a write at a slot the write rules don't own means the
            # effect model under-covers this bytecode
            for key, old in pre.items():
                if key not in write_keys and post[key] != old:
                    retire = True
                    break
        if not retire and tpl.scan is not None:
            predicted = predict_call_gas(
                tpl.scan, fees, intrinsic, gas_limit, slot_rows
            )
            if predicted is None:
                return  # gas margin unprovable — don't count, don't pin
            if predicted != gas_used:
                retire = True
        with self._lock:
            cur = self._entries.get(code_hash)
            if cur is not tpl:  # raced with demote/reset
                return
            if retire:
                self._entries[code_hash] = replace(
                    tpl, vectorizable=False
                )
                EXEC_GAUGES["effect_retirements"] += 1
                return
            promoted = replace(
                tpl,
                effects=tuple(new_effects),
                confirmations=tpl.confirmations + 1,
            )
            self._entries[code_hash] = promoted
            if (tpl.confirmations < TRUST_AFTER
                    and promoted.confirmations >= TRUST_AFTER
                    and promoted.scan is not None):
                EXEC_GAUGES["trusted_templates"] += 1

    def reset(self) -> None:
        with self._lock:
            self._entries.clear()


# the process-global learner (bytecode templates are chain-agnostic);
# tests and bench config boundaries reset it via reset_learner()
LEARNER = TemplateLearner()


def reset_learner() -> None:
    LEARNER.reset()


# the older name, kept for callers that reset templates
def reset_templates() -> None:
    LEARNER.reset()


# --------------------------------------------------------- the planner


def _classify(stx, sender: Optional[bytes], beneficiary: bytes,
              created: set, code_hash_of: Callable[[bytes], bytes],
              learner: TemplateLearner,
              keccak_memo: Optional[Dict[bytes, bytes]] = None,
              ) -> Tuple[Optional[Predicted], Optional[tuple]]:
    """(Predicted footprint, trusted (code_hash, Template) or None)
    for one tx; (None, None) -> residue."""
    tx = stx.tx
    to = tx.to
    if sender is None or to is None:
        return None, None  # unrecoverable sig / contract creation
    if sender == beneficiary or to == beneficiary:
        # fees post lazily in index order; a tx whose footprint could
        # touch the coinbase must see the sequential-exact balance
        return None, None
    if to in created or sender in created:
        # a top-level creation earlier in this block may deposit code
        # at this address — the parent-state code probe below would lie
        return None, None
    if int.from_bytes(to, "big") <= _RESERVED_ADDR_MAX:
        return None, None  # precompile dispatch keys on the code address
    code_hash = code_hash_of(to)
    if code_hash == EMPTY_CODE_HASH:
        if tx.value == 0 or sender == to:
            # zero-value / self transfers take the touch-only shortcut
            # in world.transfer — different mark+EIP-161 semantics than
            # the vectorized path models
            return None, None
        return Predicted(
            kind=FAST,
            acct_r=frozenset((sender,)),
            acct_d=frozenset((sender, to)),
            slots=frozenset(),
            code_r=frozenset((to,)),
        ), None
    verdict = learner.lookup(code_hash)
    if verdict is None or verdict is _OPAQUE:
        return None, None  # unknown (observe in residue) or opaque
    sender_i = int.from_bytes(sender, "big")
    args = _arg_words(tx.payload)
    slots = _apply_rules(verdict.rules, sender_i, args, keccak_memo)
    if slots is None:
        return None, None
    acct_d = {sender}
    if tx.value:
        acct_d.add(to)
    trusted = (
        (code_hash, verdict)
        if verdict.trusted_for(tx.value, args) else None
    )
    if trusted is not None:
        # a self-transfer-style calldata can collapse two write rules
        # onto ONE slot; the per-rule effect model doesn't compose
        # there, so such a call takes the checked lane instead
        keys: Set[int] = set()
        for rule in verdict.write_rules:
            k = _apply_rule(rule, sender_i, args, keccak_memo)
            if k is None or k in keys:
                trusted = None
                break
            keys.add(k)
    return Predicted(
        kind=CALL,
        acct_r=frozenset((sender, to)),
        acct_d=frozenset(acct_d),
        slots=frozenset((to, s) for s in slots),
        code_r=frozenset((to,)),
    ), trusted


def _prefill_map_keys(txs: Sequence, senders: Sequence[Optional[bytes]],
                      code_hash_of: Callable[[bytes], bytes],
                      learner: TemplateLearner,
                      ) -> Optional[Dict[bytes, bytes]]:
    """Precompute every mapping-slot keccak the block's templates will
    need in ONE native batch call (preimage -> digest), or None when
    no template rule needs a hash."""
    preimages: List[bytes] = []
    seen: Set[bytes] = set()
    for i, stx in enumerate(txs):
        tx = stx.tx
        if senders[i] is None or tx.to is None:
            continue
        if int.from_bytes(tx.to, "big") <= _RESERVED_ADDR_MAX:
            continue
        code_hash = code_hash_of(tx.to)
        if code_hash == EMPTY_CODE_HASH:
            continue
        verdict = learner.lookup(code_hash)
        if not isinstance(verdict, Template):
            continue
        sender_i = int.from_bytes(senders[i], "big")
        for pre in _map_preimages(
                verdict.rules, sender_i, _arg_words(tx.payload)):
            if pre not in seen:
                seen.add(pre)
                preimages.append(pre)
    if not preimages:
        return None
    from khipu_tpu_torch.native.keccak import keccak256_batch

    return dict(zip(preimages, keccak256_batch(preimages)))


def plan_block(txs: Sequence, senders: Sequence[Optional[bytes]],
               beneficiary: bytes,
               code_hash_of: Callable[[bytes], bytes],
               learner: Optional[TemplateLearner] = None) -> Plan:
    """Pack a block into maximal predicted-disjoint batches.

    Greedy precedence-respecting coloring: a tx's batch is one past
    the highest batch of any EARLIER conflicting tx, so every
    conflicting pair preserves index order while disjoint txs share a
    batch. A residue tx is a total barrier — all earlier steps run
    (and post fees) before it, all later txs start fresh after it.

    Trusted-lane routing is decided HERE, from the learner snapshot at
    block start — confirmations landed by this block's own checked
    calls only affect later blocks, keeping replay deterministic.
    """
    learner = learner if learner is not None else LEARNER
    plan = Plan()
    # top-level creation addresses: their code lands mid-block, so any
    # tx targeting one must not trust the parent-state code probe
    created = set()
    for i, stx in enumerate(txs):
        if stx.tx.to is None and senders[i] is not None:
            created.add(contract_address(senders[i], stx.tx.nonce))

    keccak_memo = _prefill_map_keys(txs, senders, code_hash_of, learner)

    open_batches: List[List[int]] = []  # since the last barrier
    # per-resource precedence frontiers (−1 = untouched)
    acct_read: Dict[bytes, int] = {}
    acct_write: Dict[bytes, int] = {}
    acct_delta: Dict[bytes, int] = {}
    slot_touch: Dict[tuple, int] = {}

    def close_batches() -> None:
        for b in open_batches:
            plan.steps.append(Step("batch", b))
            plan.max_width = max(plan.max_width, len(b))
        open_batches.clear()
        acct_read.clear()
        acct_write.clear()
        acct_delta.clear()
        slot_touch.clear()

    for i, stx in enumerate(txs):
        pred, trusted = _classify(stx, senders[i], beneficiary, created,
                                  code_hash_of, learner, keccak_memo)
        if pred is None:
            close_batches()
            plan.steps.append(Step(RESIDUE, [i]))
            plan.n_residue += 1
            continue
        plan.predicted[i] = pred
        if trusted is not None:
            plan.trusted[i] = trusted
        if pred.kind == FAST:
            plan.n_fast += 1
        else:
            plan.n_call += 1
        floor = -1
        for a in pred.acct_r:
            floor = max(floor, acct_write.get(a, -1),
                        acct_delta.get(a, -1))
        for a in pred.acct_w:
            floor = max(floor, acct_read.get(a, -1),
                        acct_write.get(a, -1), acct_delta.get(a, -1))
        for a in pred.acct_d:
            floor = max(floor, acct_read.get(a, -1),
                        acct_write.get(a, -1))
        for s in pred.slots:
            floor = max(floor, slot_touch.get(s, -1))
        batch = floor + 1
        if batch > 0:
            plan.conflicted += 1
        while len(open_batches) <= batch:
            open_batches.append([])
        open_batches[batch].append(i)
        for a in pred.acct_r:
            acct_read[a] = max(acct_read.get(a, -1), batch)
        for a in pred.acct_w:
            acct_write[a] = max(acct_write.get(a, -1), batch)
        for a in pred.acct_d:
            acct_delta[a] = max(acct_delta.get(a, -1), batch)
        for s in pred.slots:
            slot_touch[s] = max(slot_touch.get(s, -1), batch)
    close_batches()

    EXEC_GAUGES["planned_blocks"] += 1
    EXEC_GAUGES["fast_txs"] += plan.n_fast
    EXEC_GAUGES["call_txs"] += plan.n_call
    EXEC_GAUGES["residue_txs"] += plan.n_residue
    EXEC_GAUGES["batches"] += sum(
        1 for s in plan.steps if s.kind == "batch"
    )
    if plan.max_width > EXEC_GAUGES["max_batch_width"]:
        EXEC_GAUGES["max_batch_width"] = plan.max_width
    if JOURNEY.enabled:
        # the passport's "schedule" page: the DECISION (predicted lane
        # + batch id), stamped before any execution — the execute stamp
        # later records the lane that actually ran
        for step_i, step in enumerate(plan.steps):
            for i in step.indices:
                if step.kind == RESIDUE:
                    lane = "residue"
                else:
                    pred = plan.predicted[i]
                    if pred.kind == FAST:
                        lane = "vector-transfer"
                    elif i in plan.trusted:
                        lane = "vector-call"
                    else:
                        lane = "checked"
                JOURNEY.record(txs[i].hash, "schedule",
                               batch=step_i, lane=lane)
    return plan


def footprint_ok(pred: Predicted, reads: Dict[str, set],
                 written: Dict[str, set]) -> bool:
    """Post-hoc misprediction check: everything the tx ACTUALLY read
    or wrote must lie inside its predicted footprint. ⊆, not ==: an
    over-prediction only costs parallelism, never correctness."""
    return (
        reads[ON_ACCOUNT] <= pred.acct_r
        and reads[ON_ADDRESS] <= pred.acct_r
        and written[ON_ACCOUNT] <= (pred.acct_w | pred.acct_d)
        and written[ON_ADDRESS] <= pred.acct_d
        and reads[ON_STORAGE] <= pred.slots
        and written[ON_STORAGE] <= pred.slots
        and reads[ON_CODE] <= pred.code_r
        and not written[ON_CODE]
    )
