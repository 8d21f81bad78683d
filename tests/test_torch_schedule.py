"""The port's conflict-aware scheduler (khipu_tpu_torch ledger/schedule.py,
batch_exec.py, batch_call.py and the executors of ledger/ledger.py)
against the JAX package's, on the CPU: the cases of the JAX package's
scheduler tests, each fed to both packages with the same seeded inputs.

Plans are compared step by step with their predicted footprints,
trusted routing and counters; the purity scan, the static gas and the
effect algebra value by value; learners by their verdicts (rules,
write rules, effects, confirmations, scan, trust). Chains are built by
the JAX package's serial ChainBuilder, round-tripped through wire RLP
and replayed by both drivers (``device="cpu"`` for the port); headers,
receipts, the replay counters and the execute-stage gauge deltas must
be equal. Both packages' process-global learners are reset before every
replay that must start cold."""

import dataclasses
import random
import threading

import numpy as np
import pytest

from khipu_tpu.base.crypto.secp256k1 import (
    privkey_to_pubkey,
    pubkey_to_address,
)
from khipu_tpu.config import SyncConfig as JxSyncConfig
from khipu_tpu.config import fixture_config as jx_fixture_config
from khipu_tpu.domain.account import EMPTY_CODE_HASH
from khipu_tpu.domain.block import Block as JxBlock
from khipu_tpu.domain.blockchain import Blockchain as JxBlockchain
from khipu_tpu.domain.blockchain import GenesisSpec as JxGenesisSpec
from khipu_tpu.domain.transaction import (
    Transaction,
    contract_address,
    sign_transaction,
)
from khipu_tpu.evm.config import for_block as jx_for_block
from khipu_tpu.ledger import schedule as jx_sched
from khipu_tpu.ledger.world import ON_ACCOUNT, ON_ADDRESS, ON_CODE, ON_STORAGE
from khipu_tpu.storage.storages import Storages as JxStorages
from khipu_tpu.sync.chain_builder import ChainBuilder as JxChainBuilder
from khipu_tpu.sync.replay import ReplayDriver as JxReplayDriver

from khipu_tpu_torch import workloads
from khipu_tpu_torch.config import SyncConfig, fixture_config
from khipu_tpu_torch.domain.block import Block
from khipu_tpu_torch.domain.blockchain import Blockchain, GenesisSpec
from khipu_tpu_torch.evm.config import for_block
from khipu_tpu_torch.ledger import ledger as pt_ledger
from khipu_tpu_torch.ledger import schedule as pt_sched
from khipu_tpu_torch.ledger import world as pt_world
from khipu_tpu_torch.native.keccak import keccak256_batch
from khipu_tpu_torch.storage.storages import Storages
from khipu_tpu_torch.sync.replay import ReplayDriver

NKEYS = 12
KEYS = [(i + 71).to_bytes(32, "big") for i in range(NKEYS)]
ADDRS = [pubkey_to_address(privkey_to_pubkey(k)) for k in KEYS]
MINER = b"\xaa" * 20
GWEI = 10**9
ETH = 10**18
ALLOC = {a: 1000 * ETH for a in ADDRS}
SEED = 20261017


def tx(i, nonce, to, value, gas=21_000, payload=b""):
    return sign_transaction(
        Transaction(nonce, GWEI, gas, to, value, payload), KEYS[i],
        chain_id=1,
    )


class _STX:
    """Planner-shaped stand-in: plan_block only reads ``.tx``."""

    def __init__(self, t):
        self.tx = t


def _jx_cfg(parallel=True, scheduled=True):
    return dataclasses.replace(
        jx_fixture_config(chain_id=1),
        sync=JxSyncConfig(parallel_tx=parallel, scheduled_tx=scheduled),
    )


def _pt_cfg(parallel=True, scheduled=True):
    return dataclasses.replace(
        fixture_config(chain_id=1),
        sync=SyncConfig(parallel_tx=parallel, scheduled_tx=scheduled),
    )


def _builder():
    cfg = _jx_cfg(parallel=False)
    return JxChainBuilder(JxBlockchain(JxStorages(), cfg), cfg,
                          JxGenesisSpec(alloc=ALLOC))


def _init_code(runtime):
    return (
        bytes([0x60 + len(runtime) - 1]) + runtime
        + bytes([0x60, 0x00, 0x52])
        + bytes([0x60, len(runtime), 0x60, 32 - len(runtime), 0xF3])
    )


def _codecopy_init(runtime):
    return bytes([
        0x60, len(runtime), 0x60, 0x0C, 0x60, 0x00, 0x39,
        0x60, len(runtime), 0x60, 0x00, 0xF3,
    ]) + runtime


def _reset_both():
    pt_sched.reset_learner()
    jx_sched.reset_learner()


_GAUGE_DELTAS = [k for k in pt_sched.EXEC_GAUGES if k != "max_batch_width"]
_COUNTERS = ("blocks", "txs", "gas", "parallel_txs", "conflicts",
             "fast_path_txs", "residue_txs", "mispredictions")


def _replay_both(blocks, scheduled=True, reset=True):
    """Replay ``blocks`` (the JAX package's) through both drivers from
    ALLOC's genesis; every header, receipt list, replay counter and
    execute-stage gauge delta must be equal. Returns the port's stats
    and both chains."""
    if reset:
        _reset_both()
    wire = [b.encode() for b in blocks]
    pt_cfg, jx_cfg = _pt_cfg(scheduled=scheduled), _jx_cfg(scheduled=scheduled)
    pt_chain = Blockchain(Storages(), pt_cfg)
    pt_chain.load_genesis(GenesisSpec(alloc=ALLOC))
    jx_chain = JxBlockchain(JxStorages(), jx_cfg)
    jx_chain.load_genesis(JxGenesisSpec(alloc=ALLOC))
    g_pt = dict(pt_sched.EXEC_GAUGES)
    g_jx = dict(jx_sched.EXEC_GAUGES)
    pt_stats = ReplayDriver(pt_chain, pt_cfg, device="cpu").replay(
        [Block.decode(w) for w in wire])
    d_pt = {k: pt_sched.EXEC_GAUGES[k] - g_pt[k] for k in _GAUGE_DELTAS}
    jx_stats = JxReplayDriver(jx_chain, jx_cfg).replay(
        [JxBlock.decode(w) for w in wire])
    d_jx = {k: jx_sched.EXEC_GAUGES[k] - g_jx[k] for k in _GAUGE_DELTAS}
    assert d_pt == d_jx
    assert ([getattr(pt_stats, k) for k in _COUNTERS]
            == [getattr(jx_stats, k) for k in _COUNTERS])
    for n in range(1, len(blocks) + 1):
        assert pt_chain.get_header_by_number(n).hash == blocks[n - 1].hash
        assert (pt_chain.storages.receipts_storage.get(n)
                == jx_chain.storages.receipts_storage.get(n))
    return pt_stats, pt_chain, jx_chain


def _code_hash(chain, block, addr):
    return chain.get_world_state(block.header.state_root).get_code_hash(addr)


def _verdict(v):
    """A learner verdict as plain data: "opaque", None, or the
    template's fields (the scan as a tuple)."""
    if v is None or isinstance(v, str):
        return v
    scan = None if v.scan is None else dataclasses.astuple(v.scan)
    return (v.rules, v.write_rules, v.effects, v.confirmations, scan,
            v.vectorizable)


def _plan(plan):
    """A plan as plain data, footprints included."""
    return (
        [(s.kind, list(s.indices)) for s in plan.steps],
        {i: (p.kind, p.acct_r, p.acct_d, p.slots, p.code_r, p.acct_w)
         for i, p in plan.predicted.items()},
        {i: (ch, _verdict(t)) for i, (ch, t) in plan.trusted.items()},
        plan.n_fast, plan.n_call, plan.n_residue, plan.conflicted,
        plan.max_width,
    )


def _conflicts(p, q):
    """The documented conflict relation, re-derived independently of
    both planners: read meets write/delta, write meets anything, slots
    intersect. D∩D and code∩code are NOT conflicts."""
    return bool(
        (p.acct_r & (q.acct_w | q.acct_d))
        or (q.acct_r & (p.acct_w | p.acct_d))
        or (p.acct_w & (q.acct_r | q.acct_w | q.acct_d))
        or (q.acct_w & (p.acct_r | p.acct_w | p.acct_d))
        or (p.slots & q.slots)
    )


# --------------------------------------------------------------- planner


def _teach(learner, token, token_hash):
    learner.observe(
        token_hash, ADDRS[0], token, (5).to_bytes(32, "big"),
        reads={ON_ACCOUNT: {ADDRS[0], token}, ON_ADDRESS: set(),
               ON_STORAGE: {(token, 5)}, ON_CODE: {token}},
        written={ON_ACCOUNT: {ADDRS[0]}, ON_ADDRESS: set(),
                 ON_STORAGE: {(token, 5)}, ON_CODE: set()},
    )


def _random_block(rng, token):
    """A planner-hostile mix: few senders, shared recipients, coinbase
    touches, creations, precompile targets, zero-value transfers and
    template calls to ``token``."""
    pool = ADDRS[:6]
    txs, senders = [], []
    for j in range(rng.randrange(8, 30)):
        sender = rng.choice(pool)
        r = rng.random()
        if r < 0.05:
            t = Transaction(j, GWEI, 53_000, None, 0, b"\x00")
        elif r < 0.10:
            t = Transaction(j, GWEI, 21_000, MINER, 5)
        elif r < 0.15:
            t = Transaction(j, GWEI, 21_000, (0x07).to_bytes(20, "big"), 5)
        elif r < 0.25:
            t = Transaction(j, GWEI, 21_000, rng.choice(pool), 0)
        elif r < 0.55:
            payload = rng.randrange(1, 9).to_bytes(32, "big")
            t = Transaction(j, GWEI, 90_000, token, 0, payload)
        else:
            t = Transaction(j, GWEI, 21_000,
                            rng.choice(pool + ADDRS[6:10]),
                            rng.randrange(1, 99))
        txs.append(_STX(t))
        senders.append(sender)
    return txs, senders


def test_batches_pairwise_disjoint_over_seeds():
    """40 seeded blocks: both planners give the same plan (steps,
    footprints, counters), and every batch is conflict-free under the
    independently derived relation, a permutation of the block."""
    token, token_hash = b"\x70" * 20, b"\x71" * 32
    pt_learner, jx_learner = pt_sched.TemplateLearner(), jx_sched.TemplateLearner()
    _teach(pt_learner, token, token_hash)
    _teach(jx_learner, token, token_hash)

    def code_hash_of(addr):
        return token_hash if addr == token else EMPTY_CODE_HASH

    for seed in range(40):
        txs, senders = _random_block(random.Random(seed), token)
        plan = pt_sched.plan_block(txs, senders, MINER, code_hash_of,
                                   pt_learner)
        assert _plan(plan) == _plan(jx_sched.plan_block(
            txs, senders, MINER, code_hash_of, jx_learner))
        seen = []
        for step in plan.steps:
            seen.extend(step.indices)
            if step.kind == "residue":
                assert len(step.indices) == 1
                continue
            preds = [plan.predicted[i] for i in step.indices]
            for a in range(len(preds)):
                for b in range(a + 1, len(preds)):
                    assert not _conflicts(preds[a], preds[b]), seed
        assert sorted(seen) == list(range(len(txs)))


@pytest.mark.parametrize("recipients,width,conflicted", [
    ((5, 6), 1, 1),  # one sender: read meets delta, index order kept
    ((7, 7), 2, 0),  # two senders, one recipient: D∩D commutes
], ids=["same_sender", "shared_recipient"])
def test_two_transfer_plans(recipients, width, conflicted):
    senders = ([ADDRS[0], ADDRS[0]] if conflicted else [ADDRS[0], ADDRS[1]])
    txs = [_STX(Transaction(n if conflicted else 0, GWEI, 21_000,
                            ADDRS[r], 1 + n))
           for n, r in enumerate(recipients)]
    plans = [
        sched.plan_block(txs, senders, MINER, lambda a: EMPTY_CODE_HASH,
                         sched.TemplateLearner())
        for sched in (pt_sched, jx_sched)
    ]
    assert _plan(plans[0]) == _plan(plans[1])
    assert plans[0].max_width == width
    assert plans[0].conflicted == conflicted
    batch_of = {i: pos for pos, s in enumerate(plans[0].steps)
                for i in s.indices}
    assert batch_of[0] <= batch_of[1]


# ------------------------------------------------- purity scan and gas


_TOKEN_RUNTIME = bytes([
    0x60, 0x00, 0x35, 0x60, 0x20, 0x35, 0x33, 0x54, 0x81, 0x90, 0x03,
    0x33, 0x55, 0x81, 0x54, 0x01, 0x90, 0x55, 0x00,
])
XOR_RUNTIME = bytes([
    0x60, 0x01, 0x60, 0x00, 0x35, 0x60, 0x20, 0x35, 0x18, 0x55, 0x00,
])
POISON_RUNTIME = bytes([
    0x33, 0x60, 0x00, 0x52, 0x60, 0x20, 0x35, 0x60, 0x20, 0x52,
    0x60, 0x40, 0x60, 0x00, 0x20, 0x60, 0x00, 0x35, 0x90, 0x55, 0x00,
])


def _bytecodes():
    """The fixture runtimes plus a seeded set: random bytes, and
    straight-line programs drawn from the whitelisted opcodes (PUSH1
    constants, arithmetic, CALLER/CALLDATALOAD, MSTORE/SHA3 on constant
    offsets, SLOAD/SSTORE, EXP)."""
    rng = np.random.default_rng(SEED)
    codes = [workloads.ERC20_RUNTIME, workloads.COUNTER_RUNTIME,
             _TOKEN_RUNTIME, XOR_RUNTIME, POISON_RUNTIME, b"", b"\x00"]
    codes += [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
              for n in rng.integers(1, 64, 60)]
    pieces = [b"\x60\x00\x35", b"\x60\x20\x35", b"\x33", b"\x01", b"\x03",
              b"\x02", b"\x18", b"\x60\x05", b"\x60\x00\x52", b"\x60\x40",
              b"\x60\x40\x60\x00\x20", b"\x54", b"\x55", b"\x80", b"\x90",
              b"\x0a", b"\x50", b"\x34", b"\x5b"]
    for _ in range(120):
        picks = rng.integers(0, len(pieces), int(rng.integers(2, 24)))
        codes.append(b"".join(pieces[p] for p in picks) + b"\x00")
    return codes


def test_scan_pure_code_and_static_gas():
    """The purity scan, its static gas under the fixture schedule and
    the call gas prediction over seeded slot rows agree value by value
    on ERC20_RUNTIME and a seeded bytecode set; the ERC-20 runtime is
    pure with two SSTOREs."""
    pt_fees = for_block(0, fixture_config(chain_id=1).blockchain).fees
    jx_fees = jx_for_block(0, jx_fixture_config(chain_id=1).blockchain).fees
    rng = random.Random(SEED)
    pure = 0
    for code in _bytecodes():
        a, b = pt_sched.scan_pure_code(code), jx_sched.scan_pure_code(code)
        assert (a is None) == (b is None), code.hex()
        if a is None:
            continue
        pure += 1
        assert dataclasses.astuple(a) == dataclasses.astuple(b)
        assert (pt_sched.scan_static_gas(a, pt_fees)
                == jx_sched.scan_static_gas(b, jx_fees))
        for _ in range(4):
            rows = [tuple(rng.choice([0, 1, 7, 2**255]) for _ in range(3))
                    for _ in range(a.n_sstores)]
            gas_limit = rng.choice([30_000, 60_000, 200_000])
            assert (pt_sched.predict_call_gas(a, pt_fees, 21_000,
                                              gas_limit, rows)
                    == jx_sched.predict_call_gas(b, jx_fees, 21_000,
                                                 gas_limit, rows))
    assert pure > 20
    erc20 = pt_sched.scan_pure_code(workloads.ERC20_RUNTIME)
    assert erc20 is not None and erc20.n_sstores == 2


def test_effect_algebra():
    """Effect candidates, their application and the slot-rule
    derivation agree on seeded values (wrapping at 2^256)."""
    rng = random.Random(SEED)
    vals = [0, 1, 2, 5, 2**255, 2**256 - 1]
    for _ in range(300):
        old = rng.choice(vals + [rng.getrandbits(256)])
        args = [rng.choice(vals + [None, rng.getrandbits(64)])
                for _ in range(rng.randrange(0, 4))]
        new = rng.choice([
            old, rng.getrandbits(256),
            (old + (args[0] or 3)) % 2**256 if args else 9,
            (old - (args[-1] or 3)) % 2**256 if args else 4,
        ])
        cands = pt_sched._effect_candidates(old, new, args)
        assert cands == jx_sched._effect_candidates(old, new, args)
        for eff in cands:
            assert (pt_sched.apply_effect(eff, old, args)
                    == jx_sched.apply_effect(eff, old, args) == new)
        payload = b"".join((a or 0).to_bytes(32, "big") for a in args)
        sender = rng.getrandbits(160)
        slot = rng.choice([sender, 3, rng.getrandbits(256)]
                          + [a for a in args if a is not None])
        words = pt_sched._arg_words(payload)
        assert words == jx_sched._arg_words(payload)
        assert (pt_sched._derive_rules(slot, sender, words)
                == jx_sched._derive_rules(slot, sender, words))


# ----------------------------------------------------- replays, learning


def _random_chain(seed, n_tx_blocks=4, txs_per_block=12):
    """Deploy the token, then seeded adversarial blocks: hot transfers,
    template calls, zero-value touches, coinbase payments, creations;
    long enough for the token to cross TRUST_AFTER."""
    rng = random.Random(seed)
    builder = _builder()
    token = contract_address(ADDRS[0], 0)
    blocks = [builder.add_block(
        [tx(0, 0, None, 0, gas=500_000, payload=_init_code(_TOKEN_RUNTIME))],
        coinbase=MINER)]
    nonces = [1] + [0] * (NKEYS - 1)
    for _ in range(n_tx_blocks):
        txs = []
        for _ in range(txs_per_block):
            i = rng.randrange(NKEYS)
            r = rng.random()
            if r < 0.30:
                txs.append(tx(i, nonces[i], rng.choice(ADDRS[:4]),
                              1 + rng.randrange(50)))
            elif r < 0.55:
                payload = (ADDRS[rng.randrange(NKEYS)].rjust(32, b"\x00")
                           + (1 + rng.randrange(3)).to_bytes(32, "big"))
                txs.append(tx(i, nonces[i], token, 0, gas=200_000,
                              payload=payload))
            elif r < 0.65:
                txs.append(tx(i, nonces[i], rng.choice(ADDRS), 0,
                              gas=30_000))
            elif r < 0.72:
                txs.append(tx(i, nonces[i], MINER, 7))
            elif r < 0.78:
                txs.append(tx(i, nonces[i], None, 0, gas=60_000,
                              payload=b"\x00"))
            else:
                txs.append(tx(i, nonces[i], bytes.fromhex(
                    "%040x" % (0xE0000000 + rng.randrange(8))),
                    1 + rng.randrange(9)))
            nonces[i] += 1
        blocks.append(builder.add_block(txs, coinbase=MINER))
    return blocks


@pytest.mark.parametrize("seed", [0, 7, 31])
def test_scheduled_and_optimistic_match_reference(seed):
    """Seeded adversarial chains, scheduled and optimistic: both drivers
    land on the serial fold's headers with equal receipts, counters
    and gauge deltas; the scheduled run exercises the fast path and the
    residue."""
    blocks = _random_chain(seed)
    stats, _, _ = _replay_both(blocks, scheduled=True)
    assert stats.fast_path_txs > 0 and stats.residue_txs > 0
    _replay_both(blocks, scheduled=False)


def test_template_call_batches_after_learning():
    """The first token call runs in the residue and teaches both
    learners; the next block's call takes the CALL lane."""
    builder = _builder()
    token = contract_address(ADDRS[0], 0)
    payload = ADDRS[9].rjust(32, b"\x00") + (1).to_bytes(32, "big")
    blocks = [
        builder.add_block([tx(0, 0, None, 0, gas=500_000,
                              payload=_init_code(_TOKEN_RUNTIME)),
                           tx(4, 0, ADDRS[10], 3)], coinbase=MINER),
        builder.add_block([tx(1, 0, token, 0, gas=200_000, payload=payload),
                           tx(5, 0, ADDRS[10], 3)], coinbase=MINER),
        builder.add_block([tx(2, 0, token, 0, gas=200_000, payload=payload),
                           tx(3, 0, ADDRS[8], 5)], coinbase=MINER),
    ]
    stats, pt_chain, _ = _replay_both(blocks)
    assert (stats.residue_txs, stats.fast_path_txs, stats.parallel_txs) == (
        2, 3, 4)
    ch = _code_hash(pt_chain, blocks[0], token)
    verdict = pt_sched.LEARNER.lookup(ch)
    assert _verdict(verdict) == _verdict(jx_sched.LEARNER.lookup(ch))
    assert ("caller",) in verdict.rules and ("arg", 0) in verdict.rules


def _two_call_chain(runtime, learn_args, poison_args):
    """Deploy ``runtime``, one learning call and one poisoned call, each
    beside a filler transfer."""
    builder = _builder()
    target = contract_address(ADDRS[0], 0)

    def call(i, a0, a1):
        return tx(i, 0, target, 0, gas=100_000,
                  payload=a0.to_bytes(32, "big") + a1.to_bytes(32, "big"))

    blocks = [
        builder.add_block([tx(0, 0, None, 0, gas=500_000,
                              payload=_init_code(runtime)),
                           tx(4, 0, ADDRS[10], 3)], coinbase=MINER),
        builder.add_block([call(1, *learn_args), tx(5, 0, ADDRS[10], 3)],
                          coinbase=MINER),
        builder.add_block([call(2, *poison_args), tx(3, 0, ADDRS[8], 9)],
                          coinbase=MINER),
    ]
    return blocks, target


@pytest.mark.parametrize("runtime,learn,poison", [
    (XOR_RUNTIME, (5, 0), (5, 7)),          # slot arg0 ^ arg1
    (POISON_RUNTIME, (0x99, 0), (7, 3)),    # keccak(caller || arg1)
], ids=["xor_slot", "poisoned_mapping"])
def test_misprediction_falls_back_and_demotes(runtime, learn, poison):
    """A template learned from one call is a lie a later call exposes:
    both packages fall back whole-block (serial headers), demote the
    code hash to opaque, and a second replay without a reset runs the
    residue with no misprediction."""
    blocks, target = _two_call_chain(runtime, learn, poison)
    stats, pt_chain, _ = _replay_both(blocks)
    assert stats.mispredictions >= 1
    ch = _code_hash(pt_chain, blocks[0], target)
    assert pt_sched.LEARNER.lookup(ch) == jx_sched.LEARNER.lookup(ch) == "opaque"
    stats2, _, _ = _replay_both(blocks, reset=False)
    assert stats2.mispredictions == 0


def _erc20_chain(n_call_blocks):
    """Deploy the ERC-20, then blocks of two disjoint transfer calls and
    a filler transfer."""
    builder = _builder()
    token = contract_address(ADDRS[0], 0)

    def call(i, nonce, rcpt, amount):
        return tx(i, nonce, token, 0, gas=200_000,
                  payload=rcpt.rjust(32, b"\x00") + amount.to_bytes(32, "big"))

    blocks = [builder.add_block(
        [tx(0, 0, None, 0, gas=500_000,
            payload=_codecopy_init(workloads.ERC20_RUNTIME)),
         tx(4, 0, ADDRS[10], 3)], coinbase=MINER)]
    nonces = [1] + [0] * (NKEYS - 1)
    nonces[4] = 1
    holders = [(0xE20E2000 + i).to_bytes(20, "big") for i in range(8)]
    for n in range(n_call_blocks):
        s1, s2, filler = 1 + (n % 3), 5 + (n % 3), 8 + (n % 4)
        blocks.append(builder.add_block([
            call(s1, nonces[s1], holders[n % 8], 100 + 7 * n),
            call(s2, nonces[s2], holders[(n + 3) % 8], 5 + n),
            tx(filler, nonces[filler], ADDRS[11], 2 + n),
        ], coinbase=MINER))
        for i in (s1, s2, filler):
            nonces[i] += 1
    return blocks, token


def test_mapping_rules_promote_after_one_observation():
    """One observed call derives both mapping-form write rules in both
    learners; a template, not yet trusted."""
    blocks, token = _erc20_chain(1)
    _, pt_chain, _ = _replay_both(blocks)
    ch = _code_hash(pt_chain, blocks[0], token)
    verdict = pt_sched.LEARNER.lookup(ch)
    assert _verdict(verdict) == _verdict(jx_sched.LEARNER.lookup(ch))
    assert ("map_caller", 0) in verdict.write_rules
    assert ("map_arg", 0, 0) in verdict.write_rules
    assert verdict.scan is not None and verdict.effects is None
    assert verdict.confirmations < pt_sched.TRUST_AFTER


def test_trusted_mapping_calls_run_vectorized():
    """Past TRUST_AFTER checked confirmations the calls take the trusted
    vectorized lane in both packages, with the learned effects."""
    blocks, token = _erc20_chain(6)
    before = pt_sched.EXEC_GAUGES["vector_call_txs"]
    stats, pt_chain, _ = _replay_both(blocks)
    assert stats.mispredictions == 0
    assert (pt_sched.EXEC_GAUGES["vector_call_txs"] - before
            >= 2 * (6 - 1 - pt_sched.TRUST_AFTER))
    ch = _code_hash(pt_chain, blocks[0], token)
    verdict = pt_sched.LEARNER.lookup(ch)
    assert _verdict(verdict) == _verdict(jx_sched.LEARNER.lookup(ch))
    by_rule = dict(zip(verdict.write_rules, verdict.effects))
    assert by_rule[("map_caller", 0)][0] == ("old_sub_arg", 1)
    assert by_rule[("map_arg", 0, 0)][0] == ("old_add_arg", 1)


def _erc20_footprint(sender, rcpt, token):
    ss, rs = [int.from_bytes(k, "big") for k in keccak256_batch(
        [sender.rjust(32, b"\x00") + b"\x00" * 32,
         rcpt.rjust(32, b"\x00") + b"\x00" * 32])]
    return dict(
        reads={ON_ACCOUNT: {sender, token}, ON_ADDRESS: set(),
               ON_STORAGE: {(token, ss), (token, rs)}, ON_CODE: {token}},
        written={ON_ACCOUNT: {sender}, ON_ADDRESS: set(),
                 ON_STORAGE: {(token, ss), (token, rs)}, ON_CODE: set()},
    )


def test_learner_observe_confirm_demote_sequence():
    """The same observe / confirm / demote sequence leaves both
    learners with the same verdict at every step: one observation
    makes a template, TRUST_AFTER exact confirmations trust it, a run
    whose gas disagrees pins it to the checked lane, and opaque is
    forever."""
    token, code_hash = b"\x70" * 20, b"\x73" * 32
    pt_fees = for_block(0, fixture_config(chain_id=1).blockchain).fees
    fees = [pt_fees,
            jx_for_block(0, jx_fixture_config(chain_id=1).blockchain).fees]
    learners = [pt_sched.TemplateLearner(), jx_sched.TemplateLearner()]
    sender, rcpt = ADDRS[1], ADDRS[6]
    fp = _erc20_footprint(sender, rcpt, token)
    for learner in learners:
        learner.observe(code_hash, sender, token,
                        rcpt.rjust(32, b"\x00") + (5).to_bytes(32, "big"),
                        code=workloads.ERC20_RUNTIME, **fp)
    tpl = learners[0].lookup(code_hash)
    assert _verdict(tpl) == _verdict(learners[1].lookup(code_hash))
    sender_i = int.from_bytes(sender, "big")
    balances = {}
    for step, amount in enumerate((5, 9, 11)):
        payload = rcpt.rjust(32, b"\x00") + amount.to_bytes(32, "big")
        args = pt_sched._arg_words(payload)
        debit = pt_sched._apply_rule(("map_caller", 0), sender_i, args)
        credit = pt_sched._apply_rule(("map_arg", 0, 0), sender_i, args)
        pre = {debit: balances.get(debit, 10**6),
               credit: balances.get(credit, 0)}
        post = {debit: pre[debit] - amount, credit: pre[credit] + amount}
        original = dict(pre)
        rows = [(original[k], pre[k], post[k]) for k in (
            pt_sched._apply_rule(r, sender_i, args) for r in tpl.write_rules)]
        intrinsic = 21_000 + 16 * sum(1 for x in payload if x) + 4 * sum(
            1 for x in payload if not x)
        gas = pt_sched.predict_call_gas(tpl.scan, pt_fees, intrinsic,
                                        200_000, rows)
        if step == 2:
            gas += 1  # disagrees with the gas model: pinned to checked
        for learner, f in zip(learners, fees):
            learner.confirm(code_hash, sender, payload, 0, f, intrinsic,
                            200_000, dict(pre), dict(post), original, gas)
        got = learners[0].lookup(code_hash)
        assert _verdict(got) == _verdict(learners[1].lookup(code_hash))
        assert got.confirmations == min(step + 1, pt_sched.TRUST_AFTER)
        assert got.vectorizable == (step < 2)
        balances = post
    for learner in learners:
        learner.demote(code_hash)
        for _ in range(3):
            learner.observe(code_hash, sender, token, b"\x05" * 32, **fp)
        assert learner.lookup(code_hash) == "opaque"


def test_concurrent_observation_determinism():
    """Racing observers on the port's learner converge on the template
    a serial pass derives, in either package, for every interleaving."""
    token, code_hash = b"\x70" * 20, b"\x74" * 32
    obs = []
    for i in range(NKEYS):
        rcpt = ADDRS[(i + 5) % NKEYS]
        payload = rcpt.rjust(32, b"\x00") + (3 + i).to_bytes(32, "big")
        obs.append((ADDRS[i], payload, _erc20_footprint(ADDRS[i], rcpt, token)))
    ref = jx_sched.TemplateLearner()
    for sender, payload, fp in obs:
        ref.observe(code_hash, sender, token, payload, **fp)
    want = _verdict(ref.lookup(code_hash))
    assert want != "opaque"
    for trial in range(8):
        order = list(obs)
        random.Random(trial).shuffle(order)
        learner = pt_sched.TemplateLearner()
        threads = [threading.Thread(
            target=lambda o=o: learner.observe(code_hash, o[0], token, o[1],
                                               **o[2]))
            for o in order]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert _verdict(learner.lookup(code_hash)) == want, trial


def test_exec_pool_is_shared_and_resizable():
    a = pt_ledger._exec_pool(4)
    assert pt_ledger._exec_pool(4) is a
    b = pt_ledger._exec_pool(2)
    assert b is not a and pt_ledger._exec_pool(2) is b
    pt_ledger.shutdown_exec_pool()
    c = pt_ledger._exec_pool(2)
    assert c is not b and c.submit(lambda: 41 + 1).result() == 42
    pt_ledger.shutdown_exec_pool()


def test_footprint_ok_matches_reference():
    """The post-hoc misprediction check on seeded footprints."""
    rng = random.Random(SEED)
    addrs = ADDRS[:5]

    def sub(xs):
        return {x for x in xs if rng.random() < 0.4}

    for _ in range(200):
        slots = {(addrs[0], k) for k in range(4)}
        pred = dict(kind="call", acct_r=frozenset(sub(addrs)),
                    acct_d=frozenset(sub(addrs)),
                    slots=frozenset(sub(slots)),
                    code_r=frozenset(sub(addrs)),
                    acct_w=frozenset(sub(addrs)))
        reads = {ON_ACCOUNT: sub(addrs), ON_ADDRESS: sub(addrs),
                 ON_STORAGE: sub(slots), ON_CODE: sub(addrs)}
        written = {ON_ACCOUNT: sub(addrs), ON_ADDRESS: sub(addrs),
                   ON_STORAGE: sub(slots),
                   ON_CODE: sub(addrs) if rng.random() < 0.2 else set()}
        assert (pt_sched.footprint_ok(pt_sched.Predicted(**pred), reads,
                                      written)
                == jx_sched.footprint_ok(jx_sched.Predicted(**pred), reads,
                                         written))
    assert (pt_world.ON_ACCOUNT, pt_world.ON_ADDRESS, pt_world.ON_STORAGE,
            pt_world.ON_CODE) == (ON_ACCOUNT, ON_ADDRESS, ON_STORAGE,
                                  ON_CODE)
