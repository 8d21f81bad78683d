"""Runner for the `ethereum/tests` GeneralStateTests JSON format.

The reference client had no vector suite at all — its de-facto test was
replaying mainnet against consensus (Ledger.scala:603-620). This module
gives the rebuild the standard vector harness instead: it consumes the
exact schema published by the `ethereum/tests` repository (env / pre /
transaction / post-per-fork with data-gas-value indexes), so the
official vectors drop in unmodified when available. `tests/fixtures/
state_tests/` carries format-conformant regression vectors generated by
this implementation (this environment has no network access to vendor
the official suite; the mainnet anchors in test_mainnet_anchor.py are
the non-circular oracles).

Usage:
    python -m khipu_tpu_torch.statetest FILE.json [FILE2.json ...]
"""

from __future__ import annotations

import json
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional

from khipu_tpu_torch.base.keccak import keccak256
from khipu_tpu_torch.base.secp256k1 import (
    privkey_to_pubkey,
    pubkey_to_address,
)
from khipu_tpu_torch.base.rlp import rlp_encode
from khipu_tpu_torch.config import FAR, BlockchainConfig
from khipu_tpu_torch.domain.account import Account
from khipu_tpu_torch.domain.transaction import Transaction, sign_transaction
from khipu_tpu_torch.evm.config import for_block
from khipu_tpu_torch.evm.vm import BlockEnv
from khipu_tpu_torch.ledger.ledger import (
    TxValidationError,
    _tx_post,
    _validate_stx,
    execute_transaction,
)
from khipu_tpu_torch.ledger.world import BlockWorldState
from khipu_tpu_torch.storage.datasource import MemoryNodeDataSource
from khipu_tpu_torch.trie.mpt import MerklePatriciaTrie


def _fork_config(fork: str, chain_id: int = 1) -> BlockchainConfig:
    """ethereum/tests fork label -> compressed activation schedule."""
    order = [
        "Frontier",
        "Homestead",
        "EIP150",
        "EIP158",
        "Byzantium",
        "Constantinople",
        "ConstantinopleFix",
        "Istanbul",
    ]
    aliases = {"Petersburg": "ConstantinopleFix", "SpuriousDragon": "EIP158",
               "TangerineWhistle": "EIP150"}
    fork = aliases.get(fork, fork)
    if fork not in order:
        raise ValueError(f"unsupported fork {fork!r}")
    at = order.index(fork)

    def act(name: str) -> int:
        return 0 if at >= order.index(name) else FAR

    return BlockchainConfig(
        chain_id=chain_id,
        homestead_block=act("Homestead"),
        eip150_block=act("EIP150"),
        eip155_block=act("EIP158"),
        eip160_block=act("EIP158"),
        eip161_block=act("EIP158"),
        eip170_block=act("EIP158"),
        byzantium_block=act("Byzantium"),
        constantinople_block=act("Constantinople"),
        petersburg_block=act("ConstantinopleFix"),
        istanbul_block=act("Istanbul"),
        dao_fork_block_number=FAR,
        dao_fork_block_hash=None,
        dao_fork_extra_data=None,
    )


def _unhex(s: str) -> bytes:
    s = s[2:] if s.startswith("0x") else s
    return bytes.fromhex("0" + s if len(s) % 2 else s)


def _qty(s) -> int:
    if isinstance(s, int):
        return s
    return int(s, 16) if s.startswith("0x") else int(s)


@dataclass
class CaseResult:
    name: str
    fork: str
    index: Dict[str, int]
    ok: bool
    got_hash: bytes
    want_hash: bytes
    got_logs: bytes
    want_logs: bytes
    detail: str = ""


def _build_pre_world(pre: dict) -> BlockWorldState:
    source = MemoryNodeDataSource()
    world = BlockWorldState(
        MerklePatriciaTrie(source),
        storage_source=MemoryNodeDataSource(),
        evmcode_source=MemoryNodeDataSource(),
        get_block_hash=lambda n: None,
    )
    for addr_hex, fields in pre.items():
        addr = _unhex(addr_hex)
        world.save_account(
            addr,
            Account(
                nonce=_qty(fields.get("nonce", "0x0")),
                balance=_qty(fields.get("balance", "0x0")),
            ),
        )
        code = _unhex(fields.get("code", "0x"))
        if code:
            world.save_code(addr, code)
        for slot, value in (fields.get("storage") or {}).items():
            world.save_storage(addr, _qty(slot), _qty(value))
    return world.flush()


def _logs_hash(logs) -> bytes:
    """kec256(rlp([[address, topics, data], ...])) — the official
    post.logs digest."""
    return keccak256(
        rlp_encode(
            [
                [log.address, [t for t in log.topics], log.data]
                for log in logs
            ]
        )
    )


def run_case(name: str, case: dict) -> List[CaseResult]:
    env = case["env"]
    txspec = case["transaction"]
    results: List[CaseResult] = []
    for fork, posts in case["post"].items():
        bc = _fork_config(fork)
        config = for_block(0, bc)
        for post in posts:
            idx = post["indexes"]
            tx = Transaction(
                nonce=_qty(txspec["nonce"]),
                gas_price=_qty(txspec.get("gasPrice", "0x0")),
                gas_limit=_qty(txspec["gasLimit"][idx["gas"]]),
                to=_unhex(txspec["to"]) if txspec.get("to") else None,
                value=_qty(txspec["value"][idx["value"]]),
                payload=_unhex(txspec["data"][idx["data"]]),
            )
            chain_id = bc.chain_id if config.eip155 else None
            stx = sign_transaction(
                tx, _unhex(txspec["secretKey"]), chain_id=chain_id
            )
            sender = pubkey_to_address(
                privkey_to_pubkey(_unhex(txspec["secretKey"]))
            )
            world = _build_pre_world(case["pre"])
            block_env = BlockEnv(
                number=_qty(env.get("currentNumber", "0x1")),
                timestamp=_qty(env.get("currentTimestamp", "0x3e8")),
                difficulty=_qty(env.get("currentDifficulty", "0x20000")),
                gas_limit=_qty(env.get("currentGasLimit", "0x1000000")),
                beneficiary=_unhex(env["currentCoinbase"]),
                get_block_hash=lambda n: None,
            )
            detail = ""
            logs: list = []
            try:
                _validate_stx(
                    stx, sender, config, world, 0, block_env.gas_limit, 0
                )
                r = execute_transaction(
                    config, world, block_env, stx, sender
                )
                world = r.world
                _tx_post(
                    config, world, r, block_env.beneficiary, 0, []
                )
                logs = r.logs
                if r.error:
                    detail = f"vm error: {r.error}"
            except TxValidationError as e:
                # invalid tx: post state == pre state, no logs
                detail = f"invalid tx: {e}"
                world = _build_pre_world(case["pre"])
            got_hash = world.flush().root_hash
            got_logs = _logs_hash(logs)
            want_hash = _unhex(post["hash"])
            want_logs = _unhex(post["logs"])
            results.append(
                CaseResult(
                    name=name,
                    fork=fork,
                    index=idx,
                    ok=(got_hash == want_hash and got_logs == want_logs),
                    got_hash=got_hash,
                    want_hash=want_hash,
                    got_logs=got_logs,
                    want_logs=want_logs,
                    detail=detail,
                )
            )
    return results


def run_file(path: str) -> List[CaseResult]:
    with open(path) as f:
        doc = json.load(f)
    out: List[CaseResult] = []
    for name, case in doc.items():
        out.extend(run_case(name, case))
    return out


def main(argv: Optional[List[str]] = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return 2
    failed = 0
    total = 0
    for path in argv:
        for r in run_file(path):
            total += 1
            status = "PASS" if r.ok else "FAIL"
            if not r.ok:
                failed += 1
            line = f"{status} {r.name} [{r.fork}] idx={r.index}"
            if not r.ok:
                line += (
                    f" got={r.got_hash.hex()[:16]}"
                    f" want={r.want_hash.hex()[:16]}"
                )
            if r.detail:
                line += f" ({r.detail})"
            print(line)
    print(f"{total - failed}/{total} passed")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
