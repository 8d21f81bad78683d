"""Read-only transaction simulation — eth_call / eth_estimateGas.

Parity: Ledger.simulateTransaction (Ledger.scala:166-191) running on a
getReadOnlyWorldState (Blockchain.scala:312): no signature, relaxed
nonce/balance, world discarded afterwards. estimate_gas binary-searches
the minimal sufficient gas (the 63/64 rule makes gas_used alone an
underestimate for nested calls).

The port's copy of ``khipu_tpu.ledger.simulate``: every frame runs
through ``evm/dispatch.py``, so on the native core unless a routing rule
sends it to the Python VM. The simulated world reads the committed
store (no device work).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from khipu_tpu_torch.config import KhipuConfig
from khipu_tpu_torch.domain.block_header import BlockHeader
from khipu_tpu_torch.domain.receipt import TxLogEntry
from khipu_tpu_torch.domain.transaction import contract_address
from khipu_tpu_torch.evm.config import for_block
from khipu_tpu_torch.evm.dispatch import run_create, run_message_call
from khipu_tpu_torch.evm.vm import BlockEnv, MessageEnv

ZERO_ADDRESS = b"\x00" * 20


@dataclass
class CallResult:
    output: bytes
    gas_used: int
    logs: List[TxLogEntry]
    error: Optional[str] = None
    is_revert: bool = False

    @property
    def ok(self) -> bool:
        return self.error is None and not self.is_revert


def simulate_call(
    make_world,
    header: BlockHeader,
    khipu_config: KhipuConfig,
    sender: bytes = ZERO_ADDRESS,
    to: Optional[bytes] = None,
    gas: Optional[int] = None,
    gas_price: int = 0,
    value: int = 0,
    data: bytes = b"",
) -> CallResult:
    """Execute an unsigned message at a block's state; all writes stay
    in the discarded world."""
    config = for_block(header.number, khipu_config.blockchain)
    world = make_world(header.state_root)
    gas = gas if gas is not None else header.gas_limit
    block_env = BlockEnv(
        number=header.number,
        timestamp=header.unix_timestamp,
        difficulty=header.difficulty,
        gas_limit=header.gas_limit,
        beneficiary=header.beneficiary,
        get_block_hash=world.get_block_hash,
    )
    intrinsic = config.intrinsic_gas(data, to is None)
    if gas < intrinsic:
        return CallResult(b"", gas, [], error="IntrinsicGas")
    exec_gas = gas - intrinsic

    if to is None:
        nonce = world.get_nonce(sender)
        world.increase_nonce(sender)
        result, _ = run_create(
            config, world, block_env, sender, sender,
            contract_address(sender, nonce), exec_gas, gas_price, value,
            data, depth=0,
        )
    else:
        env = MessageEnv(
            owner=to, caller=sender, origin=sender,
            gas_price=gas_price, value=value, input_data=data,
        )
        # relaxed-balance rule: only transfer when covered (the world is
        # discarded afterwards, so backend write targets don't matter)
        do_transfer = world.get_balance(sender) >= value
        result = run_message_call(
            config, world, block_env, env, world.get_code(to), exec_gas,
            to, pre_transfer=do_transfer,
        )
    gas_used = gas - result.gas_remaining if result.error is None else gas
    return CallResult(
        output=result.output,
        gas_used=gas_used,
        logs=list(result.logs),
        error=result.error,
        is_revert=result.is_revert,
    )


def estimate_gas(
    make_world,
    header: BlockHeader,
    khipu_config: KhipuConfig,
    **call_kwargs,
) -> int:
    """Minimal gas for which the call succeeds (binary search — the
    63/64 child-gas rule means observed gas_used can be insufficient)."""
    cap = call_kwargs.pop("gas", None) or header.gas_limit
    probe = simulate_call(
        make_world, header, khipu_config, gas=cap, **call_kwargs
    )
    if not probe.ok:
        raise ValueError(
            f"call fails even with {cap} gas: "
            f"{probe.error or 'reverted'}"
        )
    lo, hi = probe.gas_used - 1, cap
    while lo + 1 < hi:
        mid = (lo + hi) // 2
        r = simulate_call(
            make_world, header, khipu_config, gas=mid, **call_kwargs
        )
        if r.ok:
            hi = mid
        else:
            lo = mid
    return hi
