"""Fork-gated EVM configuration + gas fee schedules.

Parity: vm/EvmConfig.scala:19-37 (forBlock selects the config class for
a block number: Frontier/Homestead/EIP-150/EIP-160-161(+patch)/
Byzantium/Constantinople/Petersburg/Istanbul) and the FeeSchedule
hierarchy at :304. One frozen dataclass per concern; configs are
constructed once per fork boundary and cached.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from functools import lru_cache

from khipu_tpu_torch.config import BlockchainConfig


@dataclass(frozen=True)
class FeeSchedule:
    """Frontier base values (EvmConfig.scala:304 FeeSchedule; YP appendix G).
    Fork repricings are applied as replace() deltas below."""

    G_zero: int = 0
    G_base: int = 2
    G_verylow: int = 3
    G_low: int = 5
    G_mid: int = 8
    G_high: int = 10
    G_balance: int = 20
    G_sload: int = 50
    G_jumpdest: int = 1
    G_sset: int = 20_000
    G_sreset: int = 5_000
    R_sclear: int = 15_000
    R_selfdestruct: int = 24_000
    G_selfdestruct: int = 0
    G_create: int = 32_000
    G_codedeposit: int = 200
    G_call: int = 40
    G_callvalue: int = 9_000
    G_callstipend: int = 2_300
    G_newaccount: int = 25_000
    G_exp: int = 10
    G_expbyte: int = 10
    G_memory: int = 3
    G_txcreate: int = 32_000
    G_txdatazero: int = 4
    G_txdatanonzero: int = 68
    G_transaction: int = 21_000
    G_log: int = 375
    G_logdata: int = 8
    G_logtopic: int = 375
    G_sha3: int = 30
    G_sha3word: int = 6
    G_copy: int = 3
    G_blockhash: int = 20
    G_extcode: int = 20
    G_extcodehash: int = 400
    # EIP-2200 (Istanbul) net-metered SSTORE
    G_sstore_noop: int = 200  # SLOAD_GAS at the time
    G_sstore_init: int = 20_000
    G_sstore_clean: int = 5_000
    G_sstore_sentry: int = 2_300


_FRONTIER_FEES = FeeSchedule()
_EIP150_FEES = replace(
    _FRONTIER_FEES,
    G_balance=400,
    G_sload=200,
    G_call=700,
    G_extcode=700,
    G_selfdestruct=5_000,
)
_EIP160_FEES = replace(_EIP150_FEES, G_expbyte=50)
_ISTANBUL_FEES = replace(
    _EIP160_FEES,
    G_balance=700,  # EIP-1884
    G_sload=800,
    G_extcodehash=700,
    G_txdatanonzero=16,  # EIP-2028
    G_sstore_noop=800,  # EIP-2200 ties the no-op cost to SLOAD
)


@dataclass(frozen=True)
class EvmConfig:
    """Everything fork-dependent the VM + ledger consult per block."""

    fees: FeeSchedule
    chain_id: int = 1
    account_start_nonce: int = 0
    max_code_size: int = 24_576
    # fork feature flags (EvmConfig.scala class hierarchy)
    homestead: bool = False  # DELEGATECALL, tx-create cost, create OOG
    eip150: bool = False  # 63/64 rule + repricings
    eip155: bool = False  # replay-protected signatures
    eip160: bool = False  # exp byte cost
    eip161: bool = False  # empty-account deletion, contract nonce=1
    eip170: bool = False  # max code size enforced
    byzantium: bool = False  # REVERT/RETURNDATA/STATICCALL, status receipt
    constantinople: bool = False  # shifts, CREATE2, EXTCODEHASH
    petersburg: bool = False  # disables EIP-1283
    istanbul: bool = False  # EIP-2200 SSTORE, CHAINID, SELFBALANCE
    # mainnet block 2,675,119 compat (EvmConfig.scala:111-118 +
    # OpCode.scala:1425-1436): a FAILED call to the RIPEMD-160
    # precompile still records the touch, so the empty 0x..03 account is
    # deleted even though the frame reverted (the Parity EIP-161 bug the
    # canonical chain embeds)
    eip161_patch: bool = False

    # ------------------------------------------------ derived semantics

    @property
    def charges_tx_create(self) -> bool:
        """Homestead adds G_txcreate to intrinsic gas of creations."""
        return self.homestead

    @property
    def fail_on_create_deposit_oog(self) -> bool:
        """Frontier kept the empty contract when the deposit couldn't be
        paid; Homestead makes it an OOG failure."""
        return self.homestead

    @property
    def sub_gas_cap_divisor(self) -> bool:
        """EIP-150: child calls get at most 63/64 of remaining gas."""
        return self.eip150

    @property
    def contract_start_nonce(self) -> int:
        """EIP-161: freshly created contracts start at nonce 1."""
        return self.account_start_nonce + (1 if self.eip161 else 0)

    def intrinsic_gas(
        self, payload: bytes, is_contract_creation: bool
    ) -> int:
        """g0 (YP eq. 54-56; Ledger.txIntrinsicGas role)."""
        zeros = payload.count(0)
        gas = (
            self.fees.G_transaction
            + zeros * self.fees.G_txdatazero
            + (len(payload) - zeros) * self.fees.G_txdatanonzero
        )
        if is_contract_creation and self.charges_tx_create:
            gas += self.fees.G_txcreate
        return gas


@lru_cache(maxsize=512)
def _build(flags: tuple, chain_id: int, start_nonce: int, max_code: int) -> EvmConfig:
    (homestead, eip150, eip155, eip160, eip161,
     eip170, byzantium, constantinople, petersburg, istanbul,
     eip161_patch) = flags
    if istanbul:
        fees = _ISTANBUL_FEES
    elif eip160:
        fees = _EIP160_FEES
    elif eip150:
        fees = _EIP150_FEES
    else:
        fees = _FRONTIER_FEES
    return EvmConfig(
        fees=fees,
        chain_id=chain_id,
        account_start_nonce=start_nonce,
        max_code_size=max_code,
        homestead=homestead,
        eip150=eip150,
        eip155=eip155,
        eip160=eip160,
        eip161=eip161,
        eip170=eip170,
        byzantium=byzantium,
        constantinople=constantinople,
        petersburg=petersburg,
        istanbul=istanbul,
        eip161_patch=eip161_patch,
    )


def for_block(number: int, bc: BlockchainConfig) -> EvmConfig:
    """EvmConfig.forBlock(:19-37): pick the fork config active at a
    block. At exactly the EIP-161 patch block (EvmConfig.scala:111-118,
    mainnet 2,675,119) the ripemd touch-survives-revert compat rule is
    active; EIP-161 clearing itself stays on."""
    flags = (
        number >= bc.homestead_block,
        number >= bc.eip150_block,
        number >= bc.eip155_block,
        number >= bc.eip160_block,
        number >= bc.eip161_block,
        number >= bc.eip170_block,
        number >= bc.byzantium_block,
        number >= bc.constantinople_block,
        number >= bc.petersburg_block,
        number >= bc.istanbul_block,
        number == bc.eip161_patch_block,
    )
    return _build(
        flags, bc.chain_id, bc.account_start_nonce, bc.max_code_size
    )
