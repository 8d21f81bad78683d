"""Transactions + EIP-155 sender recovery.

Parity: domain/Transaction.scala and domain/SignedTransaction.scala:17
(:143 — sender recovery via secp256k1 ECDSA, pre/post-EIP-155 v
handling). ``to == None`` means contract creation. The sender is never
stored on-chain: it is recovered from (v, r, s) over the signing hash.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import List, Optional

from khipu_tpu_torch.base.keccak import keccak256
from khipu_tpu_torch.base.secp256k1 import (
    SignatureError,
    ecdsa_recover,
    ecdsa_recover_batch,
    ecdsa_sign,
    pubkey_to_address,
)
from khipu_tpu_torch.base.rlp import rlp_decode, rlp_encode
from khipu_tpu_torch.evm.dataword import from_bytes, to_minimal_bytes


@dataclass(frozen=True)
class Transaction:
    nonce: int
    gas_price: int
    gas_limit: int
    to: Optional[bytes]  # 20 bytes, or None for contract creation
    value: int
    payload: bytes = b""

    @property
    def is_contract_creation(self) -> bool:
        return self.to is None

    def _base_fields(self) -> List[bytes]:
        return [
            to_minimal_bytes(self.nonce),
            to_minimal_bytes(self.gas_price),
            to_minimal_bytes(self.gas_limit),
            self.to if self.to is not None else b"",
            to_minimal_bytes(self.value),
            self.payload,
        ]

    def signing_hash(self, chain_id: Optional[int]) -> bytes:
        """kec256 of the signing payload: 6 fields pre-EIP-155, plus
        [chainId, 0, 0] with replay protection (EIP-155)."""
        fields = self._base_fields()
        if chain_id is not None:
            fields += [to_minimal_bytes(chain_id), b"", b""]
        return keccak256(rlp_encode(fields))


@dataclass(frozen=True)
class SignedTransaction:
    tx: Transaction
    v: int
    r: int
    s: int

    def encode(self) -> bytes:
        return rlp_encode(
            self.tx._base_fields()
            + [
                to_minimal_bytes(self.v),
                to_minimal_bytes(self.r),
                to_minimal_bytes(self.s),
            ]
        )

    @cached_property
    def hash(self) -> bytes:
        return keccak256(self.encode())

    @property
    def chain_id(self) -> Optional[int]:
        """EIP-155 v = 35 + 2*chainId + parity; legacy v in {27, 28}."""
        if self.v in (27, 28):
            return None
        return (self.v - 35) // 2

    @cached_property
    def sender(self) -> Optional[bytes]:
        """Recovered 20-byte sender, or None when the signature is
        invalid (SignedTransaction.scala:143)."""
        recid, chain_id = self._recid_chain_id()
        if recid is None:
            return None
        try:
            pub = ecdsa_recover(
                self.tx.signing_hash(chain_id), recid, self.r, self.s
            )
        except SignatureError:
            return None
        return pubkey_to_address(pub)

    def _recid_chain_id(self):
        if self.v in (27, 28):
            return self.v - 27, None
        if self.v >= 35:
            return (self.v - 35) % 2, (self.v - 35) // 2
        return None, None

    @staticmethod
    def decode(data: bytes) -> "SignedTransaction":
        f = rlp_decode(data)
        if len(f) != 9:
            raise ValueError(f"signed tx wants 9 fields, got {len(f)}")
        to = f[3] if f[3] != b"" else None
        return SignedTransaction(
            Transaction(
                nonce=from_bytes(f[0]),
                gas_price=from_bytes(f[1]),
                gas_limit=from_bytes(f[2]),
                to=to,
                value=from_bytes(f[4]),
                payload=f[5],
            ),
            v=from_bytes(f[6]),
            r=from_bytes(f[7]),
            s=from_bytes(f[8]),
        )


def sign_transaction(
    tx: Transaction, priv: bytes, chain_id: Optional[int] = None
) -> SignedTransaction:
    """Produce a SignedTransaction (EIP-155 when chain_id is given)."""
    recid, r, s = ecdsa_sign(tx.signing_hash(chain_id), priv)
    v = (27 + recid) if chain_id is None else (35 + 2 * chain_id + recid)
    return SignedTransaction(tx, v, r, s)


def recover_senders(stxs) -> None:
    """Batch-recover and cache ``sender`` for every transaction of a
    block in ONE native call (replay's per-block sender phase;
    Ledger.scala's parallel recovery inside the tx pool). Transactions
    whose sender is already cached are skipped; invalid signatures
    cache None — identical semantics to the per-tx property."""
    todo = []
    metas = []
    for stx in stxs:
        if "sender" in stx.__dict__:
            continue
        recid, chain_id = stx._recid_chain_id()
        if recid is None:
            stx.__dict__["sender"] = None
            continue
        todo.append(stx)
        metas.append(
            (stx.tx.signing_hash(chain_id), recid, stx.r, stx.s)
        )
    if not todo:
        return
    for stx, pub in zip(todo, ecdsa_recover_batch(metas)):
        stx.__dict__["sender"] = (
            pubkey_to_address(pub) if pub is not None else None
        )


def contract_address(sender: bytes, nonce: int) -> bytes:
    """CREATE address = kec256(rlp([sender, nonce]))[12:]."""
    return keccak256(rlp_encode([sender, to_minimal_bytes(nonce)]))[12:]


def create2_address(sender: bytes, salt: bytes, init_code: bytes) -> bytes:
    """CREATE2 (EIP-1014): kec256(0xff ++ sender ++ salt ++ kec256(init))[12:]."""
    return keccak256(
        b"\xff" + sender + salt.rjust(32, b"\x00") + keccak256(init_code)
    )[12:]
