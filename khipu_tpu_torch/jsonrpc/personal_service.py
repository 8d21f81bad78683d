"""personal_* namespace + the keystore-backed eth_sendTransaction /
eth_sign path.

Parity: jsonrpc/PersonalService.scala:72-182 (importRawKey, newAccount,
listAccounts, unlockAccount, lockAccount, sign, ecRecover,
sendTransaction with/without passphrase — nonce defaulting from
current account + pooled txs :147-173, signed-message prefix :176-181).

The port's copy of ``khipu_tpu.jsonrpc.personal_service``, over the
port's ``keystore.py`` (whose keyfile AES is the host library's,
``native/aes.py``) and the native secp256k1.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from khipu_tpu_torch.base.keccak import keccak256
from khipu_tpu_torch.base.secp256k1 import (
    SignatureError,
    ecdsa_recover,
    ecdsa_sign,
    pubkey_to_address,
)
from khipu_tpu_torch.config import KhipuConfig
from khipu_tpu_torch.domain.blockchain import Blockchain
from khipu_tpu_torch.domain.transaction import Transaction, sign_transaction
from khipu_tpu_torch.jsonrpc.eth_service import (
    RpcError,
    data,
    parse_data,
    parse_qty,
)
from khipu_tpu_torch.keystore import KeyStore, KeyStoreError, Wallet
from khipu_tpu_torch.txpool import PendingTransactionsPool

DEFAULT_GAS = 90_000  # TransactionRequest.scala defaultGasLimit


def message_to_sign(message: bytes) -> bytes:
    """EIP-191 personal-message digest (PersonalService.scala:176-181):
    kec256("\\x19Ethereum Signed Message:\\n" + len + message)."""
    prefix = b"\x19Ethereum Signed Message:\n" + str(
        len(message)
    ).encode()
    return keccak256(prefix + message)


class PersonalService:
    """Dispatch target for personal_* (and the signing eth_*) methods;
    install alongside EthService on the JSON-RPC server."""

    def __init__(
        self,
        keystore: KeyStore,
        blockchain: Blockchain,
        config: KhipuConfig,
        tx_pool: PendingTransactionsPool,
    ):
        self.keystore = keystore
        self.blockchain = blockchain
        self.config = config
        self.tx_pool = tx_pool
        # address -> (wallet, expiry unix seconds or None)
        self._unlocked: Dict[bytes, tuple] = {}
        self._lock = threading.Lock()

    # -------------------------------------------------------- accounts

    def personal_importRawKey(self, prv: str, passphrase: str) -> str:
        try:
            address = self.keystore.import_key(
                parse_data(prv), passphrase
            )
        except (KeyStoreError, ValueError) as e:
            raise RpcError(-32000, str(e))
        return data(address)

    def personal_newAccount(self, passphrase: str) -> str:
        return data(self.keystore.new_account(passphrase))

    def personal_listAccounts(self) -> list:
        return [data(a) for a in self.keystore.list_accounts()]

    def personal_unlockAccount(
        self, address: str, passphrase: str, duration=None
    ) -> bool:
        addr = parse_data(address)
        try:
            wallet = self.keystore.unlock(addr, passphrase)
        except KeyStoreError as e:
            raise RpcError(-32000, str(e))
        # geth semantics: duration 0 (or omitted) = unlocked until
        # lock/restart — regardless of encoding ("0x0", 0, None)
        dur = parse_qty(duration) if duration is not None else 0
        expiry = time.monotonic() + dur if dur else None
        with self._lock:
            self._unlocked[addr] = (wallet, expiry)
        return True

    def personal_lockAccount(self, address: str) -> bool:
        with self._lock:
            return self._unlocked.pop(parse_data(address), None) is not None

    def _wallet_of(self, addr: bytes) -> Optional[Wallet]:
        with self._lock:
            entry = self._unlocked.get(addr)
            if entry is None:
                return None
            wallet, expiry = entry
            if expiry is not None and time.monotonic() >= expiry:
                del self._unlocked[addr]
                return None
            return wallet

    # --------------------------------------------------------- signing

    def personal_sign(
        self, message: str, address: str, passphrase: Optional[str] = None
    ) -> str:
        addr = parse_data(address)
        if passphrase is not None:
            try:
                wallet = self.keystore.unlock(addr, passphrase)
            except KeyStoreError as e:
                raise RpcError(-32000, str(e))
        else:
            wallet = self._wallet_of(addr)
            if wallet is None:
                raise RpcError(-32000, "account is locked")
        digest = message_to_sign(parse_data(message))
        recid, r, s = ecdsa_sign(digest, wallet.private_key)
        return data(
            r.to_bytes(32, "big")
            + s.to_bytes(32, "big")
            + bytes([27 + recid])
        )

    def eth_sign(self, address: str, message: str) -> str:
        """geth-argument-order variant over the unlocked wallet."""
        return self.personal_sign(message, address, None)

    def personal_ecRecover(self, message: str, signature: str) -> str:
        sig = parse_data(signature)
        if len(sig) != 65:
            raise RpcError(-32000, "signature must be 65 bytes")
        r = int.from_bytes(sig[:32], "big")
        s = int.from_bytes(sig[32:64], "big")
        v = sig[64]
        recid = v - 27 if v >= 27 else v
        digest = message_to_sign(parse_data(message))
        try:
            pub = ecdsa_recover(digest, recid, r, s)
        except SignatureError as e:
            raise RpcError(-32000, f"invalid signature: {e}")
        return data(pubkey_to_address(pub))

    # ---------------------------------------------------- transactions

    def _next_nonce(self, addr: bytes) -> int:
        best = self.blockchain.best_block_number
        header = self.blockchain.get_header_by_number(best)
        acc = (
            self.blockchain.get_account(addr, header.state_root)
            if header is not None
            else None
        )
        nonce = acc.nonce if acc else self.config.blockchain.account_start_nonce
        # pooled txs from this sender advance the usable nonce
        # (PersonalService.scala:147-173)
        pooled = [
            stx.tx.nonce
            for stx in self.tx_pool.pending()
            if stx.sender == addr
        ]
        if pooled:
            nonce = max(nonce, max(pooled) + 1)
        return nonce

    def _send(self, request: dict, wallet: Wallet) -> str:
        to = parse_data(request["to"]) if request.get("to") else None
        tx = Transaction(
            nonce=(
                parse_qty(request["nonce"])
                if request.get("nonce") is not None
                else self._next_nonce(wallet.address)
            ),
            gas_price=(
                parse_qty(request["gasPrice"])
                if request.get("gasPrice")
                else 10**9
            ),
            gas_limit=(
                parse_qty(request["gas"])
                if request.get("gas")
                else DEFAULT_GAS
            ),
            to=to,
            value=parse_qty(request["value"]) if request.get("value") else 0,
            payload=(
                parse_data(request.get("data") or request.get("input"))
                if (request.get("data") or request.get("input"))
                else b""
            ),
        )
        # EIP-155 replay protection once the fork is active at the tip
        chain_id = (
            self.config.blockchain.chain_id
            if self.blockchain.best_block_number
            >= self.config.blockchain.eip155_block
            else None
        )
        stx = sign_transaction(tx, wallet.private_key, chain_id=chain_id)
        self.tx_pool.add(stx)
        return data(stx.hash)

    def personal_sendTransaction(
        self, request: dict, passphrase: str
    ) -> str:
        if not request.get("from"):
            raise RpcError(-32602, "missing 'from'")
        addr = parse_data(request["from"])
        try:
            wallet = self.keystore.unlock(addr, passphrase)
        except KeyStoreError as e:
            raise RpcError(-32000, str(e))
        return self._send(request, wallet)

    def eth_sendTransaction(self, request: dict) -> str:
        if not request.get("from"):
            raise RpcError(-32602, "missing 'from'")
        wallet = self._wallet_of(parse_data(request["from"]))
        if wallet is None:
            raise RpcError(-32000, "account is locked")
        return self._send(request, wallet)
