"""Blockchain facade: chain DB over the typed storages.

Parity: domain/Blockchain.scala:170-379 (getWorldState:301,
getAccount:336, saveNewBlock:362 — world.persist + header/body/
receipts/td/blocknum/tx index + best number, removeBlock:322) and
blockchain/data/GenesisDataLoader.scala:70 (alloc -> state trie ->
stored genesis, with the stored-vs-computed hash check).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from khipu_tpu_torch.base.keccak import keccak256
from khipu_tpu_torch.config import KhipuConfig
from khipu_tpu_torch.device import resolve_device
from khipu_tpu_torch.domain.account import Account, address_key
from khipu_tpu_torch.domain.block import Block, BlockBody
from khipu_tpu_torch.domain.block_header import EMPTY_OMMERS_HASH, BlockHeader
from khipu_tpu_torch.domain.receipt import Receipt, decode_receipts, encode_receipts
from khipu_tpu_torch.ledger.bloom import EMPTY_BLOOM
from khipu_tpu_torch.ledger.world import BlockWorldState
from khipu_tpu_torch.storage.storages import Storages
from khipu_tpu_torch.trie.bulk import bulk_build, device_hasher, host_hasher
from khipu_tpu_torch.trie.mpt import EMPTY_TRIE_HASH, MerklePatriciaTrie


@dataclass(frozen=True)
class GenesisSpec:
    """Genesis parameters + alloc (GenesisDataLoader's JSON shape)."""

    alloc: Dict[bytes, int] = field(default_factory=dict)  # address -> wei
    difficulty: int = 0x020000
    gas_limit: int = 8_000_000
    timestamp: int = 0
    extra_data: bytes = b""
    nonce: bytes = b"\x00" * 8
    mix_hash: bytes = b"\x00" * 32
    coinbase: bytes = b"\x00" * 20


class Blockchain:
    def __init__(self, storages: Storages, config: KhipuConfig):
        self.storages = storages
        self.config = config

    # ------------------------------------------------------------ worlds

    def get_world_state(self, state_root: bytes) -> BlockWorldState:
        """Fresh world at a state root (getWorldState:301)."""
        return BlockWorldState(
            MerklePatriciaTrie(
                self.storages.account_node_storage, root_hash=state_root
            ),
            self.storages.storage_node_storage,
            self.storages.evmcode_storage,
            get_block_hash=self.get_hash_by_number,
            account_start_nonce=self.config.blockchain.account_start_nonce,
        )

    def get_account(
        self, address: bytes, state_root: bytes
    ) -> Optional[Account]:
        trie = MerklePatriciaTrie(
            self.storages.account_node_storage, root_hash=state_root
        )
        raw = trie.get(address_key(address))
        return Account.decode(raw) if raw is not None else None

    # ------------------------------------------------------------ blocks

    def get_hash_by_number(self, number: int) -> Optional[bytes]:
        return self.storages.block_numbers.hash_of(number)

    def get_header_by_number(self, number: int) -> Optional[BlockHeader]:
        raw = self.storages.block_header_storage.get(number)
        return BlockHeader.decode(raw) if raw is not None else None

    def get_header_by_hash(self, block_hash: bytes) -> Optional[BlockHeader]:
        """Hash-verified lookup through the hash->number index (a stale
        index entry after a reorg must not alias another header)."""
        n = self.storages.block_numbers.number_of(block_hash)
        if n is None:
            return None
        header = self.get_header_by_number(n)
        if header is not None and header.hash == block_hash:
            return header
        return None

    def get_block_by_number(self, number: int) -> Optional[Block]:
        header = self.get_header_by_number(number)
        if header is None:
            return None
        raw = self.storages.block_body_storage.get(number)
        body = BlockBody.decode(raw) if raw is not None else BlockBody()
        return Block(header, body)

    def get_receipts(self, number: int) -> Optional[List[Receipt]]:
        raw = self.storages.receipts_storage.get(number)
        return decode_receipts(raw) if raw is not None else None

    def get_total_difficulty(self, number: int) -> Optional[int]:
        return self.storages.total_difficulty_storage.get_td(number)

    @property
    def best_block_number(self) -> int:
        return self.storages.best_block_number

    def save_block(
        self,
        block: Block,
        receipts: List[Receipt],
        total_difficulty: int,
        world: Optional[BlockWorldState] = None,
        hasher=None,
    ) -> None:
        """saveNewBlock:362: world.persist + all block storages +
        best-number advance. ``hasher`` routes the trie commit through
        the batched device path; the root equality check below gates it
        against the header either way."""
        s = self.storages
        if world is not None:
            root = world.persist(
                s.account_node_storage,
                s.storage_node_storage,
                s.evmcode_storage,
                hasher=hasher,
            )
            if root != block.header.state_root:
                raise ValueError(
                    f"persisted root {root.hex()} != header state root "
                    f"{block.header.state_root.hex()}"
                )
        n = block.number
        s.block_header_storage.put(n, block.header.encode())
        s.block_body_storage.put(n, block.body.encode())
        s.receipts_storage.put(n, encode_receipts(receipts))
        s.total_difficulty_storage.put_td(n, total_difficulty)
        s.block_numbers.put(block.hash, n)
        for i, tx in enumerate(block.body.transactions):
            s.transaction_storage.put(tx.hash, n, i)
        s.app_state.best_block_number = n
        # the block is durable once this returns (a no-op where the
        # engine writes through)
        s.flush_writes()

    def remove_block(self, block_hash: bytes) -> None:
        """removeBlock:322 (reorg orphaning)."""
        s = self.storages
        n = s.block_numbers.number_of(block_hash)
        if n is None:
            return
        block = self.get_block_by_number(n)
        if block is not None and block.hash == block_hash:
            for tx in block.body.transactions:
                s.transaction_storage.source.remove(tx.hash)
            s.block_header_storage.source.remove(n)
            s.block_body_storage.source.remove(n)
            s.receipts_storage.source.remove(n)
            s.total_difficulty_storage.source.remove(n)
        s.block_numbers.remove(block_hash)

    # ----------------------------------------------------------- genesis

    def load_genesis(
        self, spec: GenesisSpec, on_device: bool = False, device=None
    ) -> Block:
        """Build + persist the genesis state and block
        (GenesisDataLoader.scala:70). The alloc trie goes through the
        level-synchronous bulk build: with ``on_device``, one batched
        hash a level on ``device`` (``None`` means the card: K1r there;
        ``"cpu"`` the plain sponge), else the host hasher."""
        start_nonce = self.config.blockchain.account_start_nonce
        pairs = [
            (
                address_key(addr),
                Account(nonce=start_nonce, balance=balance).encode(),
            )
            for addr, balance in spec.alloc.items()
        ]
        if on_device:
            device = resolve_device(device)
            hasher = functools.partial(device_hasher, device=device)
        else:
            hasher, device = host_hasher, "cpu"
        state_root, nodes = bulk_build(pairs, hasher=hasher, device=device)
        self.storages.account_node_storage.update([], nodes)

        header = BlockHeader(
            parent_hash=b"\x00" * 32,
            ommers_hash=EMPTY_OMMERS_HASH,
            beneficiary=spec.coinbase,
            state_root=state_root,
            transactions_root=EMPTY_TRIE_HASH,
            receipts_root=EMPTY_TRIE_HASH,
            logs_bloom=EMPTY_BLOOM,
            difficulty=spec.difficulty,
            number=0,
            gas_limit=spec.gas_limit,
            gas_used=0,
            unix_timestamp=spec.timestamp,
            extra_data=spec.extra_data,
            mix_hash=spec.mix_hash,
            nonce=spec.nonce,
        )
        genesis = Block(header, BlockBody())

        existing = self.get_header_by_number(0)
        if existing is not None and existing.hash != header.hash:
            raise ValueError(
                "stored genesis hash differs from computed genesis"
            )
        self.save_block(genesis, [], header.difficulty)
        return genesis
