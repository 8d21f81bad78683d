"""Miner: seal blocks from the pending pool with Ethash.

Parity: mining/Miner.scala:40 + mining/BlockGenerator.scala:31 — the
generator prepares a block via the ledger (prepareBlock role: execute
pending txs, fill the roots), the miner searches a nonce whose
hashimoto result satisfies the difficulty bound, then the block is
saved and the mined txs leave the pool (RegularSyncService.scala:419).

The port's copy of ``khipu_tpu.mining``. With a ``peer_manager`` each
sealed block goes to peers through ``regular_sync.propagate_block``
(the full block to ceil(sqrt(peers)) of them, the hash announce to the
rest).
"""

from __future__ import annotations

from typing import List, Optional

from khipu_tpu_torch.base.keccak import keccak256
from khipu_tpu_torch.config import KhipuConfig
from khipu_tpu_torch.consensus.ethash import EthashCache, mine
from khipu_tpu_torch.domain.block import Block
from khipu_tpu_torch.domain.blockchain import Blockchain
from khipu_tpu_torch.ledger.ledger import BlockExecutionError
from khipu_tpu_torch.sync.chain_builder import ChainBuilder
from khipu_tpu_torch.txpool import PendingTransactionsPool


class Miner:
    def __init__(
        self,
        blockchain: Blockchain,
        config: KhipuConfig,
        tx_pool: PendingTransactionsPool,
        coinbase: bytes,
        ethash_cache: Optional[EthashCache] = None,
        full_size: Optional[int] = None,
        peer_manager=None,
        use_dataset: bool = False,
        dag_dir: Optional[str] = None,
    ):
        self.blockchain = blockchain
        self.config = config
        self.tx_pool = tx_pool
        self.coinbase = coinbase
        self.cache = ethash_cache  # None = seal-less (dev chains)
        self.full_size = full_size
        # miner-grade sealing: precompute + file-cache the full DAG
        # (EthashDataset) so each attempt costs ACCESSES reads instead
        # of ACCESSES x DATASET_PARENTS cache mixes
        # (Ethash.scala:65-164,196)
        self._dataset = None
        if use_dataset and ethash_cache is not None:
            from khipu_tpu_torch.consensus.ethash import EthashDataset

            self._dataset = EthashDataset(
                ethash_cache, full_size, cache_dir=dag_dir
            )
        self._builder = ChainBuilder.from_head(blockchain, config)
        # with a peer manager, every sealed block is pushed to peers
        # (BroadcastNewBlocks role, RegularSyncService.scala:306)
        self.peer_manager = peer_manager

    def _select_txs(self) -> List:
        """Pending txs ordered (sender, nonce); invalid ones dropped at
        execution time by retrying without the offender."""
        txs = self.tx_pool.pending()
        return sorted(
            txs, key=lambda t: (t.sender or b"", t.tx.nonce)
        )

    def mine_next(self) -> Block:
        """Prepare, (optionally) seal, save one block; returns it."""
        head = self.blockchain.get_block_by_number(
            self.blockchain.best_block_number
        )
        self._builder.head = head
        txs = self._select_txs()
        while True:
            try:
                block = self._builder.add_block(
                    tuple(txs), coinbase=self.coinbase
                )
                break
            except BlockExecutionError as e:
                # drop the offending tx (stale nonce / drained balance)
                index = getattr(e, "index", None)
                if index is None or index >= len(txs):
                    raise
                evicted = txs.pop(index)
                self.tx_pool.remove_mined([evicted])
        if self.cache is not None:
            # re-seal: mine a nonce over the prepared header
            header = block.header
            pow_hash = keccak256(header.encode_without_nonce())
            if self._dataset is not None:
                from khipu_tpu_torch.consensus.ethash import mine_full

                nonce, mix = mine_full(
                    self._dataset, pow_hash, header.difficulty
                )
            else:
                nonce, mix = mine(
                    self.cache, pow_hash, header.difficulty,
                    full_size=self.full_size,
                )
            import dataclasses

            sealed_header = dataclasses.replace(
                header, nonce=nonce.to_bytes(8, "big"), mix_hash=mix
            )
            # re-save under the sealed hash: save_block OVERWRITES the
            # number-keyed stores in place (no window where header N is
            # missing for concurrent readers); only the stale unsealed
            # hash->number mapping is dropped afterwards
            sealed = Block(sealed_header, block.body)
            receipts = self.blockchain.get_receipts(block.number) or []
            td = self.blockchain.get_total_difficulty(block.number) or 0
            unsealed_hash = block.hash
            self.blockchain.save_block(sealed, receipts, td)
            self.blockchain.storages.block_numbers.remove(unsealed_hash)
            self._builder.head = sealed
            block = sealed
        self.tx_pool.remove_mined(block.body.transactions)
        if self.peer_manager is not None:
            from khipu_tpu_torch.sync.regular_sync import propagate_block

            td = self.blockchain.get_total_difficulty(block.number) or 0
            propagate_block(self.peer_manager, block, td)
        return block
