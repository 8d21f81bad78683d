"""Block world state: write-log worlds + race sets + merge algebra.

Parity: ledger/BlockWorldState.scala:152 (TrieAccounts + per-address
TrieStorage + code map + accountDeltas :59-95,193 + raceConditions
:53-57; merge :341-385; flush :303; persist :312; rootHash :171),
ledger/TrieAccounts.scala:33 and ledger/TrieStorage.scala:20 (write-log
caches over the MPT, zero-value store ⇒ Removed :43-50).

Design differences from the Scala (deliberate, same semantics):

* Worlds are *mutable with O(dirty) snapshots* — ``copy()`` shallow-
  copies the write-log dicts while sharing the parent-root tries and
  the backing node storages. The reference's persistent-collection
  copy-on-write becomes explicit checkpointing at call-frame and tx
  boundaries, which is both faster in CPython and exactly the places
  the reference forks worlds.
* Race tracking is split read/write the way §5.2 describes: reads
  record (category, address[, key]) in ``reads``; writes land in the
  write logs themselves plus ``written`` category sets. ``merge``
  checks reads(later) ∩ writes(earlier) per category — sound for the
  fixed sequential order (a later tx's writes cannot invalidate an
  earlier tx's reads).
* Commutative deltas: per-tx nonce/balance changes are kept as
  *deltas* against the parent snapshot (AccountDelta,
  BlockWorldState.scala:59-95), so two parallel txs crediting the same
  address merge without conflict as long as neither *read* it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Set, Tuple

from khipu_tpu_torch.base.keccak import keccak256
from khipu_tpu_torch.domain.account import (
    EMPTY_CODE_HASH,
    EMPTY_STORAGE_ROOT,
    Account,
    address_key,
)
from khipu_tpu_torch.base.rlp import rlp_decode, rlp_encode
from khipu_tpu_torch.evm.dataword import from_bytes, to_minimal_bytes
from khipu_tpu_torch.trie.mpt import MerklePatriciaTrie

# Race categories (BlockWorldState.scala:53-57).
ON_ADDRESS = "address"  # existence / deadness
ON_ACCOUNT = "account"  # nonce / balance
ON_STORAGE = "storage"  # a (address, key) cell
ON_CODE = "code"


@dataclass
class AccountDelta:
    """Commutative part of an account mutation (BlockWorldState.scala:59)."""

    nonce: int = 0
    balance: int = 0

    def __iadd__(self, other: "AccountDelta") -> "AccountDelta":
        self.nonce += other.nonce
        self.balance += other.balance
        return self


class TrieStorage:
    """Write-log cache over one account's storage trie
    (TrieStorage.scala:20). Keys/values are ints; zero value ⇒ Removed
    (:43-50). The underlying trie is the parent-root snapshot and is
    never mutated — logs hold the dirty cells."""

    __slots__ = ("trie", "logs")

    def __init__(self, trie: MerklePatriciaTrie, logs: Optional[Dict[int, int]] = None):
        self.trie = trie
        self.logs = logs if logs is not None else {}

    @staticmethod
    def key_bytes(key: int) -> bytes:
        return keccak256(key.to_bytes(32, "big"))

    def load(self, key: int) -> int:
        if key in self.logs:
            return self.logs[key]
        return self.load_original(key)

    def load_original(self, key: int) -> int:
        """Committed (start-of-tx) value — EIP-2200's 'original'."""
        raw = self.trie.get(self.key_bytes(key))
        if raw is None:
            return 0
        return from_bytes(rlp_decode(raw))

    def store(self, key: int, value: int) -> None:
        self.logs[key] = value

    def copy(self) -> "TrieStorage":
        return TrieStorage(self.trie, dict(self.logs))

    def is_dirty(self) -> bool:
        return bool(self.logs)

    def dirty_pairs(self):
        """(upserts, removes) in trie-key form — zero value => remove
        (TrieStorage.scala:43-50)."""
        upserts, removes = [], []
        for key, value in self.logs.items():
            kb = self.key_bytes(key)
            if value == 0:
                removes.append(kb)
            else:
                upserts.append((kb, rlp_encode(to_minimal_bytes(value))))
        return upserts, removes

    def flush_into(self, trie: MerklePatriciaTrie, hasher=None) -> MerklePatriciaTrie:
        upserts, removes = self.dirty_pairs()
        if hasher is not None:
            from khipu_tpu_torch.trie.deferred import batch_commit

            return batch_commit(trie, upserts, removes, hasher)
        for kb in removes:
            trie = trie.remove(kb)
        for kb, enc in upserts:
            trie = trie.put(kb, enc)
        return trie


class BlockWorldState:
    """One world = parent-root account trie + per-tx write logs.

    ``accounts`` is the account write log: address -> Account | None
    (None = deleted). ``deltas`` accumulates the commutative nonce/
    balance part per address. ``reads``/``written`` drive the merge
    algebra. ``touched`` feeds EIP-161 dead-account deletion.
    """

    def __init__(
        self,
        account_trie: MerklePatriciaTrie,
        storage_source,
        evmcode_source,
        get_block_hash=None,
        account_start_nonce: int = 0,
    ):
        self.account_trie = account_trie  # parent-root snapshot
        self.storage_source = storage_source
        self.evmcode_source = evmcode_source
        self.get_block_hash = get_block_hash or (lambda n: None)
        self.account_start_nonce = account_start_nonce

        self.accounts: Dict[bytes, Optional[Account]] = {}
        # parent-trie account memo: the parent root is immutable for the
        # world's lifetime and Account is frozen, so lookups memoize;
        # SHARED by reference across copy() (rebound after flush()).
        self._tacct: Dict[bytes, Optional[Account]] = {}
        self.deltas: Dict[bytes, AccountDelta] = {}
        self.storages: Dict[bytes, TrieStorage] = {}
        self.codes: Dict[bytes, bytes] = {}  # address -> code written
        self.touched: Set[bytes] = set()
        # tx-scoped SELFDESTRUCT set: follows frame checkpoint/rollback
        # via copy(), unions across merge() (substate semantics)
        self.selfdestructed: Set[bytes] = set()

        # merge algebra bookkeeping
        self.reads: Dict[str, Set] = {
            ON_ADDRESS: set(),
            ON_ACCOUNT: set(),
            ON_STORAGE: set(),
            ON_CODE: set(),
        }
        self.written: Dict[str, Set] = {
            ON_ADDRESS: set(),
            ON_ACCOUNT: set(),
            ON_STORAGE: set(),
            ON_CODE: set(),
        }

    # ---------------------------------------------------------- snapshot

    def copy(self) -> "BlockWorldState":
        """Call-frame checkpoint. ``reads`` is SHARED by reference, not
        copied: a reverted frame still *observed* state, so its read
        races must survive the rollback (Ledger.runVM:728-733 merges
        race flags from reverted checkpoints). ``written`` is copied —
        a reverted write genuinely did not happen."""
        w = BlockWorldState.__new__(BlockWorldState)
        w.account_trie = self.account_trie
        w.storage_source = self.storage_source
        w.evmcode_source = self.evmcode_source
        w.get_block_hash = self.get_block_hash
        w.account_start_nonce = self.account_start_nonce
        w.accounts = dict(self.accounts)
        w._tacct = self._tacct
        w.deltas = {a: AccountDelta(d.nonce, d.balance) for a, d in self.deltas.items()}
        w.storages = {a: s.copy() for a, s in self.storages.items()}
        w.codes = dict(self.codes)
        w.touched = set(self.touched)
        w.selfdestructed = set(self.selfdestructed)
        w.reads = self.reads
        w.written = {k: set(v) for k, v in self.written.items()}
        return w

    # ------------------------------------------------------------- reads

    def _trie_account(self, address: bytes) -> Optional[Account]:
        cache = self._tacct
        if address in cache:
            return cache[address]
        raw = self.account_trie.get(address_key(address))
        acc = Account.decode(raw) if raw is not None else None
        cache[address] = acc
        return acc

    def _current_account(self, address: bytes) -> Optional[Account]:
        """Materialized view: log entry (or parent trie) + pending
        deltas. Accounts that exist only through a delta credit
        materialize from the start nonce."""
        if address in self.accounts:
            acc = self.accounts[address]
        else:
            acc = self._trie_account(address)
        d = self.deltas.get(address)
        if d is not None and (d.nonce or d.balance):
            if acc is None:
                acc = Account(nonce=self.account_start_nonce)
            acc = Account(
                nonce=acc.nonce + d.nonce,
                balance=acc.balance + d.balance,
                storage_root=acc.storage_root,
                code_hash=acc.code_hash,
            )
        return acc

    def get_account(self, address: bytes) -> Optional[Account]:
        self.reads[ON_ACCOUNT].add(address)
        return self._current_account(address)

    def get_guaranteed_account(self, address: bytes) -> Account:
        return self.get_account(address) or Account(nonce=self.account_start_nonce)

    def account_exists(self, address: bytes) -> bool:
        self.reads[ON_ADDRESS].add(address)
        return self._current_account(address) is not None

    def is_dead(self, address: bytes) -> bool:
        """EIP-161 dead: non-existent or empty."""
        self.reads[ON_ADDRESS].add(address)
        self.reads[ON_ACCOUNT].add(address)
        acc = self._current_account(address)
        return acc is None or acc.is_empty

    def get_balance(self, address: bytes) -> int:
        self.reads[ON_ACCOUNT].add(address)
        acc = self._current_account(address)
        return acc.balance if acc else 0

    def get_nonce(self, address: bytes) -> int:
        self.reads[ON_ACCOUNT].add(address)
        acc = self._current_account(address)
        return acc.nonce if acc else self.account_start_nonce

    def get_code(self, address: bytes) -> bytes:
        self.reads[ON_CODE].add(address)
        if address in self.codes:
            return self.codes[address]
        acc = self._current_account(address)
        if acc is None or acc.code_hash == EMPTY_CODE_HASH:
            return b""
        code = self.evmcode_source.get(acc.code_hash)
        return code if code is not None else b""

    def get_code_hash(self, address: bytes) -> bytes:
        self.reads[ON_CODE].add(address)
        if address in self.codes:
            return keccak256(self.codes[address])
        acc = self._current_account(address)
        return acc.code_hash if acc else EMPTY_CODE_HASH

    def _storage_for(self, address: bytes) -> TrieStorage:
        ts = self.storages.get(address)
        if ts is None:
            acc = self._current_account(address)
            root = acc.storage_root if acc else EMPTY_STORAGE_ROOT
            trie = MerklePatriciaTrie(self.storage_source, root_hash=root)
            ts = self.storages[address] = TrieStorage(trie)
        return ts

    def get_storage(self, address: bytes, key: int) -> int:
        self.reads[ON_STORAGE].add((address, key))
        return self._storage_for(address).load(key)

    def get_original_storage(self, address: bytes, key: int) -> int:
        self.reads[ON_STORAGE].add((address, key))
        return self._storage_for(address).load_original(key)

    # ------------------------------------------------------------ writes

    def save_storage(self, address: bytes, key: int, value: int) -> None:
        self.written[ON_STORAGE].add((address, key))
        self._storage_for(address).store(key, value)
        self.touched.add(address)

    def save_account(self, address: bytes, account: Account) -> None:
        """Absolute account write (non-commutative)."""
        self.written[ON_ACCOUNT].add(address)
        self.accounts[address] = account
        self.touched.add(address)

    def _delta(self, address: bytes) -> AccountDelta:
        """Commutative delta ledger entry. When the delta is what brings
        the account into existence, mark the creation as an ON_ADDRESS
        write so parallel existence-reads conflict; the parent-trie
        existence probe itself is NOT a recorded read (the parent
        snapshot is immutable and shared — no tx can race it)."""
        self.written[ON_ACCOUNT].add(address)
        if address not in self.accounts and address not in self.deltas \
                and self._trie_account(address) is None:
            self.written[ON_ADDRESS].add(address)
        d = self.deltas.get(address)
        if d is None:
            d = self.deltas[address] = AccountDelta()
        return d

    def add_balance(self, address: bytes, amount: int) -> None:
        """Commutative credit/debit (BlockWorldState.scala:59-95): does
        NOT count as an account read, so two txs crediting the same
        address merge conflict-free."""
        self._delta(address).balance += amount
        self.touched.add(address)

    def increase_nonce(self, address: bytes, by: int = 1) -> None:
        self._delta(address).nonce += by
        self.touched.add(address)

    def initialize_if_missing(self, address: bytes) -> None:
        """Pre-EIP-161 CALL/SELFDESTRUCT target creation: touching a
        nonexistent account materializes an empty one."""
        if not self.account_exists(address):
            self.written[ON_ADDRESS].add(address)
            self.written[ON_ACCOUNT].add(address)
            self.accounts[address] = Account(nonce=self.account_start_nonce)
        self.touched.add(address)

    def transfer(self, sender: bytes, to: bytes, value: int) -> None:
        """Value transfer; caller has already validated the balance."""
        if value == 0 or sender == to:
            self.touched.add(sender)
            self.touched.add(to)
            return
        self.add_balance(sender, -value)
        self.add_balance(to, value)

    def create_account(self, address: bytes, nonce: int, balance: int = 0) -> None:
        """Fresh contract account (CREATE): absolute write, clears any
        inherited code/storage logs."""
        self.written[ON_ADDRESS].add(address)
        self.written[ON_ACCOUNT].add(address)
        self.written[ON_CODE].add(address)
        self.accounts[address] = Account(nonce=nonce, balance=balance)
        self.deltas.pop(address, None)
        self.storages[address] = TrieStorage(
            MerklePatriciaTrie(self.storage_source)
        )
        self.codes[address] = b""
        self.touched.add(address)

    def save_code(self, address: bytes, code: bytes) -> None:
        self.written[ON_CODE].add(address)
        self.codes[address] = code
        self.touched.add(address)

    def delete_account(self, address: bytes) -> None:
        """End-of-tx deletion (SELFDESTRUCT target or EIP-161 dead)."""
        self.written[ON_ADDRESS].add(address)
        self.written[ON_ACCOUNT].add(address)
        self.written[ON_CODE].add(address)
        self.accounts[address] = None
        self.deltas.pop(address, None)
        self.storages.pop(address, None)
        self.codes.pop(address, None)

    def touch(self, address: bytes) -> None:
        self.touched.add(address)

    # ----------------------------------------------------- merge algebra

    def merge(self, later: "BlockWorldState") -> Optional[Set[bytes]]:
        """Try to merge ``later`` (a tx world executed against the same
        parent root) into this world (txs 0..i-1 already applied).

        Returns None on success (self now includes later's effects), or
        the conflicting address set — caller re-executes the tx serially
        (BlockWorldState.merge:341-385; Ledger.scala:393-434).
        """
        conflicts: Set[bytes] = set()
        for cat in (ON_ADDRESS, ON_ACCOUNT, ON_CODE):
            inter = later.reads[cat] & self.written[cat]
            conflicts |= inter
        for addr, key in later.reads[ON_STORAGE] & self.written[ON_STORAGE]:
            conflicts.add(addr)
        if conflicts:
            return conflicts

        # apply: absolute account writes are last-writer (no earlier tx
        # wrote what later read, so later's absolutes are correct);
        # deltas add (mergeAccountTrieAccount:366-385).
        for addr, acc in later.accounts.items():
            # Absolute writes (create/delete) are always preceded by an
            # existence/collision read in the VM, so reaching here means
            # no earlier tx disturbed what later saw: last-writer-wins.
            if acc is None:
                self.delete_account(addr)
            else:
                self.accounts[addr] = acc
        for addr, delta in later.deltas.items():
            d = self.deltas.get(addr)
            if d is None:
                d = self.deltas[addr] = AccountDelta()
            d += delta
        for addr, ts in later.storages.items():
            if not ts.is_dirty():
                continue
            mine = self._storage_for(addr)
            mine.logs.update(ts.logs)
            self.written[ON_STORAGE].update(
                (addr, k) for k in ts.logs
            )
        for addr, code in later.codes.items():
            self.codes[addr] = code
        self.touched |= later.touched
        self.selfdestructed |= later.selfdestructed
        for cat in self.written:
            self.written[cat] |= later.written[cat]
        for cat in self.reads:
            self.reads[cat] |= later.reads[cat]
        return None

    # --------------------------------------------------- commit / root

    def _materialized_accounts(
        self, hasher=None, window=None
    ) -> Dict[bytes, Optional[Account]]:
        """Resolve logs + deltas + dirty storages + codes into final
        Account records per touched address. With ``window``, dirty
        storage tries flush into the window's shared deferred session
        and storage_root becomes a placeholder ref (resolved at window
        finalize)."""
        out: Dict[bytes, Optional[Account]] = {}
        addresses = (
            set(self.accounts)
            | set(self.deltas)
            | {a for a, s in self.storages.items() if s.is_dirty()}
            | set(self.codes)
        )
        for addr in addresses:
            if addr in self.accounts and self.accounts[addr] is None:
                out[addr] = None  # deleted
                continue
            d = self.deltas.get(addr)
            has_other = (
                addr in self.accounts
                or addr in self.codes
                or (addr in self.storages and self.storages[addr].is_dirty())
            )
            if not has_other and (d is None or (d.nonce == 0 and d.balance == 0)):
                # A net-zero delta and nothing else: no state change.
                # Mirrors _current_account's (nonce or balance) guard —
                # without it a zero-amount credit (zero-fee pay, 0-wei
                # selfdestruct payout) would conjure an empty account
                # into the trie that consensus never creates.
                continue
            acc = self.accounts.get(addr) or self._trie_account(addr) or Account(
                nonce=self.account_start_nonce
            )
            d = self.deltas.get(addr)
            if d is not None:
                acc = Account(
                    nonce=acc.nonce + d.nonce,
                    balance=acc.balance + d.balance,
                    storage_root=acc.storage_root,
                    code_hash=acc.code_hash,
                )
            code = self.codes.get(addr)
            if code is not None:
                acc = Account(
                    nonce=acc.nonce,
                    balance=acc.balance,
                    storage_root=acc.storage_root,
                    code_hash=keccak256(code) if code else EMPTY_CODE_HASH,
                )
            ts = self.storages.get(addr)
            if ts is not None and ts.is_dirty():
                if window is not None:
                    session = window.storage_session(ts.trie._root_ref)
                    upserts, removes = ts.dirty_pairs()
                    for kb in removes:
                        session = session.remove(kb)
                    for kb, enc in upserts:
                        session = session.put(kb, enc)
                    root32 = session.force_hashed_root()
                    acc = Account(
                        nonce=acc.nonce,
                        balance=acc.balance,
                        storage_root=root32,
                        code_hash=acc.code_hash,
                    )
                else:
                    new_trie = ts.flush_into(ts.trie, hasher)
                    acc = Account(
                        nonce=acc.nonce,
                        balance=acc.balance,
                        storage_root=new_trie.root_hash,
                        code_hash=acc.code_hash,
                    )
                    self._flushed_storage_tries[addr] = new_trie
            out[addr] = acc
        return out

    def flush(self, hasher=None) -> "BlockWorldState":
        """Push all logs into the account trie (flush():303). Returns
        self with account_trie advanced and logs cleared; storage-trie
        and code changes are retained for persist().

        With ``hasher`` set, every trie commit (storage tries + the
        account trie) runs through the level-synchronous deferred path
        (trie.deferred.batch_commit) — one batched Keccak call per node
        level (K1r on the card for ``device_hasher``). hasher=None keeps
        the eager host MPT (the bit-exactness oracle); the port never
        turns ``None`` into a default device hasher here.

        flush() is idempotent-safe: a second call (persist() after an
        in-place root validation) ACCUMULATES into the pending storage
        tries / codes instead of discarding the first flush's output."""
        if not hasattr(self, "_flushed_storage_tries"):
            self._flushed_storage_tries: Dict[bytes, MerklePatriciaTrie] = {}
        final = self._materialized_accounts(hasher)
        upserts, removes = [], []
        for addr in sorted(final):
            acc = final[addr]
            key = address_key(addr)
            if acc is None:
                removes.append(key)
            else:
                upserts.append((key, acc.encode()))
        if hasher is not None:
            from khipu_tpu_torch.trie.deferred import batch_commit

            self.account_trie = batch_commit(
                self.account_trie, upserts, removes, hasher
            )
        else:
            trie = self.account_trie
            for key in removes:
                trie = trie.remove(key)
            for key, enc in upserts:
                trie = trie.put(key, enc)
            self.account_trie = trie
        pending = getattr(self, "_pending_codes", {})
        pending.update(
            (keccak256(code), code) for code in self.codes.values() if code
        )
        self._pending_codes = pending
        self.accounts.clear()
        self.deltas.clear()
        self.storages.clear()
        self.codes.clear()
        self._tacct = {}  # the parent root advanced: old memo is stale
        return self

    @property
    def root_hash(self) -> bytes:
        """Root after the current logs — computed on a copy so the
        pre-flush world stays intact (TrieAccounts.scala:73-80)."""
        return self.copy().flush().account_trie.root_hash

    def persist(self, account_node_storage, storage_node_storage,
                evmcode_storage, hasher=None) -> bytes:
        """flush + write dirty nodes to the three NodeStorages
        (persist():312-330). Returns the new state root."""
        self.flush(hasher)
        for trie in getattr(self, "_flushed_storage_tries", {}).values():
            removed, upserts = trie.changes()
            storage_node_storage.update(removed, upserts)
        removed, upserts = self.account_trie.changes()
        account_node_storage.update(removed, upserts)
        for code_hash, code in getattr(self, "_pending_codes", {}).items():
            evmcode_storage.put(code_hash, code)
        self.account_trie = self.account_trie.persist()
        return self.account_trie.root_hash
