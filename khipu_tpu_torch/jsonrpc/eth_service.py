"""eth_* / net_* / web3_* method implementations.

Parity: jsonrpc/EthService.scala (getBalance/call/estimateGas/
getBlockByNumber/... backed by Blockchain + Ledger.simulateTransaction),
NetService, Web3Service. Hex-string codecs follow the JSON-RPC spec
("quantities" minimal-hex, "data" even-length 0x-prefixed).

The port's copy of ``khipu_tpu.jsonrpc.eth_service``: the same methods,
error codes and JSON shapes. The observability RPCs read the port's
plane (``observability/``). The sharded cluster and its telemetry
federation are not ported (ROADMAP A11): ``cluster=`` and
``telemetry=`` raise ``NotImplementedError``, and the cluster RPCs
answer as the reference does with no telemetry attached. With a read
view, a state read at a head tag that falls through to the store
executes at the view's ``committed_header()`` (the highest header at or
below best whose state is stored: best, or mid-window an earlier one),
where the reference reads best's state root and can meet a missing node
(ROADMAP §C).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

from khipu_tpu_torch.base.keccak import keccak256
from khipu_tpu_torch.config import KhipuConfig
from khipu_tpu_torch.domain.block import Block
from khipu_tpu_torch.domain.blockchain import Blockchain
from khipu_tpu_torch.domain.transaction import (
    SignedTransaction,
    contract_address,
)
from khipu_tpu_torch.jsonrpc.filters import FilterManager, LogQuery, get_logs
from khipu_tpu_torch.ledger.simulate import estimate_gas, simulate_call
from khipu_tpu_torch.observability import costmodel, export, recorder
from khipu_tpu_torch.observability.journey import JOURNEY
from khipu_tpu_torch.observability.registry import REGISTRY
from khipu_tpu_torch.observability.trace import tracer as _default_tracer
from khipu_tpu_torch.txpool import PendingTransactionsPool

CLIENT_VERSION = "khipu-tpu-torch/0.3"


class RpcError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


def qty(n: int) -> str:
    return hex(n)


def data(b: Optional[bytes]) -> Optional[str]:
    return "0x" + b.hex() if b is not None else None


def parse_qty(s: Union[str, int]) -> int:
    if isinstance(s, int):
        return s
    return int(s, 16)


def parse_data(s: str) -> bytes:
    return bytes.fromhex(s[2:] if s.startswith("0x") else s)


class EthService:
    def __init__(
        self,
        blockchain: Blockchain,
        config: KhipuConfig,
        tx_pool: Optional[PendingTransactionsPool] = None,
        cluster=None,
        tracer=None,
        read_view=None,
        serving=None,
        telemetry=None,
        reorg_manager=None,
    ):
        if cluster is not None or telemetry is not None:
            raise NotImplementedError(
                "the sharded cluster and its telemetry are not ported "
                "(ROADMAP A11)"
            )
        self.blockchain = blockchain
        self.config = config
        # `is None`, not `or`: an EMPTY pool is falsy (__len__ == 0),
        # and `or` would silently swap the caller's pool for a private
        # one — sendRawTransaction would then land txs the rest of the
        # node (miner, pressure signals) never sees
        self.tx_pool = (
            tx_pool if tx_pool is not None else PendingTransactionsPool()
        )
        # read-your-writes overlay (serving/readview.py): when set,
        # account reads at latest/pending resolve through it so
        # executed-but-not-yet-persisted window state is visible and
        # per-key reads never regress mid-pipeline
        self.read_view = read_view
        # the serving plane (admission + SLO), surfaced in
        # khipu_metrics; dispatch-side enforcement lives in
        # JsonRpcServer, which holds the same object
        self.serving = serving
        # the flight recorder the khipu_traces / khipu_dump_chrome_trace
        # RPCs serve from (a board-owned instance when embedded in a
        # ServiceBoard; the process default otherwise)
        self.tracer = tracer if tracer is not None else _default_tracer
        # eager: a lazy-init race under concurrent RPC threads could
        # orphan one client's installed filter ids
        self._filter_manager = FilterManager(
            blockchain, ttl=config.serving.filter_ttl
        )
        # chain switches retract delivered logs (`removed: true`) and
        # rewind filter cursors to the fork point (sync/reorg.py)
        if reorg_manager is not None:
            reorg_manager.add_listener(self._filter_manager.note_reorg)
        # chain-head + store-cache samples for the unified registry
        # (replace-by-key: the newest service owns the slot)
        REGISTRY.register_collector("chain", self._registry_samples)

    def _registry_samples(self) -> list:
        s = self.blockchain.storages
        out = [
            ("khipu_best_block_number", "gauge", {},
             self.blockchain.best_block_number),
            ("khipu_pending_txs", "gauge", {}, len(self.tx_pool)),
        ]
        for name, store in (
            ("account", s.account_node_storage),
            ("storage", s.storage_node_storage),
            ("evmcode", s.evmcode_storage),
        ):
            lb = {"store": name}
            out.append(("khipu_store_cache_hit_rate", "gauge", lb,
                        round(store.cache_hit_rate, 4)))
            out.append(("khipu_store_cache_reads_total", "counter", lb,
                        store.cache_read_count))
        return out

    # ------------------------------------------------------- block tags

    def _resolve_block(self, tag: Union[str, int]) -> int:
        if isinstance(tag, int):
            return tag
        if tag in ("latest", "pending", "safe", "finalized"):
            return self.blockchain.best_block_number
        if tag == "earliest":
            return 0
        return parse_qty(tag)

    def _header(self, tag):
        if self.read_view is not None and tag in self._HEAD_TAGS:
            # the head's committed state: mid-window the store holds an
            # earlier block's (serving/readview.py)
            return self.read_view.committed_header()
        n = self._resolve_block(tag)
        h = self.blockchain.get_header_by_number(n)
        if h is None:
            raise RpcError(-32000, f"unknown block {tag}")
        return h

    # ------------------------------------------------------------- web3

    def web3_clientVersion(self) -> str:
        return CLIENT_VERSION

    def web3_sha3(self, payload: str) -> str:
        return data(keccak256(parse_data(payload)))

    def net_version(self) -> str:
        return str(self.config.blockchain.chain_id)

    def eth_chainId(self) -> str:
        return qty(self.config.blockchain.chain_id)

    def eth_protocolVersion(self) -> str:
        return qty(63)  # PV63 (SURVEY §2.7 wire messages)

    # -------------------------------------------------------------- eth

    # tags the ReadView overlay serves (numeric/historic tags always
    # read the committed store — the overlay only covers the head)
    _HEAD_TAGS = ("latest", "pending", "safe", "finalized")

    def eth_blockNumber(self) -> str:
        if self.read_view is not None:
            return qty(self.read_view.head_number())
        return qty(self.blockchain.best_block_number)

    def eth_getBalance(self, address: str, tag="latest") -> str:
        addr = parse_data(address)
        if self.read_view is not None and tag in self._HEAD_TAGS:
            _, acc = self.read_view.get_account(addr)
            return qty(acc.balance if acc else 0)
        header = self._header(tag)
        acc = self.blockchain.get_account(addr, header.state_root)
        return qty(acc.balance if acc else 0)

    def eth_getTransactionCount(self, address: str, tag="latest") -> str:
        addr = parse_data(address)
        if self.read_view is not None and tag in self._HEAD_TAGS:
            _, acc = self.read_view.get_account(addr)
            count = acc.nonce if acc else 0
        else:
            header = self._header(tag)
            acc = self.blockchain.get_account(addr, header.state_root)
            count = acc.nonce if acc else 0
        if tag == "pending":
            # pooled txs advance the usable nonce (wallets pick the next
            # nonce from the pending count)
            count += sum(
                1 for stx in self.tx_pool.pending() if stx.sender == addr
            )
        return qty(count)

    def eth_getCode(self, address: str, tag="latest") -> str:
        header = self._header(tag)
        world = self.blockchain.get_world_state(header.state_root)
        return data(world.get_code(parse_data(address)))

    def eth_getStorageAt(self, address: str, slot: str, tag="latest") -> str:
        header = self._header(tag)
        world = self.blockchain.get_world_state(header.state_root)
        value = world.get_storage(parse_data(address), parse_qty(slot))
        return data(value.to_bytes(32, "big"))

    def eth_gasPrice(self) -> str:
        return qty(10**9)

    def eth_getBlockTransactionCountByNumber(self, tag) -> Optional[str]:
        block = self.blockchain.get_block_by_number(
            self._resolve_block(tag)
        )
        return qty(len(block.body.transactions)) if block else None

    def eth_getUncleCountByBlockNumber(self, tag) -> Optional[str]:
        block = self.blockchain.get_block_by_number(
            self._resolve_block(tag)
        )
        return qty(len(block.body.ommers)) if block else None

    def _number_of_hash(self, block_hash: str) -> Optional[int]:
        return self.blockchain.storages.block_numbers.number_of(
            parse_data(block_hash)
        )

    def eth_getBlockTransactionCountByHash(self, block_hash: str):
        n = self._number_of_hash(block_hash)
        return (
            None if n is None
            else self.eth_getBlockTransactionCountByNumber(n)
        )

    def eth_getUncleCountByBlockHash(self, block_hash: str):
        n = self._number_of_hash(block_hash)
        return None if n is None else self.eth_getUncleCountByBlockNumber(n)

    def eth_getTransactionByBlockNumberAndIndex(self, tag, index):
        n = self._resolve_block(tag)
        i = index if isinstance(index, int) else int(str(index), 16)
        block = self.blockchain.get_block_by_number(n)
        if block is None or i >= len(block.body.transactions):
            return None
        return self._tx_json(block.body.transactions[i], block, i)

    def eth_getTransactionByBlockHashAndIndex(self, block_hash: str, index):
        n = self._number_of_hash(block_hash)
        if n is None:
            return None
        return self.eth_getTransactionByBlockNumberAndIndex(n, index)

    def _uncle_json(self, block, i: int):
        if block is None or i >= len(block.body.ommers):
            return None
        # EthService.getUncleByBlockHashAndIndex: a header-only block
        # JSON (uncles carry no body)
        u = block.body.ommers[i]
        return {
            "number": qty(u.number),
            "hash": data(u.hash),
            "parentHash": data(u.parent_hash),
            "miner": data(u.beneficiary),
            "stateRoot": data(u.state_root),
            "difficulty": qty(u.difficulty),
            "gasLimit": qty(u.gas_limit),
            "gasUsed": qty(u.gas_used),
            "timestamp": qty(u.unix_timestamp),
            "extraData": data(u.extra_data),
            "uncles": [],
            "transactions": [],
        }

    def eth_getUncleByBlockNumberAndIndex(self, tag, index):
        i = index if isinstance(index, int) else int(str(index), 16)
        block = self.blockchain.get_block_by_number(self._resolve_block(tag))
        return self._uncle_json(block, i)

    def eth_getUncleByBlockHashAndIndex(self, block_hash: str, index):
        n = self._number_of_hash(block_hash)
        if n is None:
            return None
        return self.eth_getUncleByBlockNumberAndIndex(n, index)

    def net_listening(self) -> bool:
        return True

    def net_peerCount(self) -> str:
        manager = getattr(self, "peer_manager", None)
        alive = (
            sum(1 for p in manager.peers if p.alive) if manager else 0
        )
        return qty(alive)

    def eth_accounts(self):
        # keystore-backed accounts surface through personal_listAccounts;
        # the bare node exposes none (reference returns the same)
        return []

    def eth_mining(self) -> bool:
        return getattr(self, "miner", None) is not None

    def eth_hashrate(self) -> str:
        return qty(0)  # external miners report via submitHashrate (absent)

    def eth_getBlockByNumber(self, tag, full_txs: bool = False):
        n = self._resolve_block(tag)
        block = self.blockchain.get_block_by_number(n)
        if block is None:
            return None
        return self._block_json(block, full_txs)

    def eth_getBlockByHash(self, block_hash: str, full_txs: bool = False):
        n = self.blockchain.storages.block_numbers.number_of(
            parse_data(block_hash)
        )
        if n is None:
            return None
        return self.eth_getBlockByNumber(n, full_txs)

    def eth_getTransactionByHash(self, tx_hash: str):
        h = parse_data(tx_hash)
        loc = self.blockchain.storages.transaction_storage.get(h)
        if loc is None:
            pending = self.tx_pool.get(h)
            if pending is None:
                return None
            return self._tx_json(pending, None, None)
        number, index = loc
        block = self.blockchain.get_block_by_number(number)
        if block is None or index >= len(block.body.transactions):
            return None
        return self._tx_json(block.body.transactions[index], block, index)

    def eth_getTransactionReceipt(self, tx_hash: str):
        h = parse_data(tx_hash)
        loc = self.blockchain.storages.transaction_storage.get(h)
        if loc is None:
            return None
        number, index = loc
        block = self.blockchain.get_block_by_number(number)
        receipts = self.blockchain.get_receipts(number)
        if block is None or receipts is None or index >= len(receipts):
            return None
        r = receipts[index]
        prev_gas = receipts[index - 1].cumulative_gas_used if index else 0
        stx = block.body.transactions[index]
        # logIndex is the log's position within the BLOCK (spec), so
        # count the logs of every earlier receipt first
        log_base = sum(len(rc.logs) for rc in receipts[:index])
        out: Dict[str, Any] = {
            "transactionHash": data(h),
            "transactionIndex": qty(index),
            "blockHash": data(block.hash),
            "blockNumber": qty(number),
            "from": data(stx.sender),
            "to": data(stx.tx.to),
            "contractAddress": (
                data(contract_address(stx.sender, stx.tx.nonce))
                if stx.tx.is_contract_creation and stx.sender
                else None
            ),
            "cumulativeGasUsed": qty(r.cumulative_gas_used),
            "gasUsed": qty(r.cumulative_gas_used - prev_gas),
            "logsBloom": data(r.logs_bloom),
            "logs": [
                {
                    "address": data(log.address),
                    "topics": [data(t) for t in log.topics],
                    "data": data(log.data),
                    "blockNumber": qty(number),
                    "blockHash": data(block.hash),
                    "transactionHash": data(h),
                    "transactionIndex": qty(index),
                    "logIndex": qty(log_base + i),
                }
                for i, log in enumerate(r.logs)
            ],
        }
        if isinstance(r.post_tx_state, int):
            out["status"] = qty(r.post_tx_state)
        else:
            out["root"] = data(r.post_tx_state)
        return out

    def eth_call(self, call: dict, tag="latest") -> str:
        header = self._header(tag)
        result = simulate_call(
            self.blockchain.get_world_state, header, self.config,
            **self._call_kwargs(call),
        )
        if result.is_revert:
            raise RpcError(3, "execution reverted: 0x" + result.output.hex())
        if result.error:
            raise RpcError(-32000, result.error)
        return data(result.output)

    def eth_estimateGas(self, call: dict, tag="latest") -> str:
        header = self._header(tag)
        try:
            return qty(
                estimate_gas(
                    self.blockchain.get_world_state, header, self.config,
                    **self._call_kwargs(call),
                )
            )
        except ValueError as e:
            raise RpcError(-32000, str(e))

    def eth_sendRawTransaction(self, raw: str) -> str:
        stx = SignedTransaction.decode(parse_data(raw))
        if stx.sender is None:
            raise RpcError(-32000, "invalid signature")
        if JOURNEY.enabled:
            # passport ingress: the tx entered through the serving
            # plane — the trace id of the serving ring rides along so
            # the journey links into the merged chrome trace
            JOURNEY.record(
                stx.hash, "ingress", source="rpc",
                trace_id=(self.tracer.trace_id
                          if self.tracer is not None
                          and self.tracer.enabled else None),
            )
        if not self.tx_pool.add(stx):
            # geth parity: a rejected add is an ERROR, not a silent
            # hash — the wallet must know its tx is not in the pool
            if self.tx_pool.get(stx.hash) is not None:
                raise RpcError(-32000, "already known")
            raise RpcError(
                -32000, "replacement transaction underpriced"
            )
        return data(stx.hash)

    def eth_pendingTransactions(self) -> List[dict]:
        return [
            self._tx_json(stx, None, None) for stx in self.tx_pool.pending()
        ]

    def eth_syncing(self):
        return False

    # ------------------------------------------------------- logs/filters

    def _parse_log_query(self, params: dict):
        from_block = self._resolve_block(params.get("fromBlock", "latest"))
        to_raw = params.get("toBlock", "latest")
        # "latest"/"pending" stay a MOVING head (None) so installed
        # filters keep following the tip; numeric tags pin the range
        if to_raw in ("latest", "pending", "safe", "finalized"):
            to_block = None
        else:
            to_block = self._resolve_block(to_raw)
        addr = params.get("address")
        if addr is None:
            addresses = ()
        elif isinstance(addr, list):
            addresses = tuple(parse_data(a) for a in addr)
        else:
            addresses = (parse_data(addr),)
        topics = []
        for t in params.get("topics", []) or []:
            if t is None:
                topics.append(())
            elif isinstance(t, list):
                topics.append(tuple(parse_data(x) for x in t))
            else:
                topics.append((parse_data(t),))
        return LogQuery(from_block, to_block, addresses, tuple(topics))

    @staticmethod
    def _log_json(hit) -> dict:
        return {
            "address": data(hit.address),
            "topics": [data(t) for t in hit.topics],
            "data": data(hit.data),
            "blockNumber": qty(hit.block_number),
            "blockHash": data(hit.block_hash),
            "transactionHash": data(hit.tx_hash),
            "transactionIndex": qty(hit.tx_index),
            "logIndex": qty(hit.log_index),
            "removed": bool(getattr(hit, "removed", False)),
        }

    def _check_log_range(self, query) -> None:
        upper = (
            query.to_block
            if query.to_block is not None
            else self.blockchain.best_block_number
        )
        if upper - query.from_block > 10_000:
            raise RpcError(-32005, "block range too large (max 10000)")

    def eth_getLogs(self, params: dict) -> list:
        query = self._parse_log_query(params)
        self._check_log_range(query)
        return [
            self._log_json(h) for h in get_logs(self.blockchain, query)
        ]

    @property
    def _filters(self):
        return self._filter_manager

    def eth_newFilter(self, params: dict) -> str:
        return qty(self._filters.new_log_filter(
            self._parse_log_query(params)
        ))

    def eth_newBlockFilter(self) -> str:
        return qty(self._filters.new_block_filter())

    def eth_newPendingTransactionFilter(self) -> str:
        return qty(self._filters.new_pending_tx_filter(self.tx_pool))

    def eth_getFilterLogs(self, fid: str) -> list:
        """Full (non-delta) result set of an installed log filter."""
        query = self._filters.get_log_query(parse_qty(fid))
        if query is None:
            raise RpcError(-32000, "filter not found")
        self._check_log_range(query)  # same DoS cap as eth_getLogs
        return [
            self._log_json(h)
            for h in get_logs(self.blockchain, query)
        ]

    def eth_uninstallFilter(self, fid: str) -> bool:
        return self._filters.uninstall(parse_qty(fid))

    def eth_getFilterChanges(self, fid: str) -> list:
        out = self._filters.changes(parse_qty(fid))
        if out is None:
            raise RpcError(-32000, "filter not found")
        return [
            data(x) if isinstance(x, bytes) else self._log_json(x)
            for x in out
        ]

    def khipu_metrics(self) -> dict:
        """Metrics surface (SURVEY §5.5): storage counters + clocks +
        chain head, one structured snapshot."""
        s = self.blockchain.storages
        out = {
            "bestBlockNumber": self.blockchain.best_block_number,
            "pendingTxs": len(self.tx_pool),
            "stores": {},
        }
        for name, store in (
            ("account", s.account_node_storage),
            ("storage", s.storage_node_storage),
            ("evmcode", s.evmcode_storage),
        ):
            src = store.source
            out["stores"][name] = {
                "cacheHitRate": round(store.cache_hit_rate, 4),
                "cacheReadCount": store.cache_read_count,
                "count": getattr(src, "count", None),
                "readSeconds": round(src.clock.elapsed_ns / 1e9, 6)
                if hasattr(src, "clock") else None,
            }
        # window-pipeline gauges (sync/replay.PIPELINE_GAUGES): depth,
        # windows sealed/collected/in-flight, driver stall vs collector
        # busy seconds, and the occupancy fraction of the last run
        from khipu_tpu_torch.sync.replay import PIPELINE_GAUGES

        out["pipeline"] = {
            "depth": PIPELINE_GAUGES["depth"],
            "inFlight": PIPELINE_GAUGES["in_flight"],
            "windowsSealed": PIPELINE_GAUGES["windows_sealed"],
            "windowsCollected": PIPELINE_GAUGES["windows_collected"],
            "occupancy": PIPELINE_GAUGES["occupancy"],
            "driverStallSeconds": PIPELINE_GAUGES["driver_stall_s"],
            "collectorBusySeconds": PIPELINE_GAUGES["collector_busy_s"],
            "collectorDeaths": PIPELINE_GAUGES["collector_deaths"],
            "syncFallbackWindows": PIPELINE_GAUGES[
                "sync_fallback_windows"
            ],
        }
        # robustness gauges: fused->host fallbacks (always 0 here: an
        # error at fused.dispatch stops the port's replay instead of
        # degrading the window), WAL depth, fired chaos faults
        from khipu_tpu_torch.chaos import fault_log

        out["robustness"] = {
            "fusedFallbacks": 0,
            "journalDepth": (
                s.window_journal.depth
                if self.config.sync.commit_journal else 0
            ),
            "faults": fault_log.snapshot(),
        }
        # serving plane (serving/__init__.py): admission limits /
        # sheds, per-method SLO evaluation + error budget, read-view
        # overlay occupancy
        if self.serving is not None:
            out["serving"] = self.serving.snapshot()
        elif self.read_view is not None:
            out["serving"] = {"readView": self.read_view.snapshot()}
        # installed-filter occupancy + TTL evictions (jsonrpc/filters)
        out["filters"] = self._filter_manager.snapshot()
        # the unified-registry superset: every registered instrument +
        # pull collector in one consistent snapshot (the same samples
        # khipu_metrics_text exposes), plus the per-phase latency
        # histograms the recorder feeds, flattened for dashboards
        reg = REGISTRY.snapshot()
        out["registry"] = reg
        hist = reg.get("khipu_phase_latency_seconds")
        out["phaseLatency"] = {}
        if isinstance(hist, dict):
            for lk, v in hist.items():
                if not isinstance(v, dict):
                    continue
                phase = lk.split('"')[1] if '"' in lk else lk
                out["phaseLatency"][phase] = {
                    "count": v["count"],
                    "sumSeconds": v["sum"],
                }
        return out

    def khipu_metrics_text(self) -> str:
        """Prometheus text exposition (format 0.0.4) of the unified
        registry — the same samples ``khipu_metrics`` serves under
        ``registry``, as a scraper-ready document."""
        return REGISTRY.prometheus_text()

    def khipu_cluster_metrics_text(self) -> str:
        """Merged cluster exposition: the cluster telemetry plane is
        not ported (ROADMAP A11), so this answers as the reference does
        with none attached."""
        raise RpcError(-32000, "cluster telemetry not enabled")

    def khipu_cluster_report(self) -> dict:
        """Cluster health report: as ``khipu_cluster_metrics_text``,
        the telemetry plane is not ported (ROADMAP A11)."""
        raise RpcError(-32000, "cluster telemetry not enabled")

    def khipu_traces(self) -> dict:
        """Flight-recorder summary (observability/export.snapshot):
        ring/drop counters, traced block numbers, per-phase latency
        percentiles, occupancy timeline and compile-cache pressure."""
        return export.snapshot(tracer_=self.tracer)

    def khipu_trace_block(self, number) -> dict:
        """Full lifecycle record of ONE block: every span tagged with
        (or covering) its number, grouped into the canonical
        announce -> import -> window.build -> ... -> window.persist
        phase order with cross-thread parent links intact."""
        n = parse_qty(number) if isinstance(number, str) else int(number)
        return export.trace_block(n, tracer_=self.tracer)

    def khipu_tx_journey(self, tx_hash) -> dict:
        """One transaction's passport (observability/journey.py): the
        ordered lifecycle events it crossed — ingress, pool, schedule
        decision (batch + lane), execute lane, seal, journal-intent,
        durable, reorg retraction/re-inclusion, per-replica visibility
        — each with a monotonic timestamp, absolute wall time, the
        stamping node, and the owning flight-recorder trace id (the
        exemplar link into the merged chrome trace)."""
        if not JOURNEY.enabled:
            raise RpcError(-32000, "tx journeys not enabled")
        h = parse_data(tx_hash) if isinstance(tx_hash, str) else tx_hash
        rec = JOURNEY.export(h)
        if rec is None:
            raise RpcError(
                -32000,
                "no journey for this tx (evicted, unsampled, or "
                "never seen)",
            )
        return rec

    def khipu_window_report(self, number) -> dict:
        """Data-movement record of the window containing block ``n``:
        phase x bytes x site from the TransferLedger (which bytes
        crossed the host↔device boundary, from which call site, during
        which pipeline phase), collect traffic classified into
        placeholder-resolution vs store-write vs block-save, merged
        with the span-derived phase wall seconds when the ring still
        holds the window's spans."""
        n = parse_qty(number) if isinstance(number, str) else int(number)
        return recorder.window_report(n, self.tracer.snapshot())

    def khipu_window_costs(self, number) -> dict:
        """Roofline verdict for the window containing block ``n``:
        per-seal-sub-phase attainable vs achieved seconds against the
        calibrated floors (docs/roofline.md — tunnel rate, dispatch
        RTT, kernel hash rate), each classified bytes-bound /
        dispatch-bound / compute-bound / fixed-overhead, plus the
        headline verdict naming the costliest sub-phase."""
        n = parse_qty(number) if isinstance(number, str) else int(number)
        return costmodel.window_costs(
            n, self.tracer.snapshot(), tracer_=self.tracer
        )

    def khipu_dump_chrome_trace(self, path: str) -> dict:
        """Write the ring's spans as Chrome trace_event JSON (load in
        perfetto / chrome://tracing); returns {path, spans, shards}.
        The merge of shard rings comes with the cluster (ROADMAP A11),
        so ``shards`` is 0."""
        spans = self.tracer.snapshot()
        export.dump_chrome_trace(path, spans, tracer_=self.tracer)
        return {"path": path, "spans": len(spans), "shards": 0}

    # ------------------------------------------------------------ codecs

    @staticmethod
    def _call_kwargs(call: dict) -> dict:
        out: Dict[str, Any] = {}
        if call.get("from"):
            out["sender"] = parse_data(call["from"])
        if call.get("to"):
            out["to"] = parse_data(call["to"])
        if call.get("gas"):
            out["gas"] = parse_qty(call["gas"])
        if call.get("gasPrice"):
            out["gas_price"] = parse_qty(call["gasPrice"])
        if call.get("value"):
            out["value"] = parse_qty(call["value"])
        if call.get("data") or call.get("input"):
            out["data"] = parse_data(call.get("data") or call.get("input"))
        return out

    def _tx_json(self, stx: SignedTransaction, block, index):
        tx = stx.tx
        return {
            "hash": data(stx.hash),
            "nonce": qty(tx.nonce),
            "from": data(stx.sender),
            "to": data(tx.to),
            "value": qty(tx.value),
            "gas": qty(tx.gas_limit),
            "gasPrice": qty(tx.gas_price),
            "input": data(tx.payload),
            "v": qty(stx.v),
            "r": qty(stx.r),
            "s": qty(stx.s),
            "blockHash": data(block.hash) if block else None,
            "blockNumber": qty(block.number) if block else None,
            "transactionIndex": qty(index) if index is not None else None,
        }

    def _block_json(self, block: Block, full_txs: bool):
        h = block.header
        return {
            "number": qty(h.number),
            "hash": data(block.hash),
            "parentHash": data(h.parent_hash),
            "sha3Uncles": data(h.ommers_hash),
            "miner": data(h.beneficiary),
            "stateRoot": data(h.state_root),
            "transactionsRoot": data(h.transactions_root),
            "receiptsRoot": data(h.receipts_root),
            "logsBloom": data(h.logs_bloom),
            "difficulty": qty(h.difficulty),
            "totalDifficulty": qty(
                self.blockchain.get_total_difficulty(h.number) or 0
            ),
            "gasLimit": qty(h.gas_limit),
            "gasUsed": qty(h.gas_used),
            "timestamp": qty(h.unix_timestamp),
            "extraData": data(h.extra_data),
            "mixHash": data(h.mix_hash),
            "nonce": data(h.nonce),
            "size": qty(len(block.encode())),
            "transactions": [
                self._tx_json(tx, block, i) if full_txs else data(tx.hash)
                for i, tx in enumerate(block.body.transactions)
            ],
            "uncles": [data(o.hash) for o in block.body.ommers],
        }
