"""The port's JSON-RPC surface (jsonrpc/, ledger/simulate.py) against the
JAX package's, on the same chain.

The chain is built once by the JAX package's ChainBuilder: 32 accounts
(8 funded senders and 24 more), a block deploying an ERC-20 token that
emits the Transfer event (``workloads.ERC20_LOG_INIT``), then 4 blocks
of 6 token transfers over 12 holders; its fork leaves the chain after
block 3 (another miner, shifted amounts, one block longer). Each
package replays it into a node of its own (the port with its device
commit on the CPU: the plain K1r) and serves it through a
``JsonRpcServer`` with the serving plane, the personal namespace and a
fresh tracer. One fixed request list goes to both servers in process,
and the responses must be equal as JSON, with these exceptions:
``web3_clientVersion`` names the package; the values of
``khipu_metrics`` and of the observability reports (``khipu_traces``,
``khipu_trace_block``, ``khipu_window_report``, ``khipu_window_costs``)
hold each process's counters and clocks, so their keys are compared
(the reports' top-level keys: they read the process's movement ledger);
each registry holds instruments of its own package (the port's kernel
and VM gauges, the reference's fused-fallback ones), so the registry
snapshot inside ``khipu_metrics`` and ``khipu_metrics_text`` are
compared on the families of the serving, filter and chain surfaces,
and the maps keyed by what earlier work in the process recorded (the
phases traced, the seams fired) on their type;
``khipu_traces`` has no ``compileCache`` in the port (it has no fused
compile cache); ``khipu_dump_chrome_trace`` writes to a path of each
package's own; ``personal_newAccount`` makes a random key.
"""

import dataclasses
import functools
import json

import pytest

from khipu_tpu.base.crypto import secp256k1 as jx_secp
from khipu_tpu.config import SyncConfig as JxSyncConfig
from khipu_tpu.config import fixture_config as jx_fixture_config
from khipu_tpu.domain import block as jx_block
from khipu_tpu.domain import transaction as jx_tx
from khipu_tpu.domain.blockchain import Blockchain as JxBlockchain
from khipu_tpu.domain.blockchain import GenesisSpec as JxGenesisSpec
from khipu_tpu.storage.storages import Storages as JxStorages
from khipu_tpu.sync.chain_builder import ChainBuilder as JxChainBuilder

from khipu_tpu_torch import workloads

GWEI = 10**9
MINER_A = b"\xaa" * 20
MINER_B = b"\xbb" * 20
N_SENDERS = 6
N_HOLDERS = 12
N_TRANSFER_BLOCKS = 4
FORK_ANCESTOR = 3


def sender_keys():
    keys = [(900 + i).to_bytes(32, "big") for i in range(8)]
    return keys, [jx_secp.pubkey_to_address(jx_secp.privkey_to_pubkey(k))
                  for k in keys]


def holder(i):
    return (0xE40E4000 + i).to_bytes(20, "big")


def genesis_alloc():
    _, addrs = sender_keys()
    alloc = {a: 10**22 for a in addrs}
    alloc.update({(2**32 + i).to_bytes(20, "big"): 10**18 + i
                  for i in range(24)})
    return alloc


def token_address():
    _, addrs = sender_keys()
    return jx_tx.contract_address(addrs[0], 0)


def _sign(key, nonce, to, payload=b"", gas=100_000, value=0):
    return jx_tx.sign_transaction(
        jx_tx.Transaction(nonce, GWEI, gas, to, value, payload=payload),
        key, chain_id=1)


def jx_config(**sync):
    fields = dict(parallel_tx=False, commit_window_blocks=1)
    fields.update(sync)
    return dataclasses.replace(jx_fixture_config(chain_id=1),
                               sync=JxSyncConfig(**fields))


def _build(transfer_blocks, diverge_at=None, tail=0):
    """A deploy, then ``transfer_blocks`` token blocks (from
    ``diverge_at`` on forked: larger amounts, mined by ``MINER_B``),
    then ``tail`` more mined by ``MINER_A``."""
    keys, _ = sender_keys()
    cfg = jx_config()
    builder = JxChainBuilder(JxBlockchain(JxStorages(), cfg), cfg,
                             JxGenesisSpec(alloc=genesis_alloc()))
    token = token_address()
    blocks = [builder.add_block(
        [_sign(keys[0], 0, None, workloads.ERC20_LOG_INIT, gas=500_000)],
        coinbase=MINER_A, timestamp=10)]
    nonces = [1] + [0] * (N_SENDERS - 1)
    for n in range(transfer_blocks + tail):
        forked = (diverge_at is not None
                  and diverge_at <= n < transfer_blocks)
        txs = []
        for j in range(N_SENDERS):
            amount = 1_000 + 13 * j + n + (10**6 if forked else 0)
            payload = (holder((j + 5 * n) % N_HOLDERS).rjust(32, b"\x00")
                       + amount.to_bytes(32, "big"))
            txs.append(_sign(keys[j], nonces[j], token, payload))
            nonces[j] += 1
        blocks.append(builder.add_block(
            txs, coinbase=MINER_B if forked else MINER_A,
            timestamp=10 * (n + 2)))
    return blocks


@functools.lru_cache(maxsize=1)
def chain_wire():
    """The base chain and its fork, as block RLP: ``(base, fork)``.
    The fork shares blocks 1..``FORK_ANCESTOR`` and is one block
    longer."""
    base = _build(N_TRANSFER_BLOCKS)
    fork = _build(N_TRANSFER_BLOCKS + 1, diverge_at=FORK_ANCESTOR - 1)
    assert [b.hash for b in base[:FORK_ANCESTOR]] == [
        b.hash for b in fork[:FORK_ANCESTOR]]
    assert base[FORK_ANCESTOR].hash != fork[FORK_ANCESTOR].hash
    return ([b.encode() for b in base], [b.encode() for b in fork])


def port_blocks(wire):
    from khipu_tpu_torch.domain.block import Block

    return [Block.decode(w) for w in wire]


def jax_blocks(wire):
    return [jx_block.Block.decode(w) for w in wire]


def port_node(cfg=None, wire=None, read_view_of=None):
    """A port chain at the base chain's genesis, replayed through
    ``wire`` on the CPU (the device commit's plain versions)."""
    from khipu_tpu_torch.domain.blockchain import Blockchain, GenesisSpec
    from khipu_tpu_torch.storage.storages import Storages
    from khipu_tpu_torch.sync.replay import ReplayDriver

    cfg = cfg or workloads.replay_config()
    bc = Blockchain(Storages(), cfg)
    bc.load_genesis(GenesisSpec(alloc=genesis_alloc()), on_device=True,
                    device="cpu")
    if wire:
        ReplayDriver(bc, cfg, device_commit=True, device="cpu").replay(
            port_blocks(wire))
    return bc


def jax_node(cfg=None, wire=None):
    from khipu_tpu.sync.replay import ReplayDriver as JxReplayDriver

    cfg = cfg or jx_config()
    bc = JxBlockchain(JxStorages(), cfg)
    bc.load_genesis(JxGenesisSpec(alloc=genesis_alloc()))
    if wire:
        JxReplayDriver(bc, cfg).replay(jax_blocks(wire))
    return bc


# ------------------------------------------------------------- servers


def _servers(tmp_path):
    """One server a package over the replayed base chain: EthService
    with the serving plane's read view and admission, PersonalService
    over a keystore directory of its own, a fresh tracer."""
    base, _ = chain_wire()
    out = {}
    for name in ("port", "jax"):
        if name == "port":
            from khipu_tpu_torch.jsonrpc import (
                EthService,
                JsonRpcServer,
                PersonalService,
            )
            from khipu_tpu_torch.keystore import KeyStore
            from khipu_tpu_torch.observability.trace import Tracer
            from khipu_tpu_torch.serving import ServingPlane
            from khipu_tpu_torch.txpool import PendingTransactionsPool

            cfg = workloads.replay_config()
            bc = port_node(cfg, base)
        else:
            from khipu_tpu.jsonrpc import (
                EthService,
                JsonRpcServer,
                PersonalService,
            )
            from khipu_tpu.keystore import KeyStore
            from khipu_tpu.observability.trace import Tracer
            from khipu_tpu.serving import ServingPlane
            from khipu_tpu.txpool import PendingTransactionsPool

            cfg = jx_config()
            bc = jax_node(cfg, base)
        pool = PendingTransactionsPool()
        plane = ServingPlane.build(bc, cfg, tx_pool=pool)
        eth = EthService(bc, cfg, pool, tracer=Tracer(),
                         read_view=plane.read_view, serving=plane)
        personal = PersonalService(KeyStore(str(tmp_path / name)), bc, cfg,
                                   pool)
        out[name] = JsonRpcServer(eth, port=0, extra_services=(personal,),
                                  serving=plane)
    return out


def _hex(b):
    return "0x" + b.hex()


def request_list(tmp_path):
    """The fixed request list: every method both services answer, each
    tag form, errors, filters, batches and the personal namespace."""
    base, _ = chain_wire()
    blocks = jax_blocks(base)
    keys, addrs = sender_keys()
    token = token_address()
    b2 = blocks[1]
    tx = b2.body.transactions[2]
    topic = workloads.TRANSFER_TOPIC
    raw = _sign(keys[7], 0, holder(1), value=5, gas=21_000).encode()
    raw_low = _sign(keys[7], 0, holder(2), value=5, gas=21_000).encode()
    signed = _sign(keys[7], 1, holder(1), value=5, gas=21_000)
    bad_sig = jx_tx.SignedTransaction(signed.tx, signed.v, 0,
                                      signed.s).encode()
    transfer = (holder(3).rjust(32, b"\x00") + (77).to_bytes(32, "big"))
    personal_key = (0xC0FFEE).to_bytes(32, "big")
    personal_addr = _hex(jx_secp.pubkey_to_address(
        jx_secp.privkey_to_pubkey(personal_key)))
    slot = bytes(32)
    reqs = [
        ("web3_clientVersion", []),
        ("web3_sha3", ["0x68656c6c6f"]),
        ("net_version", []),
        ("net_listening", []),
        ("net_peerCount", []),
        ("eth_chainId", []),
        ("eth_protocolVersion", []),
        ("eth_blockNumber", []),
        ("eth_syncing", []),
        ("eth_mining", []),
        ("eth_hashrate", []),
        ("eth_accounts", []),
        ("eth_gasPrice", []),
    ]
    for a in (addrs[0], addrs[3], MINER_A, holder(4), token):
        for tag in ("latest", "earliest", "0x2", "pending", "safe"):
            reqs.append(("eth_getBalance", [_hex(a), tag]))
        reqs.append(("eth_getTransactionCount", [_hex(a), "latest"]))
    reqs += [
        ("eth_getBalance", [_hex(addrs[0]), "0x64"]),
        ("eth_getCode", [_hex(token), "latest"]),
        ("eth_getCode", [_hex(token), "0x0"]),
        ("eth_getStorageAt", [_hex(token), "0x0", "latest"]),
        ("eth_getStorageAt", [_hex(token), _hex(slot[:31] + b"\x01"),
                              "0x3"]),
        ("eth_getBlockByNumber", ["latest", False]),
        ("eth_getBlockByNumber", ["0x2", True]),
        ("eth_getBlockByNumber", ["earliest", False]),
        ("eth_getBlockByNumber", ["0x99", False]),
        ("eth_getBlockByHash", [_hex(b2.hash), True]),
        ("eth_getBlockByHash", [_hex(bytes(32)), False]),
        ("eth_getBlockTransactionCountByNumber", ["0x2"]),
        ("eth_getBlockTransactionCountByHash", [_hex(b2.hash)]),
        ("eth_getUncleCountByBlockNumber", ["latest"]),
        ("eth_getUncleCountByBlockHash", [_hex(b2.hash)]),
        ("eth_getUncleByBlockNumberAndIndex", ["0x2", "0x0"]),
        ("eth_getUncleByBlockHashAndIndex", [_hex(b2.hash), 0]),
        ("eth_getTransactionByHash", [_hex(tx.hash)]),
        ("eth_getTransactionByHash", [_hex(bytes(32))]),
        ("eth_getTransactionByBlockNumberAndIndex", ["0x2", "0x2"]),
        ("eth_getTransactionByBlockNumberAndIndex", ["0x2", "0x40"]),
        ("eth_getTransactionByBlockHashAndIndex", [_hex(b2.hash), "0x1"]),
        ("eth_getTransactionReceipt", [_hex(tx.hash)]),
        ("eth_getTransactionReceipt", [_hex(blocks[0].body.transactions[0]
                                            .hash)]),
        ("eth_getTransactionReceipt", [_hex(bytes(32))]),
        # the token: a transfer call, its estimate, a call under the
        # intrinsic gas, and both at a historic block
        ("eth_call", [{"from": _hex(addrs[1]), "to": _hex(token),
                       "data": _hex(transfer)}, "latest"]),
        ("eth_call", [{"to": _hex(token), "input": _hex(transfer),
                       "gas": "0x5208"}, "0x2"]),
        ("eth_call", [{"from": _hex(addrs[1]), "to": _hex(token),
                       "gas": "0x1"}, "latest"]),
        ("eth_call", [{"from": _hex(addrs[1]), "to": _hex(holder(5)),
                       "value": "0x1"}, "latest"]),
        ("eth_call", [{"from": _hex(addrs[1]),
                       "data": _hex(workloads.ERC20_LOG_INIT)}, "latest"]),
        ("eth_estimateGas", [{"from": _hex(addrs[1]), "to": _hex(token),
                              "data": _hex(transfer)}]),
        ("eth_estimateGas", [{"from": _hex(addrs[2]), "to": _hex(holder(6)),
                              "value": "0x10"}, "0x3"]),
        ("eth_estimateGas", [{"from": _hex(addrs[1]), "to": _hex(token),
                              "gas": "0x1"}]),
        ("eth_estimateGas", [{"from": _hex(addrs[1]),
                              "data": _hex(workloads.ERC20_LOG_INIT)}]),
        # logs: ranges, address and topic filters, the range cap
        ("eth_getLogs", [{"fromBlock": "0x0", "toBlock": "latest"}]),
        ("eth_getLogs", [{"fromBlock": "0x2", "toBlock": "0x3",
                          "address": _hex(token)}]),
        ("eth_getLogs", [{"fromBlock": "earliest",
                          "address": [_hex(token), _hex(holder(1))],
                          "topics": [_hex(topic), None,
                                     [_hex(holder(2).rjust(32, b"\x00")),
                                      _hex(holder(7).rjust(32, b"\x00"))]]}]),
        ("eth_getLogs", [{"fromBlock": "0x1",
                          "topics": [_hex(topic),
                                     _hex(addrs[2].rjust(32, b"\x00"))]}]),
        ("eth_getLogs", [{"fromBlock": "0x0", "address": _hex(holder(9))}]),
        ("eth_getLogs", [{"fromBlock": "0x0", "toBlock": "0x2711"}]),
        # filters: logs, blocks, pending txs
        ("eth_newFilter", [{"fromBlock": "0x2", "address": _hex(token)}]),
        ("eth_newBlockFilter", []),
        ("eth_newPendingTransactionFilter", []),
        ("eth_getFilterChanges", ["0x1"]),
        ("eth_getFilterChanges", ["0x1"]),
        ("eth_getFilterLogs", ["0x1"]),
        ("eth_getFilterChanges", ["0x2"]),
        ("eth_getFilterLogs", ["0x2"]),
        ("eth_getFilterChanges", ["0x77"]),
        # the pool: a send, its duplicate, an underpriced replacement,
        # a bad signature, then the pending views
        ("eth_sendRawTransaction", [_hex(raw)]),
        ("eth_sendRawTransaction", [_hex(raw)]),
        ("eth_sendRawTransaction", [_hex(raw_low)]),
        ("eth_sendRawTransaction", [_hex(bad_sig)]),
        ("eth_pendingTransactions", []),
        ("eth_getTransactionCount", [_hex(jx_secp.pubkey_to_address(
            jx_secp.privkey_to_pubkey(keys[7]))), "pending"]),
        ("eth_getFilterChanges", ["0x3"]),
        ("eth_getFilterChanges", ["0x3"]),
        ("eth_uninstallFilter", ["0x1"]),
        ("eth_uninstallFilter", ["0x1"]),
        ("eth_getFilterLogs", ["0x1"]),
        # the personal namespace and the signing eth_ methods
        ("personal_listAccounts", []),
        ("personal_importRawKey", [_hex(personal_key), "pw"]),
        ("personal_importRawKey", ["0x00", "pw"]),
        ("personal_listAccounts", []),
        ("personal_unlockAccount", [personal_addr, "wrong"]),
        ("personal_sign", ["0x68656c6c6f", personal_addr]),
        ("personal_unlockAccount", [personal_addr, "pw", "0x0"]),
        ("personal_sign", ["0x68656c6c6f", personal_addr]),
        ("personal_sign", ["0x6869", personal_addr, "pw"]),
        ("eth_sign", [personal_addr, "0x68656c6c6f"]),
        ("personal_ecRecover", ["0x68656c6c6f", "0x" + "11" * 65]),
        ("personal_ecRecover", ["0x68656c6c6f", "0x1234"]),
        ("personal_sendTransaction", [{"from": personal_addr,
                                       "to": _hex(holder(8)),
                                       "value": "0x10"}, "pw"]),
        ("personal_sendTransaction", [{"to": _hex(holder(8))}, "pw"]),
        ("eth_sendTransaction", [{"from": personal_addr,
                                  "to": _hex(holder(9)), "gas": "0x5208",
                                  "gasPrice": "0x3b9aca00",
                                  "data": "0x00ff"}]),
        ("eth_sendTransaction", [{"from": personal_addr, "nonce": "0x7",
                                  "to": _hex(holder(9))}]),
        ("personal_lockAccount", [personal_addr]),
        ("personal_lockAccount", [personal_addr]),
        ("eth_sendTransaction", [{"from": personal_addr,
                                  "to": _hex(holder(9))}]),
        ("eth_pendingTransactions", []),
        # the plane and the observability surface
        ("khipu_metrics", []),
        ("khipu_metrics_text", []),
        ("khipu_cluster_metrics_text", []),
        ("khipu_cluster_report", []),
        ("khipu_traces", []),
        ("khipu_trace_block", ["0x2"]),
        ("khipu_trace_block", [3]),
        ("khipu_window_report", ["0x2"]),
        ("khipu_window_costs", [2]),
        ("khipu_tx_journey", [_hex(tx.hash)]),
        ("khipu_dump_chrome_trace", [str(tmp_path / "trace_{name}.json")]),
        # dispatch errors
        ("eth_noSuchMethod", []),
        ("debug_traceBlock", []),
        ("eth_getBalance", []),
        ("eth_blockNumber", [1, 2]),
    ]
    return reqs


KEYS_ONLY = {"khipu_metrics", "khipu_traces", "khipu_trace_block",
             "khipu_window_report", "khipu_window_costs"}


def _keys_of(v, depth=None):
    if isinstance(v, dict) and depth != 0:
        return {k: _keys_of(x, None if depth is None else depth - 1)
                for k, x in v.items()}
    return type(v).__name__


# families the exposition must carry in both packages: the chain head,
# the filters, the plane's admission and SLO families
SHARED_FAMILIES = (
    "# TYPE khipu_best_block_number gauge",
    "# TYPE khipu_filters_active gauge",
    "# TYPE khipu_admission_limit gauge",
    "# TYPE khipu_rpc_latency_seconds histogram",
    "# TYPE khipu_rpc_requests_total counter",
)


# the registry families of the serving, filter and chain surfaces
REGISTRY_FAMILIES = (
    "khipu_best_block_number", "khipu_pending_txs",
    "khipu_store_cache_hit_rate", "khipu_filters_active",
    "khipu_filter_evictions_total", "khipu_admission_limit",
    "khipu_admission_inflight", "khipu_admission_shed_total",
    "khipu_admission_pressure", "khipu_admission_signal_pressure",
    "khipu_rpc_latency_seconds", "khipu_rpc_requests_total",
    "khipu_pipeline_depth", "khipu_pipeline_in_flight",
)


def _comparable(method, resp, name):
    resp = json.loads(json.dumps(resp))
    if method == "web3_clientVersion":
        assert resp["result"].startswith("khipu-tpu")
        resp["result"] = None
    elif method in KEYS_ONLY and "result" in resp:
        result = resp["result"]
        if method == "khipu_metrics":
            reg = result.pop("registry")
            result["registryFamilies"] = [f for f in REGISTRY_FAMILIES
                                          if f in reg]
            # maps keyed by what earlier work in the process recorded
            # (phases traced, seams fired): their shape, not their keys
            result["phaseLatency"] = type(result["phaseLatency"]).__name__
            faults = result["robustness"]["faults"]
            faults["bySite"] = type(faults["bySite"]).__name__
            resp["result"] = _keys_of(result)
        else:
            # the reports read the process's movement ledger and build
            # log beside the fresh ring: their top-level keys
            result.pop("compileCache", None)
            resp["result"] = _keys_of(result, depth=1)
    elif method == "khipu_metrics_text":
        text = resp.pop("result")
        resp["families"] = [f for f in SHARED_FAMILIES if f in text]
    elif method == "khipu_dump_chrome_trace" and "result" in resp:
        assert resp["result"]["path"].endswith(f"trace_{name}.json")
        resp["result"]["path"] = None
    elif method == "personal_newAccount":
        assert len(bytes.fromhex(resp["result"][2:])) == 20
        resp["result"] = None
    return resp


@pytest.fixture
def planes_off():
    """The journey boards and the movement ledgers are process globals
    that earlier tests in the process may have left on and filled: both
    packages' are off for the comparison (``khipu_tx_journey`` answers
    "not enabled") and the ledgers empty (``khipu_window_report`` and
    ``khipu_window_costs`` find no window), then back on where they
    were."""
    from khipu_tpu.observability.journey import JOURNEY as jx_journey
    from khipu_tpu.observability.profiler import LEDGER as jx_ledger

    from khipu_tpu_torch.observability.journey import JOURNEY as pt_journey
    from khipu_tpu_torch.observability.profiler import LEDGER as pt_ledger

    was = [(p, p.enabled) for p in (pt_journey, jx_journey, pt_ledger,
                                    jx_ledger)]
    for p, _ in was:
        p.disable()
    for ledger in (pt_ledger, jx_ledger):
        ledger.reset()
    yield
    for p, enabled in was:
        p.enabled = enabled


def test_every_method_answers_as_the_reference(tmp_path, planes_off):
    servers = _servers(tmp_path)
    got = {}
    for name, server in servers.items():
        out = []
        for i, (method, params) in enumerate(request_list(tmp_path)):
            if method == "khipu_dump_chrome_trace":
                params = [params[0].replace("{name}", name)]
            resp = server.handle({"jsonrpc": "2.0", "id": i,
                                  "method": method, "params": params})
            out.append((method, _comparable(method, resp, name)))
        got[name] = out
    for (method, pt), (_, jx) in zip(got["port"], got["jax"]):
        assert pt == jx, method
    results = dict(got["port"])
    assert results["khipu_metrics_text"]["families"] == list(
        SHARED_FAMILIES)
    assert "registryFamilies" in results["khipu_metrics"]["result"]
    # the comparison covered real answers: logs, a receipt with logs, a
    # retired-to-the-store read, pooled and signed transactions
    by = got["port"]
    logs = next(r for m, r in by if m == "eth_getLogs")["result"]
    assert len(logs) == N_SENDERS * N_TRANSFER_BLOCKS
    assert all(h["topics"][0] == _hex(workloads.TRANSFER_TOPIC)
               for h in logs)
    sends = [r for m, r in by if m == "eth_sendRawTransaction"]
    assert "result" in sends[0]
    assert [s["error"]["message"] for s in sends[1:]] == [
        "already known", "replacement transaction underpriced",
        "invalid signature"]
    calls = [r for m, r in by if m == "eth_call"]
    assert calls[0]["result"] == "0x" and calls[2]["error"]["code"] == -32000
    gas = [r for m, r in by if m == "eth_estimateGas"]
    assert int(gas[0]["result"], 16) > 21_000 and gas[1]["result"] == "0x5208"
    # personal_newAccount after the list: both answer with a new address
    for name, server in servers.items():
        resp = server.handle({"jsonrpc": "2.0", "id": 0,
                              "method": "personal_newAccount",
                              "params": ["pw2"]})
        _comparable("personal_newAccount", resp, name)


@pytest.mark.parametrize("request_", [
    [{"jsonrpc": "2.0", "id": 1, "method": "eth_blockNumber"},
     {"jsonrpc": "2.0", "id": 2, "method": "eth_chainId", "params": []},
     {"jsonrpc": "2.0", "id": 3, "method": "nope_x"}, 7],
    [{"jsonrpc": "2.0", "id": i, "method": "eth_gasPrice"}
     for i in range(101)],
    "not an object",
], ids=["batch", "batch_over_cap", "not_an_object"])
def test_batches_and_malformed_requests(tmp_path, request_):
    servers = _servers(tmp_path)
    got = {name: json.loads(json.dumps(s.handle(request_)))
           for name, s in servers.items()}
    assert got["port"] == got["jax"]


def test_browser_origin_cannot_sign(tmp_path):
    servers = _servers(tmp_path)
    req = {"jsonrpc": "2.0", "id": 1, "method": "personal_listAccounts",
           "params": []}
    got = {name: s.handle(req, browser_origin=True)
           for name, s in servers.items()}
    assert got["port"] == got["jax"]
    assert got["port"]["error"]["code"] == -32601


def test_http_server_round_trip(tmp_path):
    """Both servers on loopback: the same POSTs give the same bodies,
    the served-ms header rides each response, an oversized body is
    refused before it is read."""
    import http.client

    servers = _servers(tmp_path)
    bodies = [
        json.dumps({"jsonrpc": "2.0", "id": 1, "method": "eth_getBalance",
                    "params": [_hex(MINER_A), "latest"]}),
        json.dumps([{"jsonrpc": "2.0", "id": 2, "method": "eth_blockNumber"},
                    {"jsonrpc": "2.0", "id": 3,
                     "method": "eth_getBlockByNumber",
                     "params": ["0x1", False]}]),
        "{not json",
    ]
    got = {}
    try:
        for name, server in servers.items():
            port = server.start()
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
            out = []
            for body in bodies:
                conn.request("POST", "/", body.encode(),
                             {"Content-Type": "application/json"})
                resp = conn.getresponse()
                out.append(json.loads(resp.read()))
                assert resp.getheader("X-Khipu-Served-Ms") is not None
            # the header alone: the server answers before any body byte
            conn.putrequest("POST", "/")
            conn.putheader("Content-Length", str(server.max_body_bytes + 1))
            conn.endheaders()
            resp = conn.getresponse()
            out.append(json.loads(resp.read()))
            conn.close()
            got[name] = out
    finally:
        for server in servers.values():
            server.stop()
    assert got["port"] == got["jax"]
    assert got["port"][2]["error"]["code"] == -32700
    assert got["port"][3]["error"]["code"] == -32600


# ------------------------------------------------------------- simulate


def test_simulate_and_estimate_equal():
    """``simulate_call`` / ``estimate_gas`` on the token at each block of
    the chain: output, gas, logs and errors equal the reference's."""
    from khipu_tpu.ledger import simulate as jx_simulate

    from khipu_tpu_torch.ledger import simulate as pt_simulate

    base, _ = chain_wire()
    nodes = {"port": (port_node(wire=base), pt_simulate,
                      workloads.replay_config()),
             "jax": (jax_node(wire=base), jx_simulate, jx_config())}
    _, addrs = sender_keys()
    token = token_address()
    out = {}
    for name, (bc, mod, cfg) in nodes.items():
        rows = []
        for n in range(len(base) + 1):
            header = bc.get_header_by_number(n)
            for kw in (
                dict(sender=addrs[1], to=token,
                     data=holder(2).rjust(32, b"\x00") + (5).to_bytes(32,
                                                                     "big")),
                dict(sender=addrs[2], to=holder(3), value=10),
                dict(sender=addrs[2], data=workloads.ERC20_LOG_INIT),
                dict(sender=addrs[2], to=token, gas=22_000),
            ):
                r = mod.simulate_call(bc.get_world_state, header, cfg, **kw)
                rows.append((r.output, r.gas_used,
                             [(lg.address, tuple(lg.topics), lg.data)
                              for lg in r.logs], r.error, r.is_revert))
                try:
                    rows.append(mod.estimate_gas(bc.get_world_state, header,
                                                 cfg, **kw))
                except ValueError as e:
                    rows.append(str(e))
        out[name] = rows
    assert out["port"] == out["jax"]
    assert any(isinstance(r, tuple) and r[2] for r in out["port"])
