"""Node discovery v4: Kademlia over UDP.

Parity: khipu-eth/.../network/rlpx/discovery/ —
NodeDiscoveryService.scala:68,135 (ping/pong/findnode/neighbours over
Akka UDP with RLP + signature), KRoutingTable.scala:23 + KBucket:286
(k=16 buckets, XOR distance). Packets follow the discv4 wire format:
hash(32) || signature(65) || packet-type(1) || rlp(body); node identity
is the 64-byte secp256k1 pubkey, node id distance = XOR of keccak256
of the pubkeys.
The port's copy of ``khipu_tpu.network.discovery``.
"""

from __future__ import annotations

import socket
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from khipu_tpu_torch.base.keccak import keccak256
from khipu_tpu_torch.base.secp256k1 import (
    SignatureError,
    ecdsa_recover,
    ecdsa_sign,
    privkey_to_pubkey,
)
from khipu_tpu_torch.base.rlp import rlp_decode, rlp_encode
from khipu_tpu_torch.evm.dataword import from_bytes, to_minimal_bytes

PING, PONG, FINDNODE, NEIGHBOURS = 0x01, 0x02, 0x03, 0x04
K_BUCKET = 16
EXPIRATION = 60


@dataclass(frozen=True)
class NodeRecord:
    pubkey: bytes  # 64 bytes
    ip: str
    udp_port: int
    tcp_port: int

    @property
    def node_id_hash(self) -> bytes:
        return keccak256(self.pubkey)

    def endpoint(self):
        return [
            socket.inet_aton(self.ip),
            to_minimal_bytes(self.udp_port),
            to_minimal_bytes(self.tcp_port),
        ]


def _distance(a: bytes, b: bytes) -> int:
    return int.from_bytes(a, "big") ^ int.from_bytes(b, "big")


class KRoutingTable:
    """XOR-metric buckets, k=16, LRU eviction of stale entries
    (KRoutingTable.scala:23)."""

    def __init__(self, self_pubkey: bytes):
        self.self_hash = keccak256(self_pubkey)
        self.buckets: List[List[NodeRecord]] = [[] for _ in range(256)]
        self._lock = threading.Lock()

    def _bucket_of(self, record: NodeRecord) -> int:
        d = _distance(self.self_hash, record.node_id_hash)
        return d.bit_length() - 1 if d else 0

    def add(self, record: NodeRecord) -> None:
        with self._lock:
            bucket = self.buckets[self._bucket_of(record)]
            for i, existing in enumerate(bucket):
                if existing.pubkey == record.pubkey:
                    del bucket[i]  # refresh to most-recent position
                    break
            bucket.append(record)
            if len(bucket) > K_BUCKET:
                bucket.pop(0)  # evict least-recently-seen

    def remove(self, pubkey: bytes) -> None:
        with self._lock:
            for bucket in self.buckets:
                for i, existing in enumerate(bucket):
                    if existing.pubkey == pubkey:
                        del bucket[i]
                        return

    def closest(self, target_hash: bytes, k: int = K_BUCKET) -> List[NodeRecord]:
        with self._lock:
            everyone = [r for bucket in self.buckets for r in bucket]
        return sorted(
            everyone, key=lambda r: _distance(r.node_id_hash, target_hash)
        )[:k]

    def __len__(self) -> int:
        return sum(len(b) for b in self.buckets)


def encode_packet(priv: bytes, ptype: int, body) -> bytes:
    data = bytes([ptype]) + rlp_encode(body)
    recid, r, s = ecdsa_sign(keccak256(data), priv)
    sig = r.to_bytes(32, "big") + s.to_bytes(32, "big") + bytes([recid])
    inner = sig + data
    return keccak256(inner) + inner


def decode_packet(packet: bytes) -> Tuple[bytes, int, object]:
    """-> (sender_pubkey, packet_type, body); raises on bad hash/sig."""
    if len(packet) < 32 + 65 + 1:
        raise ValueError("short packet")
    phash, sig, data = packet[:32], packet[32:97], packet[97:]
    if keccak256(packet[32:]) != phash:
        raise ValueError("bad packet hash")
    r = int.from_bytes(sig[:32], "big")
    s = int.from_bytes(sig[32:64], "big")
    pubkey = ecdsa_recover(keccak256(data), sig[64], r, s)
    return pubkey, data[0], rlp_decode(data[1:])


class DiscoveryService:
    """UDP ping/pong/findnode/neighbours responder + lookup client
    (NodeDiscoveryService.scala:68)."""

    def __init__(self, priv: bytes, ip: str = "127.0.0.1", port: int = 0):
        self.priv = priv
        self.pubkey = privkey_to_pubkey(priv)
        self.table = KRoutingTable(self.pubkey)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind((ip, port))
        self.ip, self.port = self.sock.getsockname()
        self._pongs: Dict[bytes, float] = {}
        self._sent_pings: Dict[bytes, float] = {}  # hash -> sent time
        self._pings_lock = threading.Lock()  # recv thread vs callers
        self._neighbours: List[list] = []
        self._running = False
        self._thread: Optional[threading.Thread] = None

    @property
    def record(self) -> NodeRecord:
        return NodeRecord(self.pubkey, self.ip, self.port, self.port)

    def start(self) -> None:
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        try:
            self.sock.close()
        except OSError:
            pass

    # ------------------------------------------------------------- wire

    def _expiration(self):
        return to_minimal_bytes(int(time.time()) + EXPIRATION)

    def ping(self, node: NodeRecord) -> None:
        body = [
            to_minimal_bytes(4),
            self.record.endpoint(),
            node.endpoint(),
            self._expiration(),
        ]
        packet = encode_packet(self.priv, PING, body)
        now = time.time()
        # prune unanswered pings older than the protocol expiration —
        # bounds memory and stops ancient pong replays being accepted
        with self._pings_lock:
            for h in [
                h for h, t in self._sent_pings.items()
                if now - t >= EXPIRATION
            ]:
                del self._sent_pings[h]
            self._sent_pings[packet[:32]] = now
        try:
            self.sock.sendto(packet, (node.ip, node.udp_port))
        except OSError:
            pass

    def find_node(self, node: NodeRecord, target_pub: bytes) -> None:
        self._send(node, FINDNODE, [target_pub, self._expiration()])

    def _send(self, node: NodeRecord, ptype: int, body) -> None:
        packet = encode_packet(self.priv, ptype, body)
        try:
            self.sock.sendto(packet, (node.ip, node.udp_port))
        except OSError:
            pass

    def _loop(self) -> None:
        while self._running:
            try:
                packet, addr = self.sock.recvfrom(1280)
            except OSError:
                return
            # any single malformed packet (bad RLP, short body, bogus
            # IP bytes) must never kill the receive thread — it is the
            # node's only ear
            try:
                pubkey, ptype, body = decode_packet(packet)
                self._handle(pubkey, addr, ptype, body, packet)
            except Exception:
                continue

    def _handle(self, pubkey, addr, ptype, body, packet: bytes) -> None:
        sender = NodeRecord(pubkey, addr[0], addr[1], addr[1])
        if ptype == PING:
            exp = from_bytes(body[3])
            if exp < time.time():
                return
            self.table.add(sender)
            # discv4: PONG echoes the PING packet's hash; peers drop
            # pongs that do not
            self._send(
                sender, PONG,
                [sender.endpoint(), packet[:32], self._expiration()],
            )
        elif ptype == PONG:
            # accept only pongs answering a ping WE sent (echoed hash
            # check) — unsolicited pongs would poison the table
            echoed = body[1]
            with self._pings_lock:
                sent_at = self._sent_pings.pop(echoed, None)
            if sent_at is None or time.time() - sent_at >= EXPIRATION:
                return
            self.table.add(sender)
            self._pongs[pubkey] = time.time()
        elif ptype == FINDNODE:
            target = body[0]
            closest = self.table.closest(keccak256(target))
            nodes = [
                r.endpoint()[:3] + [r.pubkey] for r in closest
            ]
            self._send(
                sender, NEIGHBOURS, [nodes, self._expiration()]
            )
        elif ptype == NEIGHBOURS:
            for item in body[0]:
                ip = socket.inet_ntoa(item[0])
                rec = NodeRecord(
                    item[3], ip, from_bytes(item[1]), from_bytes(item[2])
                )
                self._neighbours.append(rec)
                self.table.add(rec)

    # ------------------------------------------------------------ lookup

    def bootstrap(self, seeds: List[NodeRecord],
                  timeout: float = 2.0) -> int:
        """Ping seeds, then iteratively findnode toward ourselves until
        the table stops growing (the discv4 self-lookup)."""
        for seed in seeds:
            self.ping(seed)
        deadline = time.time() + timeout
        last = -1
        while time.time() < deadline:
            if len(self.table) != last:
                last = len(self.table)
                for node in self.table.closest(keccak256(self.pubkey)):
                    self.find_node(node, self.pubkey)
            time.sleep(0.05)
        return len(self.table)
