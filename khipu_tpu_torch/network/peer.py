"""Peer connections over TCP: RLPx handshake -> Hello -> Status ->
message loop; plus the peer registry with blacklisting.

Parity: network/PeerManager.scala:40 (approve/create peer entities),
network/PeerEntity.scala:83 (per-peer mailbox, request-response
correlation), handshake/EtcHandshake.scala:161 (Hello exchange ->
Status -> fork check), blockchain/sync/HandshakedPeersService.scala
(blacklist with duration). Akka actors become one reader thread per
peer + callback dispatch; the snappy threshold follows p2p >= 5.
The port's copy of ``khipu_tpu.network.peer``.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from khipu_tpu_torch.base.secp256k1 import privkey_to_pubkey
from khipu_tpu_torch.network import snappy_codec
from khipu_tpu_torch.network.messages import (
    DISCONNECT,
    ETH_OFFSET,
    HELLO,
    PING,
    PONG,
    STATUS,
    Hello,
    Status,
    decode_message,
    encode_message,
)
from khipu_tpu_torch.network.rlpx import AuthHandshake, FrameCodec
from khipu_tpu_torch.base.rlp import rlp_encode
from khipu_tpu_torch.evm.dataword import to_minimal_bytes


class PeerError(Exception):
    pass


def recv_exact(sock: socket.socket, n: int) -> bytes:
    out = b""
    while len(out) < n:
        chunk = sock.recv(n - len(out))
        if not chunk:
            raise PeerError("connection closed")
        out += chunk
    return out


class Peer:
    """One live connection. ``request(code, body)`` sends and blocks for
    the matching response code (PeerEntity's ask pattern)."""

    def __init__(self, sock: socket.socket, codec: FrameCodec,
                 remote_pub: bytes, inbound: bool):
        self.sock = sock
        self.codec = codec
        self.remote_pub = remote_pub
        self.inbound = inbound
        self.hello: Optional[Hello] = None
        self.status: Optional[Status] = None
        self.snappy = False
        self._send_lock = threading.Lock()
        # code -> FIFO of (Event, result-box) waiters
        self._waiters: Dict[int, list] = {}
        self._wlock = threading.Lock()
        self.handlers: Dict[int, Callable] = {}
        self.alive = True
        self._reader: Optional[threading.Thread] = None

    # ------------------------------------------------------------- wire

    def send(self, code: int, body) -> None:
        payload_body = rlp_encode(body)
        if self.snappy and code != HELLO:
            payload_body = snappy_codec.compress(payload_body)
        payload = rlp_encode(to_minimal_bytes(code)) + payload_body
        with self._send_lock:
            self.sock.sendall(self.codec.write_frame(payload))

    def _recv_exact(self, n: int) -> bytes:
        return recv_exact(self.sock, n)

    def recv(self) -> Tuple[int, object]:
        size = self.codec.read_header(self._recv_exact(32))
        wire = self._recv_exact(FrameCodec.frame_wire_size(size))
        payload = self.codec.read_frame(size, wire)
        code = 0 if payload[0] == 0x80 else payload[0]
        body_bytes = payload[1:]
        if self.snappy and code != HELLO:
            body_bytes = snappy_codec.decompress(body_bytes)
        from khipu_tpu_torch.base.rlp import rlp_decode

        return code, rlp_decode(body_bytes)

    # -------------------------------------------------------- handshakes

    def exchange_hello(self, client_id: str, node_id: bytes) -> Hello:
        self.send(HELLO, Hello(client_id, node_id=node_id).body())
        code, body = self.recv()
        if code == DISCONNECT:
            raise PeerError(f"disconnected during hello: {body}")
        if code != HELLO:
            raise PeerError(f"expected Hello, got {code}")
        self.hello = Hello.from_body(body)
        # snappy from p2p v5 (MessageCodec.scala role)
        self.snappy = self.hello.p2p_version >= 5
        return self.hello

    def exchange_status(self, status: Status) -> Status:
        self.send(ETH_OFFSET + STATUS, status.body())
        code, body = self.recv()
        if code != ETH_OFFSET + STATUS:
            raise PeerError(f"expected Status, got {code}")
        remote = Status.from_body(body)
        if remote.genesis_hash != status.genesis_hash:
            raise PeerError("genesis mismatch")
        if remote.network_id != status.network_id:
            raise PeerError("network id mismatch")
        self.status = remote
        return remote

    # ------------------------------------------------------ message loop

    def start_loop(self) -> None:
        # the connect timeout bounded the handshake; past it the reader
        # waits for the next frame however long the peer stays quiet (a
        # request bounds its own wait), else an idle peer would drop
        self.sock.settimeout(None)
        self._reader = threading.Thread(target=self._loop, daemon=True)
        self._reader.start()

    def _loop(self) -> None:
        try:
            while self.alive:
                code, body = self.recv()
                if code == PING:
                    self.send(PONG, [])
                    continue
                if code == DISCONNECT:
                    self.alive = False
                    break
                with self._wlock:
                    waiters = self._waiters.get(code)
                    if waiters:
                        event, box = waiters.pop(0)
                        box.append(body)
                        event.set()
                        continue
                handler = self.handlers.get(code)
                if handler is not None:
                    try:
                        reply = handler(body)
                        if reply is not None:
                            self.send(reply[0], reply[1])
                    except Exception:
                        pass
        except Exception:
            self.alive = False

    def request(self, send_code: int, body, reply_code: int,
                timeout: float = 5.0):
        """Send and block for the reply code (ask pattern)."""
        event = threading.Event()
        box: list = []
        waiter = (event, box)
        with self._wlock:
            self._waiters.setdefault(reply_code, []).append(waiter)
        try:
            self.send(send_code, body)
            deadline = time.time() + timeout
            while True:
                remaining = deadline - time.time()
                if remaining <= 0:
                    if event.is_set():  # reply landed at the buzzer
                        return box[0]
                    raise PeerError(f"timeout awaiting code {reply_code}")
                # wake periodically to notice a dead peer
                if event.wait(min(remaining, 0.25)):
                    return box[0]
                if not self.alive:
                    raise PeerError("peer died awaiting reply")
        finally:
            # drop the waiter if unanswered — a stale box would swallow
            # the NEXT reply for this code and desync pairing forever
            with self._wlock:
                waiters = self._waiters.get(reply_code, [])
                if waiter in waiters and not box:
                    waiters.remove(waiter)

    def disconnect(self, reason: int = 0x08) -> None:
        try:
            self.send(DISCONNECT, [to_minimal_bytes(reason)])
        except Exception:
            pass
        self.alive = False
        try:
            # wakes this peer's own reader, blocked in recv
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


@dataclass
class Blacklist:
    """Timed peer blacklist (HandshakedPeersService.BlacklistPeer)."""

    entries: Dict[bytes, float] = field(default_factory=dict)

    def add(self, node_id: bytes, duration: float = 600.0) -> None:
        self.entries[node_id] = time.time() + duration

    def is_blacklisted(self, node_id: bytes) -> bool:
        until = self.entries.get(node_id)
        if until is None:
            return False
        if time.time() >= until:
            del self.entries[node_id]
            return False
        return True


class PeerManager:
    """Listens, dials, runs the full handshake stack, keeps the
    registry (PeerManager.scala:40)."""

    def __init__(self, static_priv: bytes, client_id: str,
                 status_factory: Callable[[], Status],
                 max_peers: int = 25, fork_resolver=None):
        self.static_priv = static_priv
        self.node_id = privkey_to_pubkey(static_priv)
        self.client_id = client_id
        self.status_factory = status_factory
        self.max_peers = max_peers
        # DAO fork identity check, run right after the Status exchange
        # (EtcHandshake.respondToStatus -> respondToBlockHeaders)
        self.fork_resolver = fork_resolver
        self.peers: List[Peer] = []
        self._reserved = 0  # in-flight handshakes holding a peer slot
        self.blacklist = Blacklist()
        self._server: Optional[socket.socket] = None
        self._lock = threading.Lock()
        self.handlers: Dict[int, Callable] = {}

    # ------------------------------------------------------------ dialing

    def connect(self, host: str, port: int, remote_pub: bytes,
                timeout: float = 5.0) -> Peer:
        if self.blacklist.is_blacklisted(remote_pub):
            raise PeerError("peer is blacklisted")
        sock = socket.create_connection((host, port), timeout=timeout)
        try:
            hs = AuthHandshake(self.static_priv)
            auth = hs.create_auth(remote_pub)
            sock.sendall(auth)
            ack_prefix = recv_exact(sock, 2)
            size = struct.unpack(">H", ack_prefix)[0]
            ack = ack_prefix + recv_exact(sock, size)
            secrets = hs.handle_ack(ack)
            peer = Peer(sock, FrameCodec(secrets), remote_pub, inbound=False)
            self._finish(peer)
            return peer
        except Exception:
            try:
                sock.close()  # failed handshake must not leak the fd
            except OSError:
                pass
            raise

    def listen(self, host: str = "127.0.0.1", port: int = 0) -> int:
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind((host, port))
        self._server.listen(8)
        threading.Thread(target=self._accept_loop, daemon=True).start()
        return self._server.getsockname()[1]

    def _accept_loop(self) -> None:
        while self._server is not None:
            try:
                sock, _ = self._server.accept()
            except OSError:
                return
            threading.Thread(
                target=self._handle_inbound, args=(sock,), daemon=True
            ).start()

    def _handle_inbound(self, sock: socket.socket) -> None:
        try:
            prefix = recv_exact(sock, 2)
            size = struct.unpack(">H", prefix)[0]
            auth = prefix + recv_exact(sock, size)
            hs = AuthHandshake(self.static_priv)
            remote_pub = hs.handle_auth(auth)
            if self.blacklist.is_blacklisted(remote_pub):
                sock.close()
                return
            ack, secrets = hs.create_ack(remote_pub)
            sock.sendall(ack)
            peer = Peer(sock, FrameCodec(secrets), remote_pub, inbound=True)
            self._finish(peer)
        except Exception:
            try:
                sock.close()
            except OSError:
                pass

    def _finish(self, peer: Peer) -> None:
        # reserve the slot under ONE lock before the (blocking)
        # handshake — concurrent connects must not overshoot max_peers
        with self._lock:
            if len(self.peers) + self._reserved >= self.max_peers:
                peer.disconnect(reason=0x04)  # too many peers
                raise PeerError("too many peers")
            self._reserved += 1
        try:
            peer.exchange_hello(self.client_id, self.node_id)
            peer.exchange_status(self.status_factory())
            if self.fork_resolver is not None:
                from khipu_tpu_torch.network.fork_resolver import (
                    ForkCheckFailed,
                    run_fork_challenge,
                )
                from khipu_tpu_torch.network.messages import (
                    ETH_OFFSET as _EO,
                    GET_BLOCK_HEADERS as _GBH,
                )

                try:
                    run_fork_challenge(
                        peer,
                        self.fork_resolver,
                        serve_handler=self.handlers.get(_EO + _GBH),
                    )
                except ForkCheckFailed as e:
                    self.blacklist.add(peer.remote_pub)
                    peer.disconnect(reason=0x03)  # useless peer
                    raise PeerError(f"fork check failed: {e}")
            peer.handlers.update(self.handlers)
            peer.start_loop()
            with self._lock:
                self.peers.append(peer)
        finally:
            with self._lock:
                self._reserved -= 1

    def stop(self) -> None:
        server, self._server = self._server, None
        if server is not None:
            try:
                server.close()
            except OSError:
                pass
        for peer in list(self.peers):
            peer.disconnect()
        self.peers.clear()

    def best_peer(self) -> Optional[Peer]:
        """Highest-TD live peer (RegularSyncService.bestPeer:448)."""
        live = [p for p in self.peers if p.alive and p.status]
        if not live:
            return None
        return max(live, key=lambda p: p.status.total_difficulty)
