"""DAO fork identity checking + the post-Status header challenge.

Parity: network/ForkResolver.scala:18-31 (DAOForkResolver — recognize
the peer's side by the fork block's hash, accept only our own side) and
handshake/EtcHandshake.scala respondToStatus/respondToBlockHeaders (the
geth PR#2814 DAO challenge: request the fork-block header immediately
after the Status exchange; a peer that cannot produce any header is
assumed friendly — there is no way to challenge it).
The port's copy of ``khipu_tpu.network.fork_resolver``.
"""

from __future__ import annotations

import socket
from typing import Optional

from khipu_tpu_torch.network.messages import (
    BLOCK_HEADERS,
    DISCONNECT,
    ETH_OFFSET,
    GET_BLOCK_HEADERS,
    PING,
    PONG,
    GetBlockHeaders,
    decode_headers,
)


class ForkResolver:
    """Recognize which side of a scheduled fork a peer follows.

    ``fork_block_hash`` is the hash of OUR side's fork block; a peer
    serving a different header at ``fork_block_number`` runs the other
    chain (ForkResolver.scala:20-24 with the eth/etc polarity folded
    into the configured hash).
    """

    def __init__(self, fork_block_number: int, fork_block_hash: bytes):
        self.fork_block_number = fork_block_number
        self.fork_block_hash = fork_block_hash

    def recognize_fork(self, header) -> str:
        return "ours" if header.hash == self.fork_block_hash else "other"

    def is_accepted(self, fork: str) -> bool:
        return fork == "ours"


class ForkCheckFailed(Exception):
    pass


def run_fork_challenge(
    peer,
    resolver: ForkResolver,
    serve_handler=None,
    timeout: float = 5.0,
) -> bool:
    """Issue the DAO challenge on a freshly status-exchanged peer.

    Runs BEFORE the peer's reader loop starts, so it owns the socket:
    both sides may be challenging each other simultaneously, so while
    waiting for our BlockHeaders reply we must answer the peer's own
    GetBlockHeaders (via ``serve_handler``, the HostService handler) —
    EtcHandshake.respondToGetBlockHeaders plays the same role.

    Returns True if the peer is on our fork (or could not be
    challenged); raises :class:`ForkCheckFailed` if it provably follows
    the other side.
    """
    import time as _time

    old_timeout = peer.sock.gettimeout()
    # overall deadline, not per-recv: a peer drip-feeding PINGs must
    # not hold the handshake thread (and its reserved slot) open
    deadline = _time.monotonic() + timeout
    try:
        peer.send(
            ETH_OFFSET + GET_BLOCK_HEADERS,
            GetBlockHeaders(resolver.fork_block_number, 1).body(),
        )
        while True:
            remaining = deadline - _time.monotonic()
            if remaining <= 0:
                raise ForkCheckFailed("fork challenge timed out")
            peer.sock.settimeout(remaining)
            try:
                code, body = peer.recv()
            except socket.timeout:
                raise ForkCheckFailed("fork challenge timed out")
            if code == ETH_OFFSET + BLOCK_HEADERS:
                headers = decode_headers(body)
                fork_header = next(
                    (
                        h
                        for h in headers
                        if h.number == resolver.fork_block_number
                    ),
                    None,
                )
                if fork_header is None:
                    return True  # peer predates the fork: assume friendly
                if resolver.is_accepted(
                    resolver.recognize_fork(fork_header)
                ):
                    return True
                raise ForkCheckFailed(
                    "peer follows the other side of the fork"
                )
            if code == ETH_OFFSET + GET_BLOCK_HEADERS:
                if serve_handler is not None:
                    reply = serve_handler(body)
                    if reply is not None:
                        peer.send(reply[0], reply[1])
                else:
                    peer.send(ETH_OFFSET + BLOCK_HEADERS, [])
                continue
            if code == PING:
                peer.send(PONG, [])
                continue
            if code == DISCONNECT:
                raise ForkCheckFailed("peer disconnected during challenge")
            # anything else mid-handshake is out of order; ignore
    finally:
        peer.sock.settimeout(old_timeout)
