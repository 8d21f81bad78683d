"""The port's network layer against the JAX package's, over loopback.

The host library's AES (``native/aes.py``) is held against the port's
pure-Python ``base/aes.py`` and against the ``cryptography`` package
(used here only); snappy, every wire message, ECIES and the RLPx
handshake and frames are compared byte for byte, or run across the two
packages (a JAX initiator with a port responder and the reverse); a
port ``PeerManager`` fetches chain data from a JAX one and the reverse;
a genesis mismatch and a peer on the other side of the DAO fork are
refused; three discovery nodes of both packages bootstrap.

Every socket wait is bounded (request timeouts of a few seconds).
"""

import random
import time
from types import SimpleNamespace

import pytest
from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes

PRIV_A = (11).to_bytes(32, "big")
PRIV_B = (22).to_bytes(32, "big")
TIMEOUT = 5.0


def _ns(name):
    """One package's network stack and chain classes, under one set of
    names."""
    if name == "port":
        from khipu_tpu_torch.base.keccak import keccak256
        from khipu_tpu_torch.base.secp256k1 import (
            privkey_to_pubkey,
            pubkey_to_address,
        )
        from khipu_tpu_torch.config import fixture_config
        from khipu_tpu_torch.domain.block import Block, BlockBody
        from khipu_tpu_torch.domain.block_header import BlockHeader
        from khipu_tpu_torch.domain.blockchain import Blockchain, GenesisSpec
        from khipu_tpu_torch.domain.transaction import (
            SignedTransaction,
            Transaction,
            sign_transaction,
        )
        from khipu_tpu_torch.network import (
            discovery,
            ecies,
            fork_resolver,
            host_service,
            messages,
            peer,
            rlpx,
            snappy_codec,
        )
        from khipu_tpu_torch.storage.storages import Storages
        from khipu_tpu_torch.sync.chain_builder import ChainBuilder
    else:
        from khipu_tpu.base.crypto.keccak import keccak256
        from khipu_tpu.base.crypto.secp256k1 import (
            privkey_to_pubkey,
            pubkey_to_address,
        )
        from khipu_tpu.config import fixture_config
        from khipu_tpu.domain.block import Block, BlockBody
        from khipu_tpu.domain.block_header import BlockHeader
        from khipu_tpu.domain.blockchain import Blockchain, GenesisSpec
        from khipu_tpu.domain.transaction import (
            SignedTransaction,
            Transaction,
            sign_transaction,
        )
        from khipu_tpu.network import (
            discovery,
            ecies,
            fork_resolver,
            host_service,
            messages,
            peer,
            rlpx,
            snappy_codec,
        )
        from khipu_tpu.storage.storages import Storages
        from khipu_tpu.sync.chain_builder import ChainBuilder
    ns = SimpleNamespace(**{k: v for k, v in locals().items()
                            if k != "name"})
    ns.name = name
    return ns


PORT, JAX = _ns("port"), _ns("jax")
PAIRS = [(PORT, JAX), (JAX, PORT)]
PAIR_IDS = ["port-jax", "jax-port"]
PUB_A = PORT.privkey_to_pubkey(PRIV_A)
PUB_B = PORT.privkey_to_pubkey(PRIV_B)
KEYS = [(i + 1).to_bytes(32, "big") for i in range(3)]
ADDRS = [PORT.pubkey_to_address(PORT.privkey_to_pubkey(k)) for k in KEYS]
REFUND = b"\xbf" * 20


# ------------------------------------------------------------------ AES


def _cryptography_ctr(key, iv, data):
    enc = Cipher(algorithms.AES(key), modes.CTR(iv)).encryptor()
    return enc.update(data) + enc.finalize()


@pytest.mark.parametrize("key_len", [16, 24, 32])
def test_native_aes_ctr_matches_oracle_and_cryptography(key_len):
    from khipu_tpu_torch.base import aes as oracle
    from khipu_tpu_torch.native import aes

    rng = random.Random(key_len)
    lengths = [0, 1, 15, 16, 17, 31, 32, 33, 255, 1024, 4095, 4096, 4097]
    lengths += [rng.randrange(0, 4098) for _ in range(8)]
    for n in lengths:
        key, iv, data = rng.randbytes(key_len), rng.randbytes(16), \
            rng.randbytes(n)
        got = aes.ctr_crypt(key, iv, data)
        assert got == oracle.ctr_crypt(key, iv, data), n
        assert got == _cryptography_ctr(key, iv, data), n
        block = rng.randbytes(16)
        ecb = Cipher(algorithms.AES(key), modes.ECB()).encryptor()
        assert (aes.EcbCipher(key).encrypt_block(block)
                == oracle.ecb_encrypt_block(key, block)
                == ecb.update(block) + ecb.finalize())


def test_native_aes_ctr_streams_across_chunks_and_counter_wrap():
    from khipu_tpu_torch.base import aes as oracle
    from khipu_tpu_torch.native import aes

    rng = random.Random(5)
    key, data = rng.randbytes(32), rng.randbytes(3000)
    for iv in (b"\xff" * 16, b"\x00" * 15 + b"\xfe", rng.randbytes(16)):
        stream = aes.CtrCipher(key, iv)
        out, pos = [], 0
        while pos < len(data):
            step = rng.randrange(0, 70)
            out.append(stream.update(data[pos:pos + step]))
            pos += step
        assert stream.finalize() == b""
        assert b"".join(out) == oracle.ctr_crypt(key, iv, data)
    with pytest.raises(ValueError):
        aes.CtrCipher(b"k" * 15)
    with pytest.raises(ValueError):
        aes.CtrCipher(b"k" * 16, b"short")


def test_native_streaming_keccak_matches_the_jax_mac_sponge():
    from khipu_tpu_torch.native.keccak import IncrementalKeccak

    rng = random.Random(3)
    port, ref = IncrementalKeccak(), JAX.rlpx._IncrementalKeccak()
    assert port.digest() == ref.digest() == JAX.keccak256(b"")
    for _ in range(60):
        chunk = rng.randbytes(rng.randrange(0, 400))
        port.update(chunk)
        ref.update(chunk)
        assert port.digest() == ref.digest()


# --------------------------------------------------------------- snappy


def test_snappy_compress_byte_equal_and_round_trips():
    rng = random.Random(9)
    cases = [b"", b"a", b"ab" * 3, b"x" * 100, b"hello world " * 500,
             rng.randbytes(1000), bytes(70000),
             (b"hdr" + bytes(40)) * 2000, rng.randbytes(200) * 300]
    cases += [bytes(rng.choice(b"abcd") for _ in range(rng.randint(0, 3000)))
              for _ in range(40)]
    for c in cases:
        z = PORT.snappy_codec.compress(c)
        assert z == JAX.snappy_codec.compress(c)
        assert PORT.snappy_codec.decompress(z, max_len=1 << 26) == c
        lit = PORT.snappy_codec._compress_literal(c)
        assert lit == JAX.snappy_codec._compress_literal(c)
        assert PORT.snappy_codec.decompress(lit, max_len=1 << 26) == c
    big = (b"repetitive-node-payload" + bytes(32)) * 5000
    assert len(PORT.snappy_codec.compress(big)) < len(big) // 5


@pytest.mark.parametrize("stream,want", [
    # literal "abcd" + 1-byte-offset copy of 4 => "abcdabcd"
    (bytes([8, (4 - 1) << 2]) + b"abcd" + bytes([1, 4]), b"abcdabcd"),
    # literal "ab" + copy(offset=2, len=6): overlapping => "abababab"
    (bytes([8, (2 - 1) << 2]) + b"ab" + bytes([((6 - 4) << 2) | 1, 2]),
     b"abababab"),
], ids=["copy", "overlap"])
def test_snappy_decompress_copy_streams(stream, want):
    assert PORT.snappy_codec.decompress(stream) == want
    assert JAX.snappy_codec.decompress(stream) == want


@pytest.mark.parametrize("stream", [
    b"", bytes([100]), bytes([4, 0b101, 1]), bytes([0x80] * 6),
], ids=["empty", "short", "copy-first", "varint"])
def test_snappy_bad_streams_raise(stream):
    with pytest.raises(PORT.snappy_codec.SnappyError):
        PORT.snappy_codec.decompress(stream)
    with pytest.raises(JAX.snappy_codec.SnappyError):
        JAX.snappy_codec.decompress(stream)


# ------------------------------------------------------------- messages


def _chain(ns, n_blocks=3, cfg=None, coinbase=b"\xaa" * 20):
    cfg = cfg or ns.fixture_config(chain_id=1)
    bc = ns.Blockchain(ns.Storages(), cfg)
    builder = ns.ChainBuilder(
        bc, cfg, ns.GenesisSpec(alloc={a: 10**21 for a in ADDRS}))
    for n in range(n_blocks):
        builder.add_block(
            [ns.sign_transaction(ns.Transaction(n, 10**9, 21000, ADDRS[1], 5),
                                 KEYS[0], chain_id=1)],
            coinbase=coinbase)
    return bc


def _message_bodies(ns, bc):
    m = ns.messages
    blocks = [bc.get_block_by_number(n) for n in range(1, 4)]
    headers = [b.header for b in blocks]
    txs = [t for b in blocks for t in b.body.transactions]
    return {
        "hello": m.Hello("khipu/test", node_id=PUB_A,
                         listen_port=30301).body(),
        "status": m.Status(63, 1, 12345, headers[-1].hash,
                           bc.get_hash_by_number(0)).body(),
        "get_headers_number": m.GetBlockHeaders(7, 20, 1, True).body(),
        "get_headers_hash": m.GetBlockHeaders(headers[0].hash, 3).body(),
        "headers": m.encode_headers(headers),
        "bodies": m.encode_bodies([b.body for b in blocks]),
        "transactions": m.encode_transactions(txs),
        "new_block_hashes": m.encode_new_block_hashes(
            [(b.hash, b.header.number) for b in blocks]),
        "new_block": m.encode_new_block(blocks[-1], 987654321),
    }


def test_every_message_type_encodes_byte_equal():
    port_bc, jax_bc = _chain(PORT), _chain(JAX)
    assert (port_bc.get_hash_by_number(3) == jax_bc.get_hash_by_number(3))
    port_bodies = _message_bodies(PORT, port_bc)
    jax_bodies = _message_bodies(JAX, jax_bc)
    assert port_bodies.keys() == jax_bodies.keys()
    codes = {"hello": PORT.messages.HELLO,
             "status": PORT.messages.ETH_OFFSET + PORT.messages.STATUS}
    for key, body in port_bodies.items():
        code = codes.get(key, 0x13)
        wire = PORT.messages.encode_message(code, body)
        assert wire == JAX.messages.encode_message(code, jax_bodies[key]), key
        assert PORT.messages.decode_message(wire) == \
            JAX.messages.decode_message(wire)
    # and each decodes back in the other package
    m, j = PORT.messages, JAX.messages
    assert m.Hello.from_body(jax_bodies["hello"]) == m.Hello.from_body(
        port_bodies["hello"])
    assert m.GetBlockHeaders.from_body(jax_bodies["get_headers_hash"]) \
        == m.GetBlockHeaders(port_bodies["get_headers_hash"][0], 3)
    block, td = m.decode_new_block(jax_bodies["new_block"])
    assert block.hash == port_bc.get_hash_by_number(3) and td == 987654321
    assert [h.hash for h in j.decode_headers(port_bodies["headers"])] == [
        port_bc.get_hash_by_number(n) for n in (1, 2, 3)]
    assert [t.hash for t in m.decode_transactions(
        jax_bodies["transactions"])] == [
        t.hash for t in j.decode_transactions(port_bodies["transactions"])]
    assert m.decode_new_block_hashes(jax_bodies["new_block_hashes"]) == \
        j.decode_new_block_hashes(port_bodies["new_block_hashes"])


# ------------------------------------------------------ ECIES and RLPx


@pytest.mark.parametrize("enc,dec", PAIRS, ids=PAIR_IDS)
def test_ecies_across_packages(enc, dec):
    msg = b"rlpx auth payload" * 7
    ct = enc.ecies.encrypt(PUB_B, msg, shared_mac_data=b"\x01\x02")
    assert dec.ecies.decrypt(PRIV_B, ct, shared_mac_data=b"\x01\x02") == msg
    bad = ct[:-1] + bytes([ct[-1] ^ 1])
    with pytest.raises(dec.ecies.EciesError):
        dec.ecies.decrypt(PRIV_B, bad, shared_mac_data=b"\x01\x02")
    with pytest.raises(dec.ecies.EciesError):
        dec.ecies.decrypt(PRIV_A, ct, shared_mac_data=b"\x01\x02")


def _handshake(init_ns, resp_ns, eph=None):
    eph = eph or {}
    initiator = init_ns.rlpx.AuthHandshake(PRIV_A, **eph.get("a", {}))
    responder = resp_ns.rlpx.AuthHandshake(PRIV_B, **eph.get("b", {}))
    auth = initiator.create_auth(PUB_B)
    assert responder.handle_auth(auth) == PUB_A
    ack, resp_secrets = responder.create_ack(PUB_A)
    return initiator.handle_ack(ack), resp_secrets


@pytest.mark.parametrize("init_ns,resp_ns", PAIRS, ids=PAIR_IDS)
def test_rlpx_handshake_and_frames_across_packages(init_ns, resp_ns):
    a, b = _handshake(init_ns, resp_ns)
    assert a.aes == b.aes and a.mac == b.mac
    assert a.egress_mac.digest() == b.ingress_mac.digest()
    assert a.ingress_mac.digest() == b.egress_mac.digest()
    ca, cb = init_ns.rlpx.FrameCodec(a), resp_ns.rlpx.FrameCodec(b)
    for msg in [b"\x80", b"ping", b"x" * 15, b"y" * 16, b"z" * 5000]:
        wire = ca.write_frame(msg)
        size = cb.read_header(wire[:32])
        assert cb.read_frame(size, wire[32:]) == msg
        back = cb.write_frame(msg + b"-reply")
        size = ca.read_header(back[:32])
        assert ca.read_frame(size, back[32:]) == msg + b"-reply"
    wire = bytearray(ca.write_frame(b"payload" * 3))
    wire[40] ^= 1  # flip a ciphertext byte of the body
    size = cb.read_header(bytes(wire[:32]))
    with pytest.raises(ValueError, match="MAC"):
        cb.read_frame(size, bytes(wire[32:]))
    head = bytearray(ca.write_frame(b"next"))
    head[3] ^= 1  # and one of the header
    with pytest.raises(ValueError, match="MAC"):
        cb.read_header(bytes(head[:32]))


def test_handshake_with_fixed_keys_is_byte_equal():
    """With the ephemeral keys and nonces pinned (the handshake's test
    seams), the two packages derive the same session secrets, and the
    same frames under them."""
    eph = {"a": {"ephemeral_priv": (7001).to_bytes(32, "big"),
                 "nonce": b"\x0a" * 32},
           "b": {"ephemeral_priv": (7002).to_bytes(32, "big"),
                 "nonce": b"\x0b" * 32}}
    secrets = {}
    for init_ns, resp_ns in PAIRS:
        a, b = _handshake(init_ns, resp_ns, eph)
        secrets[init_ns.name] = (a, b)
    pa, _ = secrets["port"]
    ja, _ = secrets["jax"]
    assert (pa.aes, pa.mac) == (ja.aes, ja.mac)

    def seeded(ns):
        mac = ns.rlpx._IncrementalKeccak
        s = ns.rlpx.Secrets(aes=pa.aes, mac=pa.mac, egress_mac=mac(),
                            ingress_mac=mac())
        s.egress_mac.update(b"egress-seed")
        s.ingress_mac.update(b"ingress-seed")
        return ns.rlpx.FrameCodec(s)

    port_codec, jax_codec = seeded(PORT), seeded(JAX)
    rng = random.Random(11)
    for n in [0, 1, 15, 16, 17, 100, 4097, 70000]:
        frame = rng.randbytes(n)
        assert port_codec.write_frame(frame) == jax_codec.write_frame(frame)


# ---------------------------------------------------------- peer stack


def _status(ns, bc):
    def make():
        best = bc.best_block_number
        return ns.messages.Status(
            63, 1, bc.get_total_difficulty(best) or 0,
            bc.get_hash_by_number(best), bc.get_hash_by_number(0))
    return make


@pytest.mark.parametrize("client_ns,server_ns", PAIRS, ids=PAIR_IDS)
def test_peer_fetches_chain_data_across_packages(client_ns, server_ns):
    server_bc, client_bc = _chain(server_ns), _chain(client_ns, 0)
    m = client_ns.messages
    server = server_ns.peer.PeerManager(PRIV_B, "server",
                                        _status(server_ns, server_bc))
    server_ns.host_service.HostService(server_bc).install(server)
    port = server.listen()
    client = client_ns.peer.PeerManager(PRIV_A, "client",
                                        _status(client_ns, client_bc))
    try:
        peer = client.connect("127.0.0.1", port, PUB_B, timeout=TIMEOUT)
        assert peer.hello.client_id == "server" and peer.snappy
        assert peer.status.total_difficulty == _status(server_ns, server_bc)(
        ).total_difficulty

        def ask(code, body, reply):
            return peer.request(m.ETH_OFFSET + code, body,
                                m.ETH_OFFSET + reply, timeout=TIMEOUT)

        headers = m.decode_headers(ask(
            m.GET_BLOCK_HEADERS, m.GetBlockHeaders(1, 3).body(),
            m.BLOCK_HEADERS))
        assert [h.hash for h in headers] == [
            server_bc.get_hash_by_number(n) for n in (1, 2, 3)]
        by_hash = m.decode_headers(ask(
            m.GET_BLOCK_HEADERS,
            m.GetBlockHeaders(headers[2].hash, 2, 0, True).body(),
            m.BLOCK_HEADERS))
        assert [h.number for h in by_hash] == [3, 2]
        hashes = [h.hash for h in headers]
        bodies = m.decode_bodies(ask(m.GET_BLOCK_BODIES, hashes,
                                     m.BLOCK_BODIES))
        assert [b.encode() for b in bodies] == [
            server_bc.get_block_by_number(n).body.encode() for n in (1, 2, 3)]
        receipts = ask(m.GET_RECEIPTS, hashes, m.RECEIPTS)
        from khipu_tpu_torch.base.rlp import rlp_encode

        assert [rlp_encode(r) for r in receipts] == [
            server_bc.storages.receipts_storage.get(n) for n in (1, 2, 3)]
        root = server_bc.get_header_by_number(3).state_root
        nodes = ask(m.GET_NODE_DATA, [root, b"\x00" * 32], m.NODE_DATA)
        assert len(nodes) == 1 and client_ns.keccak256(nodes[0]) == root
    finally:
        client.stop()
        server.stop()


def test_idle_outbound_port_peer_outlives_its_connect_timeout():
    """A port peer connected with a 0.3 s timeout to a JAX server stays
    alive through 1 s of silence and answers a request after it (the
    JAX package's outbound peer keeps the timeout on its socket and
    drops when it passes)."""
    server_bc, client_bc = _chain(JAX), _chain(PORT, 0)
    m = PORT.messages
    server = JAX.peer.PeerManager(PRIV_B, "server", _status(JAX, server_bc))
    JAX.host_service.HostService(server_bc).install(server)
    port = server.listen()
    client = PORT.peer.PeerManager(PRIV_A, "client",
                                   _status(PORT, client_bc))
    try:
        peer = client.connect("127.0.0.1", port, PUB_B, timeout=0.3)
        time.sleep(1.0)
        assert peer.alive
        headers = m.decode_headers(peer.request(
            m.ETH_OFFSET + m.GET_BLOCK_HEADERS, m.GetBlockHeaders(1, 2).body(),
            m.ETH_OFFSET + m.BLOCK_HEADERS, timeout=TIMEOUT))
        assert [h.number for h in headers] == [1, 2]
    finally:
        client.stop()
        server.stop()


@pytest.mark.parametrize("client_ns,server_ns", PAIRS, ids=PAIR_IDS)
def test_genesis_mismatch_rejected(client_ns, server_ns):
    def status(ns, genesis):
        return lambda: ns.messages.Status(63, 1, 1, b"\x01" * 32, genesis)

    server = server_ns.peer.PeerManager(PRIV_B, "s",
                                        status(server_ns, b"\xbb" * 32))
    port = server.listen()
    client = client_ns.peer.PeerManager(PRIV_A, "c",
                                        status(client_ns, b"\xaa" * 32))
    try:
        with pytest.raises(client_ns.peer.PeerError, match="genesis"):
            client.connect("127.0.0.1", port, PUB_B, timeout=TIMEOUT)
        assert client.peers == []
    finally:
        client.stop()
        server.stop()


# ------------------------------------------------------- DAO challenge


def _dao_chain(ns, coinbase=b"\xaa" * 20, n_blocks=3):
    cfg = ns.fixture_config(
        chain_id=1, dao_fork_block_number=2, dao_drain_list=(ADDRS[2],),
        dao_refund_contract=REFUND, dao_fork_extra_data=None,
        dao_fork_block_hash=None)
    return _chain(ns, n_blocks, cfg, coinbase)


@pytest.mark.parametrize("client_ns,server_ns", PAIRS, ids=PAIR_IDS)
def test_dao_fork_challenge_across_packages(client_ns, server_ns):
    """test_dao_fork.py::TestForkChallenge with the two sides in
    different packages: a peer on the other side of the fork is refused
    and blacklisted; a same-side peer passes the mutual challenge; a
    peer that predates the fork block is assumed friendly."""
    ours = _dao_chain(client_ns)
    theirs = _dao_chain(server_ns, coinbase=b"\xcc" * 20)
    assert ours.get_hash_by_number(0) == theirs.get_hash_by_number(0)
    fork_hash = ours.get_hash_by_number(2)
    assert theirs.get_hash_by_number(2) != fork_hash
    resolver = client_ns.fork_resolver.ForkResolver(2, fork_hash)

    def run(server_bc, server_resolver=None):
        server = server_ns.peer.PeerManager(
            PRIV_B, "server", _status(server_ns, server_bc),
            fork_resolver=server_resolver)
        server_ns.host_service.HostService(server_bc).install(server)
        client = client_ns.peer.PeerManager(
            PRIV_A, "client", _status(client_ns, ours),
            fork_resolver=resolver)
        client_ns.host_service.HostService(ours).install(client)
        return server, client, server.listen()

    server, client, port = run(theirs)
    try:
        with pytest.raises(client_ns.peer.PeerError,
                           match="fork check failed"):
            client.connect("127.0.0.1", port, PUB_B, timeout=TIMEOUT)
        assert client.blacklist.is_blacklisted(PUB_B)
        with pytest.raises(client_ns.peer.PeerError, match="blacklisted"):
            client.connect("127.0.0.1", port, PUB_B, timeout=TIMEOUT)
    finally:
        client.stop()
        server.stop()

    same = _dao_chain(server_ns)
    assert same.get_hash_by_number(2) == fork_hash
    server, client, port = run(
        same, server_ns.fork_resolver.ForkResolver(2, fork_hash))
    try:
        peer = client.connect("127.0.0.1", port, PUB_B, timeout=TIMEOUT)
        assert peer.alive and peer.status is not None
    finally:
        client.stop()
        server.stop()

    short = _dao_chain(server_ns, n_blocks=1)
    server, client, port = run(short)
    try:
        assert client.connect("127.0.0.1", port, PUB_B,
                              timeout=TIMEOUT).alive
    finally:
        client.stop()
        server.stop()


# ------------------------------------------------------------ discovery


@pytest.mark.parametrize("order", ["port-jax-port", "jax-port-jax"])
def test_mixed_three_node_discovery_bootstrap(order):
    """a bootstraps from b only and learns c through b's neighbours,
    with the nodes alternating between the packages."""
    pkgs = [PORT if n == "port" else JAX for n in order.split("-")]
    nodes = [ns.discovery.DiscoveryService((31 + i).to_bytes(32, "big"))
             for i, ns in enumerate(pkgs)]
    for node in nodes:
        node.start()
    a, b, c = nodes
    try:
        b.table.add(pkgs[1].discovery.NodeRecord(
            c.record.pubkey, c.record.ip, c.record.udp_port,
            c.record.tcp_port))
        seed = pkgs[0].discovery.NodeRecord(
            b.record.pubkey, b.record.ip, b.record.udp_port,
            b.record.tcp_port)
        assert a.bootstrap([seed], timeout=2.0) >= 2
        pubs = {r.pubkey for bucket in a.table.buckets for r in bucket}
        assert b.pubkey in pubs and c.pubkey in pubs
    finally:
        for node in nodes:
            node.stop()


def test_discovery_packets_equal_and_tamper_refused():
    for ns, other in PAIRS:
        packet = ns.discovery.encode_packet(PRIV_A, 1, [b"x", b"yz"])
        assert packet == other.discovery.encode_packet(PRIV_A, 1,
                                                       [b"x", b"yz"])
        assert other.discovery.decode_packet(packet) == (
            PUB_A, 1, [b"x", b"yz"])
        bad = packet[:40] + bytes([packet[40] ^ 1]) + packet[41:]
        with pytest.raises(ValueError):
            other.discovery.decode_packet(bad)
