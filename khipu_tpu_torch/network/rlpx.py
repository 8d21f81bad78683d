"""RLPx transport: EIP-8 auth handshake, session secrets, frame codec.

Parity: khipu-eth/.../network/rlpx/ — AuthHandshake.scala:24-41
(initiate/response, pre/post-EIP-8), RLPxStage.scala:62 (secrets
:190-238), FrameCodec.scala:17 (AES-CTR frames + the keccak-state MAC
construction with its AES-256-ECB whitening step).

The MAC is a RUNNING keccak256 sponge whose digest is snapshotted
without finalizing the stream — _IncrementalKeccak below; seeded per
the devp2p spec: egress = mac-secret^remote-nonce || auth-wire-bytes.

The port's copy of ``khipu_tpu.network.rlpx``: the frame cipher, the
MAC's AES block and its running sponge are the host library's
(``native/aes.py``), which release the GIL while they run.
"""

from __future__ import annotations

import secrets as _secrets
import struct
from dataclasses import dataclass
from typing import Optional, Tuple

from khipu_tpu_torch.base.keccak import keccak256
from khipu_tpu_torch.base.secp256k1 import (
    ecdsa_recover,
    ecdsa_sign,
    privkey_to_pubkey,
)
from khipu_tpu_torch.base.rlp import rlp_decode_first, rlp_encode
from khipu_tpu_torch.native.aes import CtrCipher, EcbCipher
from khipu_tpu_torch.native.keccak import IncrementalKeccak
from khipu_tpu_torch.network.ecies import decrypt as ecies_decrypt
from khipu_tpu_torch.network.ecies import ecdh_raw
from khipu_tpu_torch.network.ecies import encrypt as ecies_encrypt

# the streaming sponge in C (csrc/keccak.cc khipu_keccak_absorb/_peek)
_IncrementalKeccak = IncrementalKeccak


def _xor(a: bytes, b: bytes) -> bytes:
    return bytes(x ^ y for x, y in zip(a, b))


AUTH_VSN = 4


@dataclass
class Secrets:
    aes: bytes
    mac: bytes
    egress_mac: _IncrementalKeccak
    ingress_mac: _IncrementalKeccak


def _pad_eip8() -> bytes:
    return _secrets.token_bytes(100 + _secrets.randbelow(201))


class AuthHandshake:
    """Initiator/responder state machine (AuthHandshake.scala:24).

    EIP-8 form only (every live client sends it): auth/ack bodies are
    RLP lists, ECIES-encrypted with the 2-byte size prefix as shared
    MAC data.
    """

    def __init__(self, static_priv: bytes,
                 ephemeral_priv: Optional[bytes] = None,
                 nonce: Optional[bytes] = None):
        self.static_priv = static_priv
        self.static_pub = privkey_to_pubkey(static_priv)
        self.eph_priv = ephemeral_priv or _secrets.token_bytes(32)
        self.eph_pub = privkey_to_pubkey(self.eph_priv)
        self.nonce = nonce or _secrets.token_bytes(32)
        self.init_wire: bytes = b""
        self.ack_wire: bytes = b""
        self.remote_nonce: bytes = b""
        self.remote_eph_pub: bytes = b""
        self.initiator = False

    # ---------------------------------------------------- initiator side

    def create_auth(self, remote_static_pub: bytes) -> bytes:
        """EIP-8 auth message to the remote static key."""
        self.initiator = True
        token = ecdh_raw(self.static_priv, remote_static_pub)
        signed = _xor(token, self.nonce)
        recid, r, s = ecdsa_sign(signed, self.eph_priv)
        sig = r.to_bytes(32, "big") + s.to_bytes(32, "big") + bytes([recid])
        body = rlp_encode(
            [sig, self.static_pub, self.nonce, bytes([AUTH_VSN])]
        ) + _pad_eip8()
        prefix = struct.pack(
            ">H", len(body) + 65 + 16 + 32
        )
        ct = ecies_encrypt(remote_static_pub, body, shared_mac_data=prefix)
        self.init_wire = prefix + ct
        return self.init_wire

    def handle_ack(self, wire: bytes) -> Secrets:
        prefix, ct = wire[:2], wire[2:]
        body = ecies_decrypt(self.static_priv, ct, shared_mac_data=prefix)
        fields, _ = rlp_decode_first(body)  # EIP-8: ignore padding
        self.remote_eph_pub = fields[0]
        self.remote_nonce = fields[1]
        self.ack_wire = wire
        return self._derive_secrets()

    # ---------------------------------------------------- responder side

    def handle_auth(self, wire: bytes) -> bytes:
        """Decode the initiator's auth; returns remote static pubkey."""
        prefix, ct = wire[:2], wire[2:]
        body = ecies_decrypt(self.static_priv, ct, shared_mac_data=prefix)
        fields, _ = rlp_decode_first(body)  # EIP-8: ignore padding
        sig, remote_static_pub, remote_nonce = fields[0], fields[1], fields[2]
        self.remote_nonce = remote_nonce
        self.init_wire = wire
        # recover the initiator's EPHEMERAL pubkey from the signature
        token = ecdh_raw(self.static_priv, remote_static_pub)
        signed = _xor(token, remote_nonce)
        r = int.from_bytes(sig[:32], "big")
        s = int.from_bytes(sig[32:64], "big")
        self.remote_eph_pub = ecdsa_recover(signed, sig[64], r, s)
        return remote_static_pub

    def create_ack(self, remote_static_pub: bytes) -> Tuple[bytes, Secrets]:
        body = rlp_encode(
            [self.eph_pub, self.nonce, bytes([AUTH_VSN])]
        ) + _pad_eip8()
        prefix = struct.pack(">H", len(body) + 65 + 16 + 32)
        ct = ecies_encrypt(remote_static_pub, body, shared_mac_data=prefix)
        self.ack_wire = prefix + ct
        return self.ack_wire, self._derive_secrets()

    # ------------------------------------------------------------ secrets

    def _derive_secrets(self) -> Secrets:
        """RLPxStage.scala:190-238 secrets schedule."""
        eph = ecdh_raw(self.eph_priv, self.remote_eph_pub)
        if self.initiator:
            h_nonce = keccak256(self.remote_nonce + self.nonce)
        else:
            h_nonce = keccak256(self.nonce + self.remote_nonce)
        shared = keccak256(eph + h_nonce)
        aes = keccak256(eph + shared)
        mac = keccak256(eph + aes)

        egress = _IncrementalKeccak()
        ingress = _IncrementalKeccak()
        if self.initiator:
            egress.update(_xor(mac, self.remote_nonce) + self.init_wire)
            ingress.update(_xor(mac, self.nonce) + self.ack_wire)
        else:
            egress.update(_xor(mac, self.remote_nonce) + self.ack_wire)
            ingress.update(_xor(mac, self.nonce) + self.init_wire)
        return Secrets(aes=aes, mac=mac, egress_mac=egress, ingress_mac=ingress)


class FrameCodec:
    """AES-256-CTR frames + the keccak/AES-ECB MAC (FrameCodec.scala:17).

    One continuous cipher stream per direction; headers and frame
    bodies each carry a 16-byte MAC derived from the running keccak
    state whitened through AES-256-ECB keyed by mac-secret.
    """

    def __init__(self, secrets: Secrets):
        self.secrets = secrets
        # one AES-256-CTR stream a direction, zero IV
        self._enc = CtrCipher(secrets.aes)
        self._dec = CtrCipher(secrets.aes)
        # one key schedule for every MAC block of the session
        self._mac_ecb = EcbCipher(secrets.mac).encrypt_block

    def _mac_seed(self, mac_state: _IncrementalKeccak, data16: bytes) -> bytes:
        prev = mac_state.digest()[:16]
        seed = _xor(self._mac_ecb(prev), data16)
        mac_state.update(seed)
        return mac_state.digest()[:16]

    def write_frame(self, frame_data: bytes) -> bytes:
        if len(frame_data) >= 1 << 24:
            raise ValueError(
                f"frame {len(frame_data)} bytes exceeds the 2^24-1 "
                "devp2p limit (3-byte size field)"
            )
        header = struct.pack(">I", len(frame_data))[1:]  # 3-byte size
        header += b"\xc2\x80\x80"  # rlp [capability-id 0, context-id 0]
        header = header.ljust(16, b"\x00")
        header_ct = self._enc.update(header)
        header_mac = self._mac_seed(self.secrets.egress_mac, header_ct)

        padded = frame_data + b"\x00" * (-len(frame_data) % 16)
        frame_ct = self._enc.update(padded)
        self.secrets.egress_mac.update(frame_ct)
        prev = self.secrets.egress_mac.digest()[:16]
        seed = _xor(self._mac_ecb(prev), prev)
        self.secrets.egress_mac.update(seed)
        frame_mac = self.secrets.egress_mac.digest()[:16]
        return header_ct + header_mac + frame_ct + frame_mac

    def read_header(self, header_ct_mac: bytes) -> int:
        """16-byte header ciphertext + 16-byte MAC -> frame size."""
        header_ct, their_mac = header_ct_mac[:16], header_ct_mac[16:32]
        mac = self._mac_seed(self.secrets.ingress_mac, header_ct)
        if mac != their_mac:
            raise ValueError("bad header MAC")
        header = self._dec.update(header_ct)
        return int.from_bytes(header[:3], "big")

    def read_frame(self, frame_size: int, frame_ct_mac: bytes) -> bytes:
        padded_size = frame_size + (-frame_size % 16)
        frame_ct = frame_ct_mac[:padded_size]
        their_mac = frame_ct_mac[padded_size : padded_size + 16]
        self.secrets.ingress_mac.update(frame_ct)
        prev = self.secrets.ingress_mac.digest()[:16]
        seed = _xor(self._mac_ecb(prev), prev)
        self.secrets.ingress_mac.update(seed)
        if self.secrets.ingress_mac.digest()[:16] != their_mac:
            raise ValueError("bad frame MAC")
        return self._dec.update(frame_ct)[:frame_size]

    @staticmethod
    def frame_wire_size(frame_size: int) -> int:
        return frame_size + (-frame_size % 16) + 16
