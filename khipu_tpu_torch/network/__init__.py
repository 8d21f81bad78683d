"""P2P network stack (khipu-eth/.../network/ role): ECIES, RLPx
handshake + framing, devp2p/eth wire messages, peers, discovery. The
port's copy of ``khipu_tpu.network``: the frame and handshake crypto
runs in the host library (``native/aes.py``)."""
