"""Host-side native code: the scalar Keccak sponge and the secp256k1
curve arithmetic in C++, built with g++ at first use (``build.py``) and
bound with ctypes. The port's counterpart of ``khipu_tpu.native``
without the native EVM and the append-log store."""
