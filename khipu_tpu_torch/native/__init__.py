"""Host-side native code: the scalar Keccak sponge, the secp256k1 curve
arithmetic, the EVM interpreter core and the append-log store in C++,
built with g++ at first use into one library and bound with ctypes, and
the CPython RLP codec, built with gcc (``build.py``). The port's
counterpart of ``khipu_tpu.native``."""
