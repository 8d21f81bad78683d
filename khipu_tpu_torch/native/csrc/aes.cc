// Native AES (forward cipher only): key expansion for 128/192/256-bit
// keys, one ECB block, and CTR with a running 128-bit big-endian counter.
//
// Role parity: the reference's JCE provider behind the RLPx frame codec
// (FrameCodec.scala:17: AES-256-CTR frames, an AES-256-ECB block in the
// frame MAC), the ECIES handshake (AES-128-CTR) and V3 keyfiles
// (AES-128-CTR). Only the ENCRYPT direction exists: CTR decrypts with the
// forward cipher and the MAC whitening is one forward block. The
// T-tables are derived from GF(2^8) log/antilog tables at load time, as
// the pure-Python oracle (khipu_tpu_torch/base/aes.py) does. Not
// constant-time, like that oracle.
//
// Exposed C ABI (ctypes, see khipu_tpu_torch/native/aes.py). The caller
// owns a context buffer of khipu_aes_ctx_size() bytes:
//   khipu_aes_init(ctx, key, key_len, iv16)  -> 0, or -1 on a bad key
//   khipu_aes_ctr(ctx, in, n, out)            keystream XOR, stream goes on
//   khipu_aes_ecb(ctx, in16, out16)           one forward block

#include <cstdint>
#include <cstring>

namespace {

struct Tables {
  uint8_t sbox[256];
  uint32_t te0[256], te1[256], te2[256], te3[256];

  static uint8_t gmul(uint8_t a, uint8_t b) {
    uint8_t r = 0;
    for (int i = 0; i < 8; ++i) {
      if (b & 1) r ^= a;
      uint8_t hi = a & 0x80;
      a = (uint8_t)(a << 1);
      if (hi) a ^= 0x1B;
      b >>= 1;
    }
    return r;
  }

  Tables() {
    uint8_t alog[255];
    int log[256] = {0};
    uint8_t x = 1;
    for (int i = 0; i < 255; ++i) {
      alog[i] = x;
      log[x] = i;
      x = gmul(x, 3);
    }
    sbox[0] = 0x63;
    for (int a = 1; a < 256; ++a) {
      uint8_t b = alog[(255 - log[a]) % 255];  // a^-1
      uint8_t s = b;
      for (int k = 0; k < 4; ++k) {
        b = (uint8_t)((b << 1) | (b >> 7));
        s ^= b;
      }
      sbox[a] = s ^ 0x63;
    }
    for (int a = 0; a < 256; ++a) {
      uint32_t s = sbox[a];
      uint32_t s2 = gmul((uint8_t)s, 2);
      uint32_t s3 = s2 ^ s;
      uint32_t t = (s2 << 24) | (s << 16) | (s << 8) | s3;
      te0[a] = t;
      te1[a] = (t >> 8) | (t << 24);
      te2[a] = (t >> 16) | (t << 16);
      te3[a] = (t >> 24) | (t << 8);
    }
  }
};

const Tables& tables() {
  static const Tables t;  // thread-safe one-time init (C++11)
  return t;
}

constexpr uint8_t kRcon[14] = {0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40,
                               0x80, 0x1B, 0x36, 0x6C, 0xD8, 0xAB, 0x4D};

struct Ctx {
  uint32_t rk[60];
  int rounds;
  uint8_t counter[16];  // big-endian 128-bit block counter
  uint8_t stream[16];   // keystream of the current counter block
  int used;             // bytes of `stream` already consumed (16 = none)
};

inline uint32_t load_be(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
         ((uint32_t)p[2] << 8) | (uint32_t)p[3];
}

inline void store_be(uint8_t* p, uint32_t v) {
  p[0] = (uint8_t)(v >> 24);
  p[1] = (uint8_t)(v >> 16);
  p[2] = (uint8_t)(v >> 8);
  p[3] = (uint8_t)v;
}

inline uint32_t sub_word(const uint8_t* sbox, uint32_t t) {
  return ((uint32_t)sbox[(t >> 24) & 0xFF] << 24) |
         ((uint32_t)sbox[(t >> 16) & 0xFF] << 16) |
         ((uint32_t)sbox[(t >> 8) & 0xFF] << 8) | (uint32_t)sbox[t & 0xFF];
}

void encrypt_block(const Ctx* c, const uint8_t in[16], uint8_t out[16]) {
  const Tables& T = tables();
  const uint32_t* rk = c->rk;
  uint32_t s0 = load_be(in) ^ rk[0], s1 = load_be(in + 4) ^ rk[1];
  uint32_t s2 = load_be(in + 8) ^ rk[2], s3 = load_be(in + 12) ^ rk[3];
  int k = 4;
  for (int r = 0; r < c->rounds - 1; ++r) {
    uint32_t t0 = T.te0[s0 >> 24] ^ T.te1[(s1 >> 16) & 0xFF] ^
                  T.te2[(s2 >> 8) & 0xFF] ^ T.te3[s3 & 0xFF] ^ rk[k];
    uint32_t t1 = T.te0[s1 >> 24] ^ T.te1[(s2 >> 16) & 0xFF] ^
                  T.te2[(s3 >> 8) & 0xFF] ^ T.te3[s0 & 0xFF] ^ rk[k + 1];
    uint32_t t2 = T.te0[s2 >> 24] ^ T.te1[(s3 >> 16) & 0xFF] ^
                  T.te2[(s0 >> 8) & 0xFF] ^ T.te3[s1 & 0xFF] ^ rk[k + 2];
    uint32_t t3 = T.te0[s3 >> 24] ^ T.te1[(s0 >> 16) & 0xFF] ^
                  T.te2[(s1 >> 8) & 0xFF] ^ T.te3[s2 & 0xFF] ^ rk[k + 3];
    s0 = t0;
    s1 = t1;
    s2 = t2;
    s3 = t3;
    k += 4;
  }
  const uint8_t* sb = T.sbox;
  const uint32_t cols[4][4] = {
      {s0, s1, s2, s3}, {s1, s2, s3, s0}, {s2, s3, s0, s1}, {s3, s0, s1, s2}};
  for (int col = 0; col < 4; ++col) {
    uint32_t v = ((uint32_t)sb[cols[col][0] >> 24] << 24) |
                 ((uint32_t)sb[(cols[col][1] >> 16) & 0xFF] << 16) |
                 ((uint32_t)sb[(cols[col][2] >> 8) & 0xFF] << 8) |
                 (uint32_t)sb[cols[col][3] & 0xFF];
    store_be(out + 4 * col, v ^ rk[k + col]);
  }
}

void next_stream_block(Ctx* c) {
  encrypt_block(c, c->counter, c->stream);
  for (int i = 15; i >= 0; --i)  // wraps mod 2^128 like the oracle
    if (++c->counter[i] != 0) break;
  c->used = 0;
}

}  // namespace

extern "C" {

uint64_t khipu_aes_ctx_size() { return sizeof(Ctx); }

int khipu_aes_init(uint8_t* ctx, const uint8_t* key, int key_len,
                   const uint8_t* iv16) {
  if (key_len != 16 && key_len != 24 && key_len != 32) return -1;
  Ctx* c = reinterpret_cast<Ctx*>(ctx);
  const uint8_t* sbox = tables().sbox;
  int nk = key_len / 4;
  c->rounds = nk + 6;
  for (int i = 0; i < nk; ++i) c->rk[i] = load_be(key + 4 * i);
  for (int i = nk; i < 4 * (c->rounds + 1); ++i) {
    uint32_t t = c->rk[i - 1];
    if (i % nk == 0) {
      t = sub_word(sbox, (t << 8) | (t >> 24)) ^
          ((uint32_t)kRcon[i / nk - 1] << 24);
    } else if (nk > 6 && i % nk == 4) {
      t = sub_word(sbox, t);
    }
    c->rk[i] = c->rk[i - nk] ^ t;
  }
  std::memcpy(c->counter, iv16, 16);
  c->used = 16;
  return 0;
}

void khipu_aes_ctr(uint8_t* ctx, const uint8_t* in, uint64_t n,
                   uint8_t* out) {
  Ctx* c = reinterpret_cast<Ctx*>(ctx);
  uint64_t i = 0;
  while (i < n) {
    if (c->used == 16) next_stream_block(c);
    if (c->used == 0 && n - i >= 16) {
      // whole-block fast path: XOR 16 bytes, then advance the counter
      for (int j = 0; j < 16; ++j) out[i + j] = in[i + j] ^ c->stream[j];
      c->used = 16;
      i += 16;
      continue;
    }
    out[i] = in[i] ^ c->stream[c->used++];
    ++i;
  }
}

void khipu_aes_ecb(uint8_t* ctx, const uint8_t* in16, uint8_t* out16) {
  encrypt_block(reinterpret_cast<const Ctx*>(ctx), in16, out16);
}

}  // extern "C"
