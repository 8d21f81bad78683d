// Native Keccak-256/512 (original Keccak padding 0x01, not SHA-3's 0x06).
//
// Role parity: the reference's hot-loop sponge is JVM Scala
// (khipu-base/src/main/scala/khipu/crypto/hash/KeccakCore.scala:38); per
// SURVEY.md §2.10 this is one of the two components whose role needs a
// native equivalent in the rebuild. Device-side batched hashing lives in
// khipu_tpu_torch/ops (CUDA); this C++ path serves the host: content
// addressing, tx/header hashes, the eager MPT, EVM SHA3.
//
// Exposed C ABI (ctypes, see khipu_tpu_torch/native/keccak.py):
//   khipu_keccak(rate_bytes, in, in_len, out, out_len)
//   khipu_keccak_batch(rate_bytes, msgs, offsets, n, out, out_len)
//   khipu_keccak_absorb(state, blocks, nblocks)      streaming sponge
//   khipu_keccak_peek(state, tail, tail_len, out32)  digest, state kept

#include <cstdint>
#include <cstring>

namespace {

constexpr uint64_t kRC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

inline uint64_t rotl(uint64_t x, int s) {
  // s == 0 occurs (kRho[0]); x >> 64 would be undefined behavior.
  return s ? (x << s) | (x >> (64 - s)) : x;
}

void keccak_f1600(uint64_t a[25]) {
  for (int round = 0; round < 24; ++round) {
    // theta
    uint64_t c[5], d[5];
    for (int x = 0; x < 5; ++x)
      c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
    for (int x = 0; x < 5; ++x) {
      d[x] = c[(x + 4) % 5] ^ rotl(c[(x + 1) % 5], 1);
      for (int y = 0; y < 25; y += 5) a[x + y] ^= d[x];
    }
    // rho + pi
    uint64_t b[25];
    static constexpr int kRho[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55,
                                     20, 3,  10, 43, 25, 39, 41, 45, 15,
                                     21, 8,  18, 2,  61, 56, 14};
    for (int x = 0; x < 5; ++x)
      for (int y = 0; y < 5; ++y)
        b[y + 5 * ((2 * x + 3 * y) % 5)] = rotl(a[x + 5 * y], kRho[x + 5 * y]);
    // chi
    for (int y = 0; y < 25; y += 5)
      for (int x = 0; x < 5; ++x)
        a[y + x] = b[y + x] ^ ((~b[y + (x + 1) % 5]) & b[y + (x + 2) % 5]);
    // iota
    a[0] ^= kRC[round];
  }
}

void keccak(int rate, const uint8_t* in, uint64_t in_len, uint8_t* out,
            int out_len) {
  uint64_t a[25] = {0};
  uint8_t block[200];
  // absorb full blocks
  while (in_len >= static_cast<uint64_t>(rate)) {
    for (int i = 0; i < rate / 8; ++i) {
      uint64_t w;
      std::memcpy(&w, in + 8 * i, 8);  // little-endian hosts only
      a[i] ^= w;
    }
    keccak_f1600(a);
    in += rate;
    in_len -= rate;
  }
  // final block with original-Keccak multi-rate padding (0x01 ... 0x80)
  std::memset(block, 0, rate);
  std::memcpy(block, in, in_len);
  block[in_len] = 0x01;
  block[rate - 1] |= 0x80;
  for (int i = 0; i < rate / 8; ++i) {
    uint64_t w;
    std::memcpy(&w, block + 8 * i, 8);
    a[i] ^= w;
  }
  keccak_f1600(a);
  // squeeze (out_len <= rate for 256/512)
  std::memcpy(out, a, out_len);
}

}  // namespace

extern "C" {

void khipu_keccak(int rate, const uint8_t* in, uint64_t in_len, uint8_t* out,
                  int out_len) {
  keccak(rate, in, in_len, out, out_len);
}

// msgs: concatenated messages; offsets: n+1 cumulative offsets.
void khipu_keccak_batch(int rate, const uint8_t* msgs,
                        const uint64_t* offsets, uint64_t n, uint8_t* out,
                        int out_len) {
  for (uint64_t i = 0; i < n; ++i)
    keccak(rate, msgs + offsets[i], offsets[i + 1] - offsets[i],
           out + i * out_len, out_len);
}

// The RLPx frame MAC's running Keccak-256 (rlpx.py _IncrementalKeccak):
// absorb whole 136-byte blocks into a caller-owned 25-lane state, and
// read the digest of state + unabsorbed tail without finalizing it.
void khipu_keccak_absorb(uint64_t* state, const uint8_t* blocks,
                         uint64_t nblocks) {
  for (uint64_t b = 0; b < nblocks; ++b, blocks += 136) {
    for (int i = 0; i < 17; ++i) {
      uint64_t w;
      std::memcpy(&w, blocks + 8 * i, 8);
      state[i] ^= w;
    }
    keccak_f1600(state);
  }
}

void khipu_keccak_peek(const uint64_t* state, const uint8_t* tail,
                       uint64_t tail_len, uint8_t* out32) {
  uint64_t a[25];
  std::memcpy(a, state, sizeof(a));
  uint8_t block[136] = {0};
  std::memcpy(block, tail, tail_len);  // tail_len < 136
  block[tail_len] = 0x01;
  block[135] |= 0x80;
  for (int i = 0; i < 17; ++i) {
    uint64_t w;
    std::memcpy(&w, block + 8 * i, 8);
    a[i] ^= w;
  }
  keccak_f1600(a);
  std::memcpy(out32, a, 32);
}
}
