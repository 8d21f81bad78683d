// Keccak-256 sponges for Hopper (sm_90a): kernels K1f and K1r of
// khipu_tpu_torch. The permutation of row mode and K1f is shared with the
// mirror's and the fixpoint's kernels through keccak_f1600.cuh.
//
// Both replace ops/keccak_pallas.py::_make_kernel of the JAX package (the
// Pallas kernel that keeps 50 u32 half-lanes of 1024 messages in VMEM
// tiles; that (lo, hi) u32 split exists only because the TPU vector unit
// has no 64-bit integers).
//
// K1f, behind _build_device_fixed and _build_device_fixed_words (the
// kernel with `nwords_in` set): unpadded rows of one length L, the
// multi-rate pad XORed in registers, so no padded copy is ever built.
// Row strides of 20 B (address keys) and 32 B (slot keys) are not 8-byte
// aligned, so K1f loads u32 words where L % 4 == 0 (the wrapper checks
// 4-byte alignment) and bytes otherwise. One thread per row.
//
// K1r, behind keccak256_batch_pallas, _build_from_bytes and
// _build_from_words (the JAX package buckets a batch by rate class and
// launches once per class): messages of any lengths in one u8 blob, each
// at an 8-byte aligned offset, with int32 offsets and lengths. One launch
// hashes the whole batch, whatever its mix of rate classes, and pads in
// registers. Two layouts:
//   row mode: one thread per message, the shared keccak_f1600, K1f's
//   design; it holds K1f's throughput at 1M x 576 B.
//   column mode: five threads per message, thread x keeping column x
//   (lanes (x, 0..4)) in registers; six messages a warp.
// The wrapper chooses column mode up to keccak_cuda.COLUMN_MAX_ROWS rows.
//
// The pad (both kernels): 0x01 at byte L and 0x80 at the last byte of the
// last rate block: one byte 0x81 when L % 136 == 135, and a block of
// padding alone when L % 136 == 0 (L = 0 included).
//
// Bound. At 1M rows: the integer ALU. One permutation is 24 rounds of
// about 180 32-bit operations (theta about 80, rho 48 funnel shifts, chi
// 50 LOP3s, iota 2) per message per 136-byte block, far above the card's
// int32-op to byte ratio. At fast sync's 100-row batches: the latency of
// one message's chain of permutations, since 100 messages fill 4 warps
// in row mode (one SM) and a lone warp issues integer work at 16 lanes a
// cycle per SM sub-partition. Column mode shortens that chain: a thread
// issues about 75 instructions a round instead of 180, and the batch's
// ~17 warps land on different SMs (grids of two-warp blocks).

#include "keccak_f1600.cuh"

namespace {

using namespace khipu;

constexpr int kThreads = 128;

// Lane i of a rate block whose first byte is at p: u32 loads (kWords) or
// byte loads. `valid` bytes of the block belong to the message; the rest
// read as zero. Full blocks pass valid = 136.
template <bool kWords>
__device__ __forceinline__ uint64_t load_lane(const uint8_t* p, int i, int valid) {
    uint64_t lane = 0;
    if (kWords) {
        const uint32_t* q = reinterpret_cast<const uint32_t*>(p);
        // valid % 4 == 0 on this path, so a word is all message or none
        if (8 * i < valid) lane = q[2 * i];
        if (8 * i + 4 < valid) lane |= (uint64_t)q[2 * i + 1] << 32;
    } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            if (8 * i + k < valid) lane |= (uint64_t)p[8 * i + k] << (8 * k);
        }
    }
    return lane;
}

template <bool kWords>
__global__ void __launch_bounds__(kThreads)
keccak256_fixed_kernel(const uint8_t* __restrict__ in, uint64_t* __restrict__ out,
                       long long n, int length) {
    const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (row >= n) return;
    const uint8_t* p = in + row * (long long)length;
    const int full = length / kRate;     // rate blocks of message bytes only
    const int tail = length - full * kRate;  // 0..135 message bytes in the last
    uint64_t a[25];
#pragma unroll
    for (int i = 0; i < 25; ++i) a[i] = 0;
    for (int b = 0; b < full; ++b) {
#pragma unroll
        for (int i = 0; i < kLanesPerBlock; ++i)
            a[i] ^= load_lane<kWords>(p + b * kRate, i, kRate);
        keccak_f1600(a);
    }
    // the last block: the message tail, then the pad in registers
    const uint8_t* last = p + full * kRate;
    const int pad_lane = tail >> 3;
    const uint64_t pad_bit = (uint64_t)0x01 << (8 * (tail & 7));
#pragma unroll
    for (int i = 0; i < kLanesPerBlock; ++i) {
        uint64_t lane = load_lane<kWords>(last, i, tail);
        if (i == pad_lane) lane ^= pad_bit;
        if (i == kLanesPerBlock - 1) lane ^= 0x8000000000000000ull;
        a[i] ^= lane;
    }
    keccak_f1600(a);
    uint64_t* o = out + row * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = a[i];
}

// ---------------------------------------------------------------- K1r
// Lane of 8 message bytes starting at byte `at` of a block whose first
// `valid` bytes belong to the message: one aligned u64 load (the block
// starts 8-byte aligned), bytes at or past `valid` masked to zero. The
// load may cover up to 7 bytes past the message; the wrapper checks that
// offset + round_up(length, 8) stays inside the blob.
__device__ __forceinline__ uint64_t ragged_lane(const uint8_t* block, int at, int valid) {
    if (at >= valid) return 0;
    const uint64_t v = *reinterpret_cast<const uint64_t*>(block + at);
    const int keep = valid - at;
    return keep >= 8 ? v : v & ((1ull << (8 * keep)) - 1);
}

// The multi-rate pad of lane i of the last block, `tail` message bytes in
// it: 0x01 at byte tail, 0x80 at byte 135 (one byte 0x81 when tail == 135).
__device__ __forceinline__ uint64_t pad_lane(int i, int tail) {
    uint64_t pad = 0;
    if (i == (tail >> 3)) pad = 1ull << (8 * (tail & 7));
    if (i == kLanesPerBlock - 1) pad ^= 0x8000000000000000ull;
    return pad;
}

// Row mode: one thread per message, as K1f, on the ragged input.
__global__ void __launch_bounds__(kThreads)
keccak256_ragged_rows_kernel(const uint8_t* __restrict__ blob,
                             const int* __restrict__ offsets,
                             const int* __restrict__ lengths,
                             uint64_t* __restrict__ out, int n) {
    const int row = blockIdx.x * blockDim.x + threadIdx.x;
    if (row >= n) return;
    const uint8_t* p = blob + offsets[row];
    const int len = lengths[row];
    const int full = len / kRate;
    const int tail = len - full * kRate;
    uint64_t a[25];
#pragma unroll
    for (int i = 0; i < 25; ++i) a[i] = 0;
    for (int b = 0; b < full; ++b) {
        const uint64_t* q = reinterpret_cast<const uint64_t*>(p + b * kRate);
#pragma unroll
        for (int i = 0; i < kLanesPerBlock; ++i) a[i] ^= q[i];
        keccak_f1600(a);
    }
    const uint8_t* last = p + full * kRate;
#pragma unroll
    for (int i = 0; i < kLanesPerBlock; ++i)
        a[i] ^= ragged_lane(last, 8 * i, tail) ^ pad_lane(i, tail);
    keccak_f1600(a);
    uint64_t* o = out + 4ll * row;
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = a[i];
}

// Column mode: five threads own one message; thread x keeps column x,
// lanes (x, 0..4), as a[y]. Six messages share a warp (lanes 0-29).
constexpr int kColThreads = 64;  // two warps a block
constexpr int kColWarps = kColThreads / 32;
constexpr int kGroups = 6;       // messages a warp
constexpr unsigned kColMask = 0x3FFFFFFFu;

// rho's rotation of lane (x, y), at x * 5 + y
static __constant__ int kRhoColumns[25] = {
    0, 36, 3, 41, 18,  1, 44, 10, 45, 2,  62, 6, 43, 15, 61,
    28, 55, 25, 21, 56,  27, 20, 39, 8, 14,
};

// Per-thread constants of the column permutation.
struct ColumnThread {
    int x, g;              // column, message slot in the warp
    int x1, x2;            // columns x + 1, x + 2 (mod 5)
    int left, right;       // lanes of columns x - 1, x + 1 of this message
    uint32_t n[5];         // rho of lane (x, y), mod 32
    int hi_at[5], lo_at[5];  // pi: the tile words its two halves go to
    uint64_t iota;         // all ones on x == 0
};

// One round; tile is this warp's exchange tile for the round,
// [lane index x + 5y][message slot], each entry two u32 words (lo, hi).
__device__ __forceinline__ void column_round(uint64_t a[5], const ColumnThread& t,
                                             uint2 (*tile)[kGroups], uint64_t rc) {
    // theta: the column parity is local; D[x] = C[x-1] ^ rotl(C[x+1], 1)
    const uint64_t c = a[0] ^ a[1] ^ a[2] ^ a[3] ^ a[4];
    const uint64_t cl = __shfl_sync(kColMask, c, t.left);
    const uint64_t cr = __shfl_sync(kColMask, c, t.right);
    const uint64_t d = cl ^ rotl64(cr, 1);
    // rho by a per-thread amount r, then pi: lane (x, y) goes to
    // (y, 2x + 3y mod 5). Two funnel shifts by r mod 32 give the words
    // of a rotation by r mod 32; r >= 32 swaps them, which costs nothing
    // here: the swap is in the store addresses. No branch, so the five
    // threads of a message never diverge, and no shift by 64.
    uint32_t* words = reinterpret_cast<uint32_t*>(tile);
#pragma unroll
    for (int y = 0; y < 5; ++y) {
        const uint64_t v = a[y] ^ d;
        const uint32_t lo = (uint32_t)v, hi = (uint32_t)(v >> 32);
        words[t.hi_at[y]] = __funnelshift_l(lo, hi, t.n[y]);
        words[t.lo_at[y]] = __funnelshift_l(hi, lo, t.n[y]);
    }
    __syncwarp(kColMask);
    // chi along each row: own column and columns x + 1, x + 2
#pragma unroll
    for (int y = 0; y < 5; ++y) {
        const uint2 w0 = tile[t.x + 5 * y][t.g];
        const uint2 w1 = tile[t.x1 + 5 * y][t.g];
        const uint2 w2 = tile[t.x2 + 5 * y][t.g];
        const uint64_t b0 = ((uint64_t)w0.y << 32) | w0.x;
        const uint64_t b1 = ((uint64_t)w1.y << 32) | w1.x;
        const uint64_t b2 = ((uint64_t)w2.y << 32) | w2.x;
        a[y] = b0 ^ (~b1 & b2);
    }
    // iota on lane (0, 0)
    a[0] ^= rc & t.iota;
}

// Keccak-f[1600] on one column per thread. Rounds alternate between two
// tiles, so one warp barrier a round suffices: a round's stores go to
// the tile whose last reads, two rounds back, came before the previous
// round's barrier.
__device__ __forceinline__ void keccak_f1600_columns(
    uint64_t a[5], const ColumnThread& t, uint2 (*tiles)[25][kGroups]) {
#pragma unroll 1
    for (int r = 0; r < 24; r += 2) {
        column_round(a, t, tiles[0], kRoundConstants[r]);
        column_round(a, t, tiles[1], kRoundConstants[r + 1]);
    }
}

// This thread's rate lanes x, x + 5, x + 10, x + 15 (< 17) of block b,
// the pad XORed in on the last block (nb blocks, len message bytes).
// Loaded at the top of the block's own step: issuing them during the
// previous block's permutation instead made column mode 15 % slower
// (scripts/k1_ablation.py, variant "prefetch").
__device__ __forceinline__ void column_block(const uint8_t* p, int len, int nb,
                                             int b, int x, uint64_t v[4]) {
    const bool last = b == nb - 1;
    const int valid = last ? len - b * kRate : kRate;
#pragma unroll
    for (int y = 0; y < 4; ++y) {
        const int i = x + 5 * y;
        v[y] = 0;
        if (i < kLanesPerBlock) {
            v[y] = ragged_lane(p + b * kRate, 8 * i, valid);
            if (last) v[y] ^= pad_lane(i, valid);
        }
    }
}

__global__ void __launch_bounds__(kColThreads)
keccak256_ragged_columns_kernel(const uint8_t* __restrict__ blob,
                                const int* __restrict__ offsets,
                                const int* __restrict__ lengths,
                                uint64_t* __restrict__ out, int n) {
    __shared__ uint2 tiles[kColWarps][2][25][kGroups];
    const int lane = threadIdx.x & 31;
    if (lane >= 5 * kGroups) return;  // every warp op below names lanes 0-29
    const int warp = threadIdx.x >> 5;
    const int g = lane / 5;
    const int x = lane - 5 * g;
    const long long row = ((long long)blockIdx.x * kColWarps + warp) * kGroups + g;
    // a slot past the last row runs the permutations on a zero state and
    // writes nothing, so every lane reaches every warp barrier
    const bool live = row < n;
    const uint8_t* p = blob;
    int len = 0;
    if (live) {
        p += offsets[row];
        len = lengths[row];
    }
    const int nb = live ? len / kRate + 1 : 0;
    // each group loops to the warp's largest block count; a finished
    // group has written its digest and keeps permuting unread state
    const int warp_nb = (int)__reduce_max_sync(kColMask, (unsigned)nb);
    ColumnThread t;
    t.x = x;
    t.g = g;
    t.x1 = x == 4 ? 0 : x + 1;
    t.x2 = t.x1 == 4 ? 0 : t.x1 + 1;
    t.left = 5 * g + (x == 0 ? 4 : x - 1);
    t.right = 5 * g + t.x1;
#pragma unroll
    for (int y = 0; y < 5; ++y) {
        const int rho = kRhoColumns[x * 5 + y];
        const int entry = 2 * ((y + 5 * ((2 * x + 3 * y) % 5)) * kGroups + g);
        t.n[y] = rho & 31;
        t.hi_at[y] = entry + (rho & 32 ? 0 : 1);
        t.lo_at[y] = entry + (rho & 32 ? 1 : 0);
    }
    t.iota = x == 0 ? ~0ull : 0ull;
    uint64_t a[5] = {0, 0, 0, 0, 0};
    for (int b = 0; b < warp_nb; ++b) {
        if (b < nb) {
            uint64_t v[4];
            column_block(p, len, nb, b, x, v);
#pragma unroll
            for (int y = 0; y < 4; ++y) a[y] ^= v[y];
        }
        keccak_f1600_columns(a, t, tiles[warp]);
        // digest lanes 0-3 are (x, 0) of threads x = 0..3
        if (b == nb - 1 && x < 4) out[4 * row + x] = a[0];
    }
}

}  // namespace

// K1f: hash n unpadded rows of `length` bytes each (contiguous, row
// stride = length). `words` selects u32 loads: length % 4 == 0 and `in`
// 4-byte aligned, checked by the wrapper. Returns the launch's cudaError_t.
extern "C" int khipu_keccak256_fixed(const void* in, void* out, long long n,
                                     int length, int words, int device,
                                     void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n <= 0) return 0;
    const long long grid = (n + kThreads - 1) / kThreads;
    if (words) {
        keccak256_fixed_kernel<true><<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)in, (uint64_t*)out, n, length);
    } else {
        keccak256_fixed_kernel<false><<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)in, (uint64_t*)out, n, length);
    }
    return (int)cudaGetLastError();
}

// K1r: hash n messages of any lengths; message i is header[n + i] bytes
// at blob + header[i] (header: int32 offsets then lengths; offsets
// 8-byte aligned, checked by the wrapper with the bounds). `columns`
// picks column mode (five threads a message) over row mode (one
// thread); the wrapper chooses by row count. Returns the launch's
// cudaError_t.
extern "C" int khipu_keccak256_ragged(const void* blob, const void* header,
                                      void* out, int n, int columns,
                                      int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n <= 0) return 0;
    const int* offsets = (const int*)header;
    const int* lengths = offsets + n;
    if (columns) {
        const long long warps = (n + kGroups - 1) / kGroups;
        const long long grid = (warps + kColWarps - 1) / kColWarps;
        keccak256_ragged_columns_kernel<<<(unsigned)grid, kColThreads, 0,
                                          (cudaStream_t)stream>>>(
            (const uint8_t*)blob, offsets, lengths, (uint64_t*)out, n);
    } else {
        const long long grid = (n + kThreads - 1) / kThreads;
        keccak256_ragged_rows_kernel<<<(unsigned)grid, kThreads, 0,
                                       (cudaStream_t)stream>>>(
            (const uint8_t*)blob, offsets, lengths, (uint64_t*)out, n);
    }
    return (int)cudaGetLastError();
}
