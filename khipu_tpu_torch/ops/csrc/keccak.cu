// Keccak-256 sponges for Hopper (sm_90a): kernels K1 and K1f of
// khipu_tpu_torch. The permutation is shared with the mirror's kernels
// through keccak_f1600.cuh.
//
// K1 replaces ops/keccak_pallas.py::_make_kernel of the JAX package (the
// Pallas kernel that keeps 50 u32 half-lanes of 1024 messages in VMEM
// tiles; that (lo, hi) u32 split exists only because the TPU vector unit
// has no 64-bit integers) for padded rows: _build_from_bytes,
// _build_from_words and keccak256_batch_pallas.
//   Input: row-major, multi-rate padded u8[n, nblocks * 136], read as
//   little-endian u64 words (the wrapper checks contiguity and 8-byte
//   alignment). Output: u8[n, 32], the first four lanes of the state.
//
// K1f replaces the same kernel with `nwords_in` set, behind
// _build_device_fixed and _build_device_fixed_words: unpadded rows of one
// length L, the multi-rate pad XORed in registers, so no padded copy is
// ever built. Row strides of 20 B (address keys) and 32 B (slot keys) are
// not 8-byte aligned, so K1f loads u32 words where L % 4 == 0 (the
// wrapper checks 4-byte alignment) and bytes otherwise. The pad puts 0x01
// at byte L and 0x80 at the last byte of the last rate block: one byte
// 0x81 when L % 136 == 135, and a block of padding alone when
// L % 136 == 0.
//
// Both: one thread per row, any row count, the ragged edge masked.
//
// Bound: integer ALU. One permutation is 24 rounds of about 180 32-bit
// operations (theta about 80, rho 48 funnel shifts, chi 50 LOP3s, iota 2)
// per message per 136-byte block; a 136-byte block is read once, so
// operations per byte read are far above the card's int32-op to byte
// ratio. Each thread's rows are read with strided loads, which do not
// coalesce; the mirror's kernels (word-major layout) do coalesce, and
// staging rows through shared memory here is later work.

#include "keccak_f1600.cuh"

namespace {

using namespace khipu;

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
keccak256_rows_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                      long long n, int nblocks) {
    const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (row >= n) return;
    const uint64_t* p = in + row * (long long)(nblocks * kLanesPerBlock);
    uint64_t a[25];
#pragma unroll
    for (int i = 0; i < 25; ++i) a[i] = 0;
    for (int b = 0; b < nblocks; ++b) {
#pragma unroll
        for (int i = 0; i < kLanesPerBlock; ++i) a[i] ^= p[b * kLanesPerBlock + i];
        keccak_f1600(a);
    }
    uint64_t* o = out + row * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = a[i];
}

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

}  // namespace

// Hash n padded rows of nblocks rate blocks each on `stream` of `device`.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int khipu_keccak256_rows(const void* in, void* out, long long n,
                                    int nblocks, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n <= 0) return 0;
    const long long grid = (n + kThreads - 1) / kThreads;
    keccak256_rows_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint64_t*)in, (uint64_t*)out, n, nblocks);
    return (int)cudaGetLastError();
}

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
