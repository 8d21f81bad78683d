// The device node mirror's kernels for Hopper (sm_90a): K3 (hash the
// resident rows) and K4 (verify them against their claimed digests) of
// khipu_tpu_torch.
//
// Replaces storage/device_mirror.py::_class_kernels of the JAX package:
// its `run` (the Pallas sponge of ops/keccak_pallas.py::_build over
// resident planes u32[tiles, nwords, 8, 128], with `nwords_in` for
// exact-length classes) and its `verify` (run, compare with `claimed`,
// sum the mismatching rows).
//
// Layout (the port's own): a class keeps `resident` as 32-bit words
// [nwords, ld] and `claimed` as [8, ld], word-major across the whole
// class — the TPU tile flattened. Word w of row r is at w * ld + r. One
// thread owns one row, so a warp's loads of word w fall on 128
// consecutive bytes and coalesce. A generic class stores rows multi-rate
// padded (nwords_in == nblocks * 34); an exact-length class stores rows
// of exactly nwords_in words unpadded and the pad is XORed in registers:
// 0x01 into word nwords_in, 0x80000000 into the last word of the last
// rate block (both into one word when they meet).
//
// K3 writes digests word-major, [8, n] with its own leading dimension:
// the `claimed` layout. It serves each class's filler digest and the
// self-claims of partial tiles. K4 runs the same sponge, compares the 8
// digest words with `claimed` in registers, counts the block's
// mismatching rows with __syncthreads_count and adds them with one
// atomicAdd per block into one int32 count. One launch per class.
//
// Bound: integer ALU, like K1f (about 4,354 32-bit operations per row per
// rate block against 136 bytes read); the word-major loads coalesce.

#include "../../ops/csrc/keccak_f1600.cuh"

namespace {

using namespace khipu;

constexpr int kThreads = 128;

// The sponge over row r of a word-major class.
__device__ __forceinline__ void sponge_word_major(const uint32_t* __restrict__ in,
                                                  long long ld, long long r,
                                                  int nwords_in, int nblocks,
                                                  uint64_t a[25]) {
#pragma unroll
    for (int i = 0; i < 25; ++i) a[i] = 0;
    const int total = nblocks * kWordsPerBlock;
    const bool fused_pad = nwords_in < total;
    for (int b = 0; b < nblocks; ++b) {
#pragma unroll
        for (int i = 0; i < kLanesPerBlock; ++i) {
            const int w = b * kWordsPerBlock + 2 * i;
            uint32_t lo = w < nwords_in ? in[(long long)w * ld + r] : 0u;
            uint32_t hi = w + 1 < nwords_in ? in[(long long)(w + 1) * ld + r] : 0u;
            if (fused_pad) {
                if (w == nwords_in) lo ^= 0x01u;
                if (w + 1 == nwords_in) hi ^= 0x01u;
                if (w + 1 == total - 1) hi ^= 0x80000000u;
            }
            a[i] ^= (uint64_t)lo | ((uint64_t)hi << 32);
        }
        keccak_f1600(a);
    }
}

__global__ void __launch_bounds__(kThreads)
mirror_hash_kernel(const uint32_t* __restrict__ in, long long ld, long long n,
                   int nwords_in, int nblocks, uint32_t* __restrict__ out,
                   long long ld_out) {
    const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= n) return;
    uint64_t a[25];
    sponge_word_major(in, ld, r, nwords_in, nblocks, a);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        out[(long long)(2 * k) * ld_out + r] = (uint32_t)a[k];
        out[(long long)(2 * k + 1) * ld_out + r] = (uint32_t)(a[k] >> 32);
    }
}

__global__ void __launch_bounds__(kThreads)
mirror_verify_kernel(const uint32_t* __restrict__ in, long long ld, long long n,
                     int nwords_in, int nblocks,
                     const uint32_t* __restrict__ claimed, long long ld_claimed,
                     int* __restrict__ count) {
    const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    int bad = 0;
    if (r < n) {
        uint64_t a[25];
        sponge_word_major(in, ld, r, nwords_in, nblocks, a);
        uint32_t diff = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            diff |= (uint32_t)a[k] ^ claimed[(long long)(2 * k) * ld_claimed + r];
            diff |= (uint32_t)(a[k] >> 32) ^ claimed[(long long)(2 * k + 1) * ld_claimed + r];
        }
        bad = diff != 0;
    }
    // every thread of the block reaches this barrier, in range or not
    const int block_bad = __syncthreads_count(bad);
    if (threadIdx.x == 0 && block_bad) atomicAdd(count, block_bad);
}

}  // namespace

// K3: digests of rows [0, n) of a word-major class (row r, word w at
// in[w * ld + r]) into out[w * ld_out + r], w < 8. Returns the launch's
// cudaError_t.
extern "C" int khipu_mirror_hash(const void* in, long long ld, long long n,
                                 int nwords_in, int nblocks, void* out,
                                 long long ld_out, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n <= 0) return 0;
    const long long grid = (n + kThreads - 1) / kThreads;
    mirror_hash_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)in, ld, n, nwords_in, nblocks, (uint32_t*)out, ld_out);
    return (int)cudaGetLastError();
}

// K4: add to *count (int32 on the card, zeroed by the caller) the number
// of rows [0, n) whose digest differs from claimed[w * ld_claimed + r].
// Returns the launch's cudaError_t.
extern "C" int khipu_mirror_verify(const void* in, long long ld, long long n,
                                   int nwords_in, int nblocks,
                                   const void* claimed, long long ld_claimed,
                                   void* count, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n <= 0) return 0;
    const long long grid = (n + kThreads - 1) / kThreads;
    mirror_verify_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)in, ld, n, nwords_in, nblocks, (const uint32_t*)claimed,
        ld_claimed, (int*)count);
    return (int)cudaGetLastError();
}
