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
// thread owns one row. A generic class stores rows multi-rate padded
// (nwords_in == nblocks * 34); an exact-length class stores rows of
// exactly nwords_in words unpadded and the pad is XORed in registers:
// 0x01 into word nwords_in, 0x80000000 into the last word of the last
// rate block (both into one word when they meet).
//
// Both kernels are bound by the integer ALU, like K1f: about 4,354
// 32-bit operations per row per rate block against 136 bytes read, and
// they run K1f's permutation. What sets them apart from K1f is how the
// sponge is fed.
//
// K3 (sponge_word_major) loads its words straight from the planes: a
// runtime address, a bounds predicate and the pad compares per word, on
// the same INT32 lanes as the permutation, and every permutation waits
// for its block's 34 loads. K3 writes digests word-major, [8, n] with its
// own leading dimension: the `claimed` layout. It serves each class's
// filler digest and the self-claims of partial tiles, a few tiles at a
// time, so it keeps this loader.
//
// K4 verifies whole classes (the snapshot verify: 10M rows in one launch)
// and feeds its sponge with the Tensor Memory Accelerator. A CTA of 128
// threads owns a tile of 128 rows. Tensor maps describe the planes as
// [nwords_in words, n rows] and the claims as [8, n]; one TMA copy moves
// one rate block of a tile (128 rows x 34 words, 17,408 B) into shared
// memory, and the words at or past nwords_in, or of rows at or past n,
// arrive as zeros, so the last block of an exact class needs no
// predicate. Thread 0 starts the copy of the CTA's next block before its
// warp waits for the current one, into a ring of two stages, each behind
// a full and an empty mbarrier: a block is in flight for a whole
// permutation. Lane i is then tile[2i][t] | tile[2i + 1][t], read at
// immediate offsets, neighbouring threads on neighbouring words (no bank
// conflicts). The last block of a tile is peeled: the pad (exact classes
// only) is XORed there, and the tile's claims arrive with it and are
// compared in registers. The grid is persistent (the wrapper's
// mirror_cuda.verify_plan: at most the CTAs the card holds at once), so
// the next tile's first block is in flight during a tile's last
// permutation; each thread keeps its mismatches in a register and each
// CTA adds them with one atomicAdd into one int32 count. One launch per
// class. The wrapper checks what a tensor map needs: the planes' and the
// claims' bases 16-byte aligned, their leading dimensions a multiple of 4
// words, n < 2^31 (TMA coordinates are signed 32-bit).

#include <cuda.h>  // CUtensorMap; the encoder is looked up at run time
#include <cstring>

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

// ---------------------------------------------------------------- K4
constexpr int kTileRows = 128;  // rows a tile and threads a CTA: the TMA box's inner extent
constexpr int kStages = 2;      // rate blocks of a CTA in shared memory at once

// One stage of the ring: one rate block of a tile, and the tile's claims
// when the block is its last.
struct Stage {
    uint32_t words[kWordsPerBlock][kTileRows];
    uint32_t claims[8][kTileRows];
};
constexpr int kBlockBytes = sizeof(uint32_t) * kWordsPerBlock * kTileRows;  // 17,408
constexpr int kClaimBytes = sizeof(uint32_t) * 8 * kTileRows;               // 4,096
// the stages, then a full and an empty barrier each and the CTA's count
constexpr int kSmemBytes = kStages * (int)sizeof(Stage) + 2 * kStages * 8 + 8;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t arrivals) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_addr(bar)), "r"(arrivals) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                 :: "r"(smem_addr(bar)) : "memory");
}

// one arrival that also expects `bytes` from the copies of this phase
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile("{\n\t.reg .pred p;\n\t"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                     "selp.u32 %0, 1, 0, p;\n\t}"
                     : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    } while (!done);
}

// the box of `map` at (row, word) into dst; completes on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int row, int word, uint64_t* bar) {
    asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
                 " [%0], [%1, {%2, %3}], [%4];"
                 :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
                    "r"(row), "r"(word),
                    "r"(smem_addr(bar))
                 : "memory");
}

__global__ void __launch_bounds__(kTileRows)
mirror_verify_kernel(const __grid_constant__ CUtensorMap rows_map,
                     const __grid_constant__ CUtensorMap claims_map, int n,
                     int nwords_in, int nblocks, int* __restrict__ count) {
    // no static shared memory, so the dynamic block starts where TMA
    // wants it: 128-byte aligned
    extern __shared__ __align__(128) unsigned char smem[];
    Stage* stage = reinterpret_cast<Stage*>(smem);
    uint64_t* full = reinterpret_cast<uint64_t*>(stage + kStages);
    uint64_t* empty = full + kStages;
    int& cta_bad = *reinterpret_cast<int*>(empty + kStages);
    const int t = threadIdx.x;
    // this CTA's tiles are blockIdx.x, + gridDim.x, ...; step k is block
    // k % nblocks of its k / nblocks-th
    const int tiles = n / kTileRows + (n % kTileRows != 0);
    const int mine = (int)blockIdx.x < tiles
                         ? (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
    const int steps = mine * nblocks;
    if (t == 0) {
        asm volatile("prefetch.tensormap [%0];"
                     :: "l"(reinterpret_cast<uint64_t>(&rows_map)) : "memory");
        asm volatile("prefetch.tensormap [%0];"
                     :: "l"(reinterpret_cast<uint64_t>(&claims_map)) : "memory");
        for (int s = 0; s < kStages; ++s) {
            bar_init(&full[s], 1);
            bar_init(&empty[s], kTileRows);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        cta_bad = 0;
    }
    __syncthreads();

    // thread 0: the copies of its next step, pk (block pb of the tile at
    // row prow), into stage pk % kStages, once every thread has released
    // that stage's previous step
    unsigned pk = 0;
    int pb = 0;
    long long prow = (long long)blockIdx.x * kTileRows;
    auto load_next = [&]() {
        const unsigned s = pk % kStages, use = pk / kStages;
        if (use > 0) bar_wait(&empty[s], (use - 1) & 1);
        const bool last = pb == nblocks - 1;
        bar_expect(&full[s], kBlockBytes + (last ? kClaimBytes : 0));
        tma_load(stage[s].words, &rows_map, (int)prow, pb * kWordsPerBlock, &full[s]);
        if (last) tma_load(stage[s].claims, &claims_map, (int)prow, 0, &full[s]);
        ++pk;
        ++pb;
        if (last) {
            pb = 0;
            prow += (long long)gridDim.x * kTileRows;
        }
    };

    // the pad of an exact class: 0x01 into word nwords_in of the row, the
    // last block's word pad_word; 0x80000000 into its word 33
    const bool exact = nwords_in < nblocks * kWordsPerBlock;
    const int pad_word = nwords_in - (nblocks - 1) * kWordsPerBlock;
    const uint64_t pad_bit = exact ? 1ull << (32 * (pad_word & 1)) : 0;
    const uint64_t end_bit = exact ? 0x8000000000000000ull : 0;
    int bad = 0;
    if (t == 0 && steps > 0) load_next();
    unsigned k = 0;  // this thread's step
    for (int i = 0; i < mine; ++i) {
        uint64_t a[25];
#pragma unroll
        for (int j = 0; j < 25; ++j) a[j] = 0;
        for (int b = 0; b < nblocks - 1; ++b, ++k) {
            if (t == 0) load_next();  // step k + 1: a tile's last block comes after
            const unsigned s = k % kStages;
            bar_wait(&full[s], (k / kStages) & 1);
            const Stage& st = stage[s];
#pragma unroll
            for (int j = 0; j < kLanesPerBlock; ++j)
                a[j] ^= (uint64_t)st.words[2 * j][t] | ((uint64_t)st.words[2 * j + 1][t] << 32);
            bar_arrive(&empty[s]);
            keccak_f1600(a);
        }
        // the last block, peeled: pad, permute, compare with the claims
        if (t == 0 && k + 1 < (unsigned)steps) load_next();
        const unsigned s = k % kStages;
        bar_wait(&full[s], (k / kStages) & 1);
        const Stage& st = stage[s];
#pragma unroll
        for (int j = 0; j < kLanesPerBlock; ++j) {
            uint64_t lane = (uint64_t)st.words[2 * j][t] | ((uint64_t)st.words[2 * j + 1][t] << 32);
            if (j == pad_word >> 1) lane ^= pad_bit;
            if (j == kLanesPerBlock - 1) lane ^= end_bit;
            a[j] ^= lane;
        }
        keccak_f1600(a);
        uint32_t diff = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            diff |= (uint32_t)a[j] ^ st.claims[2 * j][t];
            diff |= (uint32_t)(a[j] >> 32) ^ st.claims[2 * j + 1][t];
        }
        bar_arrive(&empty[s]);
        const long long row = (long long)((int)blockIdx.x + i * (int)gridDim.x) * kTileRows + t;
        bad += diff != 0 && row < n;
        ++k;
    }
    bad = (int)__reduce_add_sync(0xffffffffu, (unsigned)bad);
    if ((t & 31) == 0 && bad) atomicAdd(&cta_bad, bad);
    __syncthreads();
    if (t == 0 && cta_bad) atomicAdd(count, cta_bad);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime, so the
// library needs no -lcuda; null where the installed CUDA lacks it
EncodeTiled encode_tiled() {
    static const EncodeTiled fn = [] {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &found);
#endif
        return err == cudaSuccess && found == cudaDriverEntryPointSuccess
                   ? reinterpret_cast<EncodeTiled>(p) : nullptr;
    }();
    return fn;
}

// words [words, n] at base, leading dimension ld words, in boxes of
// kTileRows rows x box_words words; out-of-bounds elements read as zero
CUresult encode_planes(EncodeTiled encode, CUtensorMap* map, const void* base,
                       long long ld, int n, int words, int box_words) {
    const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)words};
    const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(uint32_t)};
    const cuuint32_t box[2] = {(cuuint32_t)kTileRows, (cuuint32_t)box_words};
    const cuuint32_t unit[2] = {1, 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, const_cast<void*>(base),
                  dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
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

// K4's tensor maps: the planes (row r, word w at in[w * ld + r], w <
// nwords_in) and the claims (claimed[w * ld_claimed + r], w < 8) of rows
// [0, n), written as two CUtensorMaps (2 x 128 bytes) into `maps`.
// Returns 0, the CUresult of a refused encode, or -1 where the
// installed CUDA has no encoder.
extern "C" int khipu_mirror_verify_maps(const void* in, long long ld, int n,
                                        int nwords_in, const void* claimed,
                                        long long ld_claimed, void* maps) {
    const EncodeTiled encode = encode_tiled();
    if (!encode) return -1;
    CUtensorMap m[2];
    CUresult rc = encode_planes(encode, &m[0], in, ld, n, nwords_in, kWordsPerBlock);
    if (rc == CUDA_SUCCESS) rc = encode_planes(encode, &m[1], claimed, ld_claimed, n, 8, 8);
    if (rc != CUDA_SUCCESS) return (int)rc;
    memcpy(maps, m, sizeof(m));
    return 0;
}

// K4's CTAs resident on the whole card at once, into *cap; first allows
// K4 its dynamic shared memory on the card. Once a card, before its
// first K4 launch. Returns the cudaError_t of the calls.
extern "C" int khipu_mirror_verify_cap(int device, int* cap) {
    cudaError_t err = cudaSetDevice(device);
    int sms = 0, per_sm = 0;
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(mirror_verify_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, mirror_verify_kernel, kTileRows, kSmemBytes);
    *cap = sms * per_sm;
    return (int)err;
}

// K4: add to *count (int32 on the card, zeroed by the caller) the number
// of rows [0, n) whose digest differs from its claim, over the tensor
// maps of khipu_mirror_verify_maps, on `grid` CTAs (at most the tile
// count, ceil(n / 128)). Returns the launch's cudaError_t.
extern "C" int khipu_mirror_verify(const void* maps, int n, int nwords_in,
                                   int nblocks, int grid, void* count,
                                   int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n <= 0) return 0;
    CUtensorMap m[2];
    memcpy(m, maps, sizeof(m));
    mirror_verify_kernel<<<(unsigned)grid, kTileRows, kSmemBytes, (cudaStream_t)stream>>>(
        m[0], m[1], n, nwords_in, nblocks, (int*)count);
    return (int)cudaGetLastError();
}
