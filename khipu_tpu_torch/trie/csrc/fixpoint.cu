// Level-ordered fixpoint resolve for Hopper (sm_90a): kernel K5 of
// khipu_tpu_torch.
//
// Replaces trie/fused.py::_build_fused_impl of the JAX package (`run`,
// whose fori_loop hashes every staged row and then scatters every
// child's digest into its parents, `depth` times over), and its hash
// through ops/keccak_pallas.py::_build_from_bytes. Here every row is
// hashed once: the host (trie/fused.py::level_plan) gives each row its
// level (0 without an in-window child, else 1 + its children's largest
// level) and the rows sorted by (level, class); one cooperative launch
// walks the levels, separated by grid.sync().
//
// One thread owns one row of a level and does, in order:
//   1. gather: for each of its triples (off, child), the child's 32-byte
//      digest, from this window's `digests` (child < total_rows) or from
//      the resolved-input tile `ext`, stored at enc[row, off] (offsets
//      are RLP byte positions, not aligned: u32 stores for the aligned
//      middle, bytes at the edges);
//   2. absorb: the row, now final, as a padded row (u64 lanes: rows are
//      136 * nb bytes and 8-byte aligned), with keccak_f1600.cuh;
//   3. its digest into digests[row].
// Only the owner writes a row, so there are no races and no atomics: a
// child with many parents is read by each, never written by them. A
// second launch on the substituted encodings writes the same bytes.
//
// Coherence. L1 is not coherent across SMs: after grid.sync(), a digest
// written on another SM may be stale in this SM's L1 (a 128 B line holds
// four digests). `digests` is therefore read with __ldcg (L2 only) and
// written with __stcg. The encodings need no such care: every byte a
// thread reads of its row was either written by that thread (its own
// stores are visible to it in program order) or written by no one in
// this launch, so a stale L1 copy of a line shared with a neighbouring
// row still holds the current value of every byte this thread reads.
// Other threads never read another row's encoding.
//
// Bound: operations, as K1f: sum over rows of nb * 4,354 32-bit integer
// operations at 16.7e12 a second, against the rows read and written
// once, 8 index bytes a triple, the ext rows and 32 digest bytes a row
// at 3.35e12 B/s. The DAG's depth sets a latency floor that bound
// ignores: L levels, each at least one row's serial sponge (up to 4 rate
// blocks for a full branch) plus a grid barrier. A window's levels hold
// a few thousand rows, one or two warps an SM, too few to hide the
// sponge's dependent chain; so the grid is co-resident (occupancy x
// SMs at most) and a level's warps are spread over every SM, and the
// gather spends few memory round trips and store instructions. Timed on
// the H100 (scripts/k5_ablation.py): the sponges are about two thirds
// of K5's time.

#include <cooperative_groups.h>

#include "../../ops/csrc/keccak_f1600.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace khipu;

constexpr int kThreads = 128;
constexpr int kGather = 4;  // triples whose loads a thread issues together

// The 32 digest bytes w at dst, which has any alignment: u32 stores for
// the aligned middle, bytes for the head and tail (8 stores where dst is
// 4-byte aligned, 11 otherwise, instead of 32 byte stores).
__device__ __forceinline__ void store_digest(uint8_t* dst, const uint64_t w[4]) {
    uint32_t u[8];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        u[2 * k] = (uint32_t)w[k];
        u[2 * k + 1] = (uint32_t)(w[k] >> 32);
    }
    const int r = (int)((uintptr_t)dst & 3);
    if (r == 0) {
        uint32_t* d = reinterpret_cast<uint32_t*>(dst);
#pragma unroll
        for (int k = 0; k < 8; ++k) d[k] = u[k];
        return;
    }
    const int h = 4 - r;  // head: digest bytes [0, h)
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        if (i < h) dst[i] = (uint8_t)(u[0] >> (8 * i));
    }
    uint32_t* d = reinterpret_cast<uint32_t*>(dst + h);  // bytes [h, h + 28)
#pragma unroll
    for (int k = 0; k < 7; ++k) d[k] = __funnelshift_r(u[k], u[k + 1], 8 * h);
#pragma unroll
    for (int i = 0; i < 3; ++i) {  // tail: digest bytes [h + 28, 32)
        if (i < r) dst[h + 28 + i] = (uint8_t)(u[7] >> (8 * (h + i)));
    }
}

// table: k encoding pointers, k + 1 first rows (the last = total_rows),
// k rate-block counts; all int64.
__device__ __forceinline__ void resolve_row(
    long long row, const long long* __restrict__ table, int nclasses,
    const int* __restrict__ tptr, const int* __restrict__ toff,
    const int* __restrict__ tchild, uint8_t* digests,
    const uint8_t* __restrict__ ext, long long total_rows) {
    const long long* base = table + nclasses;
    int lo = 0, hi = nclasses - 1;  // the last class whose base <= row
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (row >= __ldg(base + mid)) lo = mid; else hi = mid - 1;
    }
    const int nb = (int)__ldg(table + 2 * nclasses + 1 + lo);
    uint8_t* enc = reinterpret_cast<uint8_t*>(__ldg(table + lo)) +
                   (row - __ldg(base + lo)) * (long long)(nb * kRate);

    // Up to kGather triples at a time: their indices, then their digests,
    // are loaded together, so a row waits two memory latencies per chunk
    // instead of two per child (a full branch has 16 children). Chunks of
    // 8 ran no faster on the H100 and took 168 registers to 130.
    const int t_end = __ldg(tptr + row + 1);
    for (int t = __ldg(tptr + row); t < t_end; t += kGather) {
        const int n = t_end - t;
        int off[kGather];
        long long child[kGather];
#pragma unroll
        for (int j = 0; j < kGather; ++j) {
            if (j < n) {
                off[j] = __ldg(toff + t + j);
                child[j] = __ldg(tchild + t + j);
            }
        }
        uint64_t w[kGather][4];
#pragma unroll
        for (int j = 0; j < kGather; ++j) {
            if (j >= n) continue;
            if (child[j] < total_rows) {
                const unsigned long long* src =
                    reinterpret_cast<const unsigned long long*>(digests + child[j] * 32);
#pragma unroll
                for (int k = 0; k < 4; ++k) w[j][k] = __ldcg(src + k);
            } else {
                const unsigned long long* src = reinterpret_cast<const unsigned long long*>(
                    ext + (child[j] - total_rows) * 32);
#pragma unroll
                for (int k = 0; k < 4; ++k) w[j][k] = __ldg(src + k);
            }
        }
#pragma unroll
        for (int j = 0; j < kGather; ++j) {
            if (j >= n) continue;
            store_digest(enc + off[j], w[j]);
        }
    }

    const uint64_t* q = reinterpret_cast<const uint64_t*>(enc);
    uint64_t a[25];
#pragma unroll
    for (int i = 0; i < 25; ++i) a[i] = 0;
    for (int b = 0; b < nb; ++b) {
#pragma unroll
        for (int i = 0; i < kLanesPerBlock; ++i) a[i] ^= q[b * kLanesPerBlock + i];
        keccak_f1600(a);
    }
    unsigned long long* out = reinterpret_cast<unsigned long long*>(digests + row * 32);
#pragma unroll
    for (int k = 0; k < 4; ++k) __stcg(out + k, (unsigned long long)a[k]);
}

__global__ void __launch_bounds__(kThreads)
fixpoint_levels_kernel(const long long* __restrict__ table, int nclasses,
                       const int* __restrict__ order,
                       const int* __restrict__ level_ptr, int nlevels,
                       const int* __restrict__ tptr, const int* __restrict__ toff,
                       const int* __restrict__ tchild, uint8_t* digests,
                       const uint8_t* __restrict__ ext, long long total_rows) {
    cg::grid_group grid = cg::this_grid();
    // Consecutive warps of rows go to consecutive blocks (warp w of block
    // b is global warp w * gridDim.x + b), so a level narrower than the
    // grid spreads over every SM instead of filling the first blocks.
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long tid =
        ((long long)(threadIdx.x >> 5) * gridDim.x + blockIdx.x) * 32 + (threadIdx.x & 31);
    for (int l = 0; l < nlevels; ++l) {
        if (l > 0) grid.sync();  // level l - 1's digests are in L2
        const long long end = __ldg(level_ptr + l + 1);
        for (long long i = __ldg(level_ptr + l) + tid; i < end; i += stride) {
            resolve_row(__ldg(order + i), table, nclasses, tptr, toff, tchild,
                        digests, ext, total_rows);
        }
    }
}

}  // namespace

// Blocks of K5 that fit on one SM, and the card's SM count. Returns the
// cudaError_t of the queries.
extern "C" int khipu_fixpoint_levels_occupancy(int device, int* blocks_per_sm,
                                               int* sms) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, fixpoint_levels_kernel, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

// Resolve every level of a packed window in one cooperative launch on
// `stream`: the grid is min(co-resident blocks, warps of the widest
// level). Returns the cudaError_t of the launch; a refused launch
// (cudaErrorCooperativeLaunchTooLarge and the like) is returned, never
// worked around.
extern "C" int khipu_fixpoint_levels(const void* table, int nclasses,
                                     const void* order, const void* level_ptr,
                                     int nlevels, const void* tptr,
                                     const void* toff, const void* tchild,
                                     void* digests, const void* ext,
                                     long long total_rows, long long widest,
                                     int device, void* stream) {
    int per_sm = 0, sms = 0;
    int rc = khipu_fixpoint_levels_occupancy(device, &per_sm, &sms);
    if (rc) return rc;
    if (nlevels <= 0) return 0;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    long long grid = (widest + 31) / 32;  // a block per warp of the widest level
    if (grid < 1) grid = 1;
    if (grid > (long long)per_sm * sms) grid = (long long)per_sm * sms;

    const long long* t = (const long long*)table;
    const int* o = (const int*)order;
    const int* lp = (const int*)level_ptr;
    const int* tp = (const int*)tptr;
    const int* to = (const int*)toff;
    const int* tc = (const int*)tchild;
    uint8_t* dg = (uint8_t*)digests;
    const uint8_t* ex = (const uint8_t*)ext;
    void* args[] = {&t, &nclasses, &o, &lp, &nlevels, &tp, &to, &tc,
                    &dg, &ex, &total_rows};
    cudaError_t err = cudaLaunchCooperativeKernel(
        (const void*)fixpoint_levels_kernel, dim3((unsigned)grid), dim3(kThreads),
        args, 0, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
