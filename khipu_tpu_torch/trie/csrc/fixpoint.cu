// Fixpoint substitution for Hopper (sm_90a): kernel K2 of khipu_tpu_torch.
//
// Replaces the scatter inside trie/fused.py::_build_fused_impl (`run`,
// the body of its fori_loop) of the JAX package, which materializes
// Gf = concat(G, ext) and writes Gf[child] into encs[c][row, off:off+32]
// with a byte-index scatter. Here one thread copies one byte of one
// triple (row, off, child): offsets are placeholder positions inside RLP
// and are not 4-byte aligned, so the byte is the unit. A child below
// total_rows reads this window's digest tensor G; a child at or above it
// reads the resolved-input tile ext at child - total_rows, so the
// concatenation is never built.
//
// Bound: memory. Each triple reads 12 index bytes and 32 digest bytes and
// writes 32 encoding bytes; there is no arithmetic to speak of. At the
// sizes a window gives (thousands of triples) a launch is dominated by
// its fixed cost: capturing the round loop as a CUDA graph, or fusing
// this scatter into K1's epilogue, is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fixpoint_substitute_kernel(uint8_t* __restrict__ enc, long long width,
                           const int32_t* __restrict__ rows,
                           const int32_t* __restrict__ offs,
                           const int32_t* __restrict__ child, long long n,
                           const uint8_t* __restrict__ digests,
                           const uint8_t* __restrict__ ext,
                           long long total_rows) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= n * 32) return;
    const long long i = t >> 5;
    const int b = (int)(t & 31);
    const long long c = child[i];
    const uint8_t* src = c < total_rows ? digests + c * 32
                                        : ext + (c - total_rows) * 32;
    enc[(long long)rows[i] * width + offs[i] + b] = src[b];
}

}  // namespace

// For each of n triples write the 32 digest bytes of `child` into
// enc[row * width + off ...]. Returns the cudaError_t of the launch.
extern "C" int khipu_fixpoint_substitute(void* enc, long long width,
                                         const void* rows, const void* offs,
                                         const void* child, long long n,
                                         const void* digests, const void* ext,
                                         long long total_rows, int device,
                                         void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n <= 0) return 0;
    const long long grid = (n * 32 + kThreads - 1) / kThreads;
    fixpoint_substitute_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
        (uint8_t*)enc, width, (const int32_t*)rows, (const int32_t*)offs,
        (const int32_t*)child, n, (const uint8_t*)digests, (const uint8_t*)ext,
        total_rows);
    return (int)cudaGetLastError();
}
