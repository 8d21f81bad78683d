// K6: the execute stage's row validation for Hopper (sm_90a), of
// khipu_tpu_torch.
//
// Replaces trie/fused.py::_exec_validate_fn of the JAX package (an XLA
// program, reached through fused_exec_validate): for every gathered
// account row of a scheduled batch, the transaction's nonce must equal
// the account's, and the account's balance must cover the upfront cost.
//
// Layout (the port's own): one packed row of 20 32-bit words a
// transaction, row-major, so the batch is one upload:
//   words 0-1   the transaction's nonce, big-endian (hi, lo)
//   words 2-3   the account's nonce, big-endian (hi, lo)
//   words 4-11  the balance, 8 big-endian limbs
//   words 12-19 the upfront cost, 8 big-endian limbs
// One thread owns one row: five 16-byte loads (a row is 80 bytes, so
// every row of a 16-byte aligned buffer is 16-byte aligned), the nonce
// compared as two words, the balance >= upfront taken lexicographically
// (the first limb that differs decides; all equal passes), and one byte
// of mask written (1 = valid). The TPU's power-of-two row padding is
// not needed: the grid covers the n rows and masks the ragged edge.
//
// Bound: bytes, 81 a row (80 read, 1 written) against a handful of
// compares; at the batch sizes the replay gives (tens to hundreds of
// rows) one launch's fixed cost dominates.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWords = 20;

__global__ void exec_validate_kernel(const uint32_t* __restrict__ rows,
                                     long long n, uint8_t* __restrict__ ok) {
    const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= n) return;
    const uint4* p = reinterpret_cast<const uint4*>(rows + r * kWords);
    const uint4 q0 = __ldg(p), q1 = __ldg(p + 1), q2 = __ldg(p + 2),
                q3 = __ldg(p + 3), q4 = __ldg(p + 4);
    const bool nonce_ok = q0.x == q0.z && q0.y == q0.w;
    const uint32_t bal[8] = {q1.x, q1.y, q1.z, q1.w, q2.x, q2.y, q2.z, q2.w};
    const uint32_t up[8] = {q3.x, q3.y, q3.z, q3.w, q4.x, q4.y, q4.z, q4.w};
    bool ge = true;
    bool decided = false;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        if (!decided && bal[j] != up[j]) {
            ge = bal[j] > up[j];
            decided = true;
        }
    }
    ok[r] = (nonce_ok && ge) ? 1 : 0;
}

}  // namespace

// K6: ok[r] = 1 where row r of `rows` (u32[n, 20], 16-byte aligned) is
// valid, else 0. Returns the launch's cudaError_t.
extern "C" int khipu_exec_validate(const void* rows, long long n, void* ok,
                                   int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n <= 0) return 0;
    const long long grid = (n + kThreads - 1) / kThreads;
    exec_validate_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)rows, n, (uint8_t*)ok);
    return (int)cudaGetLastError();
}
